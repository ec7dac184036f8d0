"""The comparison that decides ``correct``: frames the window produced
against the plain reference's frames of the same inputs.

The reference replays the viewer's path on its own (the rig's smoothing,
the model's turns) from the configuration and the seed, renders each
checked frame from the scene arrays, and the two images are compared
over every pixel and channel of the tonemapped output. The numbers and
their limits come from the configuration's ``check`` block.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import frame as ref_frame
from benchmark.reference import geometry, occlusion


def reference_frames(arrays, cfg: dict, path, frames: list, device) -> dict:
    """{frame index: reference image [H, W, 3]} for the frames asked,
    replaying the path from frame 0."""
    r = cfg["render"]
    missing = [k for k in ref_frame.FRAME_KEYS if k not in r]
    if missing:
        raise KeyError(f"the configuration's render block lacks {missing}")
    prep = ref_frame.prepare(arrays, r, cfg["lights"], device)
    shadows = occlusion.shadow_fn(arrays, prep.geo.tri_vtx) if path.ray_traced_shadows else None
    cam = cfg["camera"]
    rig = geometry.Rig(np.array(cam["position"], np.float32), cam["yaw"], cam["pitch"],
                       np.array(cam["position"], np.float32), cam["yaw"], cam["pitch"],
                       cam["sun_pitch"], cam["sun_yaw"])
    rotation = prep.geo.rotation.clone()
    delta = torch.from_numpy(geometry.quat_y(path.dt)).to(device)
    out = {}
    for k in range(max(frames) + 1):
        rig.target_yaw = cam["yaw"] + path.target_yaw(k)
        rig.update(path.dt)
        if path.rotate_model and k > 0:
            rotation[-1] = geometry.quat_mul(delta, rotation[-1])
        if k in frames:
            out[k] = ref_frame.render(prep, r, rig, rotation, shadows)
    return out


def compare(image: torch.Tensor, ref: torch.Tensor) -> dict:
    """The numbers compared: root-mean-square and largest absolute
    difference over every pixel and channel, and the share of pixels
    apart by more than 1/255 in some channel."""
    d = (image.to(torch.float64) - ref.to(torch.float64)).abs()
    bad = ~torch.isfinite(image)
    d = torch.where(bad, torch.inf, d)
    return dict(
        rmse=float(torch.sqrt((d * d).mean())),
        max_abs=float(d.max()),
        px_over_1_255=float((d.amax(dim=-1) > 1.0 / 255.0).to(torch.float64).mean()),
    )
