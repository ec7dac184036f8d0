"""Cluster-AABB wireframe overlay, the cluster debug pipeline.

Counterpart of ``transmission_renderer_tpu/render/cluster_debug.py``
(``cluster_wireframe_overlay``), the reference renderer's
``cluster_debugging_vs/fs`` line-list draw over every cluster's
view-space AABB (shader/src/lib.rs:801-839). There is no line
rasteriser: each of an AABB's 12 edges is sampled at ``samples`` points,
projected with the reversed-Z perspective and point-scattered over the
tonemapped image; points off the frame or behind the camera land on a
discard row that is dropped.
"""

from __future__ import annotations

import torch

# corner index bit k selects max (1) or min (0) along axis k
_EDGES = (
    (0, 1), (2, 3), (4, 5), (6, 7),  # x-aligned
    (0, 2), (1, 3), (4, 6), (5, 7),  # y-aligned
    (0, 4), (1, 5), (2, 6), (3, 7),  # z-aligned
)


def cluster_wireframe_overlay(
    image: torch.Tensor,  # [H, W, 3] (LDR expected)
    aabb_min: torch.Tensor,  # [C, 3] view-space cluster AABBs
    aabb_max: torch.Tensor,  # [C, 3]
    perspective: torch.Tensor,  # [4, 4] reversed-Z projection
    colour=(0.1, 1.0, 0.2),
    samples: int = 16,
) -> torch.Tensor:
    """Scatter the 12 edges of every cluster AABB over ``image``."""
    h, w = image.shape[:2]
    dev = image.device
    sel = torch.tensor([[(i >> k) & 1 for k in range(3)] for i in range(8)],
                       dtype=torch.float32, device=dev)  # [8, 3]
    corners = aabb_min[:, None, :] + sel[None] * (aabb_max[:, None, :] - aabb_min[:, None, :])
    ends = torch.tensor(_EDGES, dtype=torch.int64, device=dev)
    a = corners[:, ends[:, 0]]  # [C, 12, 3]
    b = corners[:, ends[:, 1]]
    # jnp.linspace's float32 points: i * float32(1 / (samples - 1))
    t = torch.arange(samples, dtype=torch.float32, device=dev) * (1.0 / (samples - 1))
    pts = (a[..., None, :] + (b - a)[..., None, :] * t[:, None]).reshape(-1, 3)
    pts_h = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=-1)
    clip = pts_h @ perspective.T
    behind = clip[:, 3] <= 1e-6
    ndc = clip[:, :3] / torch.where(behind, 1.0, clip[:, 3])[:, None]
    px = ((ndc[:, 0] * 0.5 + 0.5) * w).to(torch.int32)
    py = ((ndc[:, 1] * 0.5 + 0.5) * h).to(torch.int32)
    ok = ~behind & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    flat_idx = torch.where(ok, py * w + px, h * w).long()
    out = torch.cat([image.reshape(-1, 3), image.new_zeros((1, 3))])
    out[flat_idx] = torch.tensor(colour, dtype=image.dtype, device=dev)
    return out[: h * w].reshape(h, w, 3)
