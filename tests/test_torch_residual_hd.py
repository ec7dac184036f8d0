"""Where the port's 1080p frame leaves the reference's: the stress scene's
visibility-buffer frame (tests/goldens/stress_hd.png's config, camera and
lights) through both packages on the CPU, from the same arrays.

The 1080p comparisons on the card (tests/test_torch_card_hd.py) hold the
port's float frames to 8-bit goldens, and read about 1.4e-3 sRGB RMSE
where the same frames at 128x72 agree with the reference's float frames
to ~3e-6. The one ``slow``
test here says where that gap lives (``python -m pytest
tests/test_torch_residual_hd.py -m slow -s``; ~6 min, a few GB). It
prints, and holds:

- per raster pass, the pixels whose triangle differs between the
  packages (the reference's passes replayed with its own alpha test,
  tests/test_torch_vis_clip.py::reference_passes): few, and each on a
  triangle edge: for one of the two candidates an edge function at the
  pixel centre is within EDGE_REL of its terms' magnitude from zero, and
  the port's coverage there is the float64 evaluation's (its sign);
- the linear error between the float frames over the frame, over those
  pixels' complement, over the pixels whose front surface is glass (the
  transmissive pass won), opaque and background, and the 8x128 tiles
  with the largest RMSE;
- the sRGB RMSE of each package's float frame against stress_hd.png,
  over the frame and without those pixels, where the two agree.

Measured by this test on a CPU: 15 of 2,073,600 pixels move
(7 opaque-pass, 8 transmissive-pass), each within 3e-8 to 5.5e-6 of an
edge and covered as the float64 evaluation covers it; they carry the
frames' linear RMSE of 1.0e-3 (three 8x128 tiles), and without them the
port reads 0.9150866e-3 sRGB RMSE against the golden and the reference
0.9150552e-3 (1.387e-3 and 0.915e-3 with them).
"""

import os
from functools import partial

import jax
import numpy as np
import pytest
import torch

from golden_defs import GOLDEN_DIR
from test_torch_vis_clip import PASSES, reference_passes
from transmission_renderer_tpu.config import RenderConfig as JConfig
from transmission_renderer_tpu.models.procedural import build_stress_scene as jstress
from transmission_renderer_tpu.pbr.lights import pack_lights as jpack
from transmission_renderer_tpu.pbr.lights import point_light as jpoint
from transmission_renderer_tpu.render import frame as jframe
from transmission_renderer_tpu.scene.camera import CameraRig as JRig
from transmission_renderer_tpu_torch import bridge
from transmission_renderer_tpu_torch.config import RenderConfig
from transmission_renderer_tpu_torch.ops import raster_vis
from transmission_renderer_tpu_torch.ops.cull import (
    bucket_triangle_masks,
    cull_instances,
    transform_vertices,
)
from transmission_renderer_tpu_torch.ops.raster import setup_triangles, untile_image
from transmission_renderer_tpu_torch.render.frame import render_frame
from transmission_renderer_tpu_torch.scene.textures import linear_to_srgb
from transmission_renderer_tpu_torch.utils.png import read_png

torch.set_num_threads(4)

CFG = dict(width=1920, height=1080, opaque_block_cap_frac=0.8125)
# at most this many pixels change triangle, each on an edge: a candidate's
# edge function within EDGE_REL of |a nx| + |b ny| + |c| from zero
MAX_MOVED = 32
EDGE_REL = 1e-5
# without those pixels the opaque surfaces agree to the linear RMSE the
# 128x72 frames are held to (tests/variants_defs.py), and the port's frame
# meets the golden as the reference's own does, within a thousandth (the
# glass refracts the opaque pyramid, so the moved pixels reach it)
MAX_LINEAR_RMSE = 1e-5
SAME_GOLDEN = 1e-3


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _rmse(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def _edge_decision(adj: np.ndarray, x: int, y: int, w: int, h: int) -> tuple:
    """(smallest |e| / scale over the three edges, whether the port's
    float32 edge functions at pixel (x, y) cover it as their float64
    evaluation does) for a triangle's [3, 3] adjugate rows."""
    f32 = np.float32
    nx = f32(f32(f32(x) + f32(0.5)) * f32(2.0 / w) - f32(1.0))
    ny = f32(f32(f32(y) + f32(0.5)) * f32(2.0 / h) - f32(1.0))
    e = raster_vis._edges(lambda i: torch.tensor([adj.reshape(9)[i]]),
                          torch.tensor([nx]), torch.tensor([ny]))
    e32 = np.array([float(v[0]) for v in e])
    a64 = adj.astype(np.float64)
    e64 = a64[:, 0] * np.float64(nx) + a64[:, 1] * np.float64(ny) + a64[:, 2]
    scale = np.abs(a64[:, 0] * nx) + np.abs(a64[:, 1] * ny) + np.abs(a64[:, 2])
    return float(np.min(np.abs(e64) / scale)), bool(np.all((e32 > 0) == (e64 > 0)))


@pytest.mark.slow
def test_stress_hd_residual_is_edge_rounding():
    jcfg = JConfig(**CFG)
    cfg = RenderConfig(**CFG, use_pallas_raster=False)
    scene, dl, flags = jstress().finish_bundle()
    rig = JRig()
    rig.camera.position = np.array([0.0, 2.2, 1.5], np.float32)
    rig.camera.pitch = -0.25
    params = jframe.make_frame_params(jcfg, rig.camera.view_matrix(), rig.camera.position,
                                      rig.sun_dir())
    lights = jpack([jpoint([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0),
                    jpoint([8.0, 0.8, 0.0], [0.0, 1.0, 0.0], 10.0)])
    ref = np.asarray(jax.jit(partial(jframe.render_frame, config=jcfg, flags=flags))(
        scene, dl, params, lights))
    ref_vis = reference_passes(scene, dl, params, jcfg)
    inputs = bridge.from_jax_arrays(_np(scene), _np(dl), _np(params), _np(lights), flags,
                                    device="cpu")
    raster_vis.KERNEL.recorder = []
    try:
        got = render_frame(*inputs[:4], cfg, flags=inputs[4]).numpy()
    finally:
        calls, raster_vis.KERNEL.recorder = raster_vis.KERNEL.recorder, None
    assert len(calls) == 2
    p_scene, p_dl, p_params = inputs[:3]
    clip = transform_vertices(p_scene, p_dl, p_params.proj_view)[3]
    visible = cull_instances(p_scene, p_params.view, p_params.frustum_x_xz,
                             p_params.frustum_y_yz, cfg.z_near)

    def untile(t):
        return untile_image(t, cfg.tiles_x, cfg.tiles_y, cfg.tile_w, cfg.tile_h, cfg.width,
                            cfg.height).numpy()

    moved = np.zeros(got.shape[:2], bool)
    for p, (call, vis, buckets) in enumerate(zip(calls, ref_vis, PASSES)):
        tri = untile(raster_vis.KERNEL.replay(call, False)[0])
        ref_tri = np.asarray(vis.tri_id)
        adj = setup_triangles(clip, p_dl.tri_vtx,
                              bucket_triangle_masks(p_dl.tri_inst, p_dl.tri_bucket, visible,
                                                    buckets),
                              cfg.width, cfg.height, cfg.tile_w, cfg.tile_h).adj.numpy()
        ys, xs = np.nonzero(tri != ref_tri)
        moved[ys, xs] = True
        print(f"\npass {p}: {len(ys)} pixels hold another triangle than the reference's")
        for y, x in zip(ys, xs):
            cands = sorted({int(tri[y, x]), int(ref_tri[y, x])} - {-1})
            decisions = [_edge_decision(adj[t], x, y, cfg.width, cfg.height) for t in cands]
            print(f"  ({y}, {x}) port {tri[y, x]}, reference {ref_tri[y, x]}: nearest edge "
                  f"(|e| / scale) {[f'{d[0]:.2e}' for d in decisions]}, port's coverage "
                  f"the float64 one's {[d[1] for d in decisions]}")
            assert min(d[0] for d in decisions) < EDGE_REL
            assert all(d[1] for d in decisions)
    glass = np.asarray(ref_vis[1].tri_id) >= 0
    opaque = ~glass & (np.asarray(ref_vis[0].tri_id) >= 0)
    diff = got - ref
    for name, m in [("frame", np.ones_like(moved)), ("frame without them", ~moved),
                    ("glass", glass & ~moved), ("opaque", opaque & ~moved),
                    ("background", ~glass & ~opaque & ~moved)]:
        print(f"linear error over {name} ({int(m.sum())} px): RMSE {_rmse(diff[m]):.3e}, "
              f"max {float(np.abs(diff[m]).max()):.3e}")
    tiles = np.sqrt(np.mean(np.square(diff, dtype=np.float64).reshape(
        cfg.tiles_y, 8, cfg.tiles_x, 128, 3), axis=(1, 3, 4)))
    worst = np.argsort(tiles.ravel())[::-1][:5]
    print("worst 8x128 tiles (id: linear RMSE): "
          + ", ".join(f"{int(t)}: {tiles.ravel()[t]:.3e}" for t in worst))
    golden = read_png(os.path.join(GOLDEN_DIR, "stress_hd.png"))[..., :3] / 255.0
    g_port, g_ref = linear_to_srgb(got) - golden, linear_to_srgb(ref) - golden
    print(f"sRGB RMSE against stress_hd.png: port {_rmse(g_port):.6e}, reference "
          f"{_rmse(g_ref):.6e}; without the moved pixels port {_rmse(g_port[~moved]):.6e}, "
          f"reference {_rmse(g_ref[~moved]):.6e}")
    assert moved.sum() <= MAX_MOVED
    assert _rmse(diff[opaque & ~moved]) < MAX_LINEAR_RMSE
    assert abs(_rmse(g_port[~moved]) - _rmse(g_ref[~moved])) <= SAME_GOLDEN * _rmse(g_ref[~moved])
