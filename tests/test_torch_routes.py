"""The reference's shade routing on the port's kernel branch.

Where the reference's static gate (render/shade_kernel.py::
pallas_shade_supported) refuses the fused shade kernel, its frame shades
through its XLA path; the port's pass shades through its tensor path over
the same worklist (render/shading.py::_kernel_path_taps). Two such frames
at 128x72 with 8x128 tiles, through both packages on the CPU (the
reference on its Pallas branch in interpret mode, the port on its kernel
branch through the plain versions):

- ``debug_clusters`` on the small dragon (both passes refused by the gate;
  the opaque pass's cluster false colour);
- the test scene under 12 point lights with 128 list slots (S = 12 > 8
  with <= 16 lights: refused).

Tolerances as tests/test_torch_frame.py's: linear LDR RMSE < 1e-3, and
every FrameDiagnostics field equal. The port's launch counts show the
route: kernel 1 per pass, kernels 2-4 never.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from golden_defs import CFG_PAL, _rig
from transmission_renderer_tpu.models.procedural import build_dragon_scene as jdragon
from transmission_renderer_tpu.models.procedural import build_test_scene as jtest_scene
from transmission_renderer_tpu.pbr.lights import pack_lights as jpack
from transmission_renderer_tpu.pbr.lights import point_light as jpoint
from transmission_renderer_tpu.render import make_frame_params as jparams
from transmission_renderer_tpu.render import render_frame as jrender
from transmission_renderer_tpu.render.shade_kernel import pallas_shade_supported
from transmission_renderer_tpu_torch import bridge
from transmission_renderer_tpu_torch.ops import raster_gbuf, tap_finish
from transmission_renderer_tpu_torch.render import frame as pframe
from transmission_renderer_tpu_torch.render import shade_kernel

torch.set_num_threads(1)

CFG = dataclasses.replace(CFG_PAL, sparse_raster_tile_floor=1,
                          transmission_tile_cap_frac=0.85)
CAM = ((0.0, 2.2, 1.5), -0.25)
MAX_RMSE = 1e-3


def _twelve_lights():
    rng = np.random.default_rng(12)
    return [jpoint([float(x), 0.8, float(z)], [float(c) for c in rng.uniform(0.2, 1.0, 3)],
                   float(i))
            for x, z, i in zip(rng.uniform(-3, 3, 12), rng.uniform(-3, 1, 12),
                               rng.uniform(2, 8, 12))]


CASES = {
    "debug_clusters": (lambda: jdragon(stacks=40, sectors=80, roughness_override=0.25),
                       dataclasses.replace(CFG, debug_clusters=True),
                       lambda: [jpoint([0.0, 0.8, 0.0], [1, 0, 0], 5.0)]),
    "twelve_lights": (jtest_scene, CFG, _twelve_lights),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def frame_pair(request):
    build, cfg, light_list = CASES[request.param]
    scene, dl, flags = build().finish_bundle()
    rig = _rig(*CAM)
    params = jparams(cfg, rig.camera.view_matrix(), rig.camera.position, rig.sun_dir())
    lights = jpack(light_list())
    ref_img, ref_diag = jax.jit(lambda s, d, p, lt: jrender(
        s, d, p, lt, config=cfg, flags=flags, return_diagnostics=True))(
        scene, dl, params, lights)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    pin = bridge.from_jax_arrays(as_np(scene), as_np(dl), as_np(params), as_np(lights),
                                 flags, device="cpu")
    handles = (raster_gbuf.KERNEL, tap_finish.TAP_KERNEL, shade_kernel.KERNEL,
               tap_finish.FETCH_KERNEL)
    calls = {}
    for h in handles:
        h.recorder = []
    try:
        img, diag = pframe.render_frame(*pin[:4], cfg, flags=pin[4], return_diagnostics=True)
    finally:
        for h in handles:
            calls[h.name] = len(h.recorder)
            h.recorder = None
    return dict(name=request.param, ref=np.asarray(ref_img), ref_diag=as_np(ref_diag),
                img=img.numpy(), diag=diag, calls=calls, flags=flags, lights=lights, cfg=cfg)


def test_reference_gate_refuses_the_kernel(frame_pair):
    """The reference's own gate refuses its fused shade for both frames,
    and the port's frame called no kernel of the shade (taps, shade,
    fetch) and kernel 1 once per pass."""
    f = frame_pair
    ctx = type("Ctx", (), dict(
        debug_clusters=f["cfg"].debug_clusters, quad_taps=False, bf16_lights=False,
        lights=f["lights"],
        cluster_light_indices=np.zeros((1, f["cfg"].max_lights_per_cluster))))()
    assert not pallas_shade_supported(ctx, 4, f["cfg"].width)
    passes = 2 if f["flags"].has_transmission else 1
    assert f["calls"] == {"raster_gbuf": passes, "tap_finish": 0, "shade": 0,
                          "transmission_fetch": 0}, f["calls"]


def test_routed_frame_matches_reference(frame_pair):
    f = frame_pair
    ref, got = f["ref"], f["img"]
    assert got.shape == ref.shape == (72, 128, 3)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    rmse = float(np.sqrt(np.mean((got - ref) ** 2)))
    assert rmse < MAX_RMSE, (f["name"], rmse)
    if f["name"] == "debug_clusters":
        # the false colour: each valid pixel is one of the 15 colours
        # nudged by its cluster's (a step of at most 0.0125)
        assert np.unique(got.reshape(-1, 3).round(2), axis=0).shape[0] > 2


def test_routed_frame_diagnostics_match_reference(frame_pair):
    ref, got = frame_pair["ref_diag"], frame_pair["diag"]
    for name in ref._fields:
        r, g = getattr(ref, name), getattr(got, name)
        if isinstance(r, tuple):
            assert tuple(int(x) for x in g) == tuple(int(x) for x in r), name
        else:
            assert int(g) == int(r), name
