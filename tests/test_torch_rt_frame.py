"""The port's ray-traced-shadow frame vs the JAX package's render_frame.

The small dragon (stacks=40, sectors=80) at 128x72 under one point light
renders with ``ray_traced_shadows=True`` and a BVH through both packages
on the CPU: the reference on its G-buffer-kernel branch in interpret mode
(tests/golden_defs.py CFG_PAL, the transmission tile floor lowered so its
fused sparse path runs at this size, as tests/test_torch_frame.py does),
the port on its kernels' plain versions (kernel 5 is the plain bitstack
walk) from the reference's own arrays carried over by the bridge. Both
frames' shadow_factors calls are captured.

Stated tolerances: each pass's shadow factors equal on >= 99.99% of the
rays (the walks round alike, but the ray directions come from a
normalisation the reference's compiler may fuse differently); the linear
image RMSE <= 1e-4; the integer diagnostics equal; and the same for the
half-res shadow-ray frame.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from golden_defs import CFG_PAL, _lights, _rig
from transmission_renderer_tpu.models.procedural import build_dragon_scene as jdragon
from transmission_renderer_tpu.render import make_frame_params as jparams
from transmission_renderer_tpu.render import raytrace as jraytrace
from transmission_renderer_tpu.render import render_frame as jrender
from transmission_renderer_tpu_torch import bridge
from transmission_renderer_tpu_torch.models.procedural import build_dragon_scene
from transmission_renderer_tpu_torch.render import frame as pframe

# torch runs single-threaded here: the suite runs in several worker
# processes at once, and oversubscribed OpenMP threads stall each other
torch.set_num_threads(1)

CFG = dataclasses.replace(CFG_PAL, sparse_raster_tile_floor=1,
                          transmission_tile_cap_frac=0.85, ray_traced_shadows=True)
CAM = ((0.0, 2.2, 1.5), -0.25)
MIN_EQUAL_FRAC = 0.9999
MAX_RMSE = 1e-4


def _capture(module, monkeypatch):
    """Record every shadow_factors result that ``module`` computes."""
    calls = []
    real = module.shadow_factors

    def recorded(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(out)
        return out

    monkeypatch.setattr(module, "shadow_factors", recorded)
    return calls


@pytest.fixture(scope="module")
def frames():
    builder = jdragon(stacks=40, sectors=80, roughness_override=0.25)
    scene, dl, flags = builder.finish_bundle()
    jbvh = builder.build_rt_bvh()
    rig = _rig(*CAM)
    params = jparams(CFG, rig.camera.view_matrix(), rig.camera.position, rig.sun_dir())
    lights = _lights()
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    pinputs = bridge.from_jax_arrays(as_np(scene), as_np(dl), as_np(params),
                                     as_np(lights), flags, device="cpu")
    pbvh = build_dragon_scene(stacks=40, sectors=80, roughness_override=0.25
                              ).build_rt_bvh(device="cpu")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        jcalls = _capture(jraytrace, mp)
        pcalls = _capture(pframe, mp)
        for half in (False, True):
            cfg = dataclasses.replace(CFG, half_res_shadow_rays=half)

            def run(scene, dl, params, lights, bvh, cfg=cfg):
                jcalls.clear()
                img, diag = jrender(scene, dl, params, lights, config=cfg, flags=flags,
                                    bvh=bvh, return_diagnostics=True)
                return img, diag, list(jcalls)

            ref_img, ref_diag, ref_f = jax.jit(run)(scene, dl, params, lights, jbvh)
            pcalls.clear()
            img, diag = pframe.render_frame(*pinputs[:4], cfg, flags=pinputs[4], bvh=pbvh,
                                            return_diagnostics=True)
            out[half] = dict(
                ref=np.asarray(ref_img), ref_diag=as_np(ref_diag),
                ref_factors=[as_np(f) for f in ref_f], img=img.numpy(), diag=diag,
                factors=[tuple(t.numpy() for t in f) for f in pcalls])
    return out


@pytest.mark.parametrize("half", [False, True], ids=["full_res", "half_res"])
def test_rt_shadow_factors_match_reference(frames, half):
    f = frames[half]
    # opaque pass, then the transmission pass
    assert len(f["factors"]) == len(f["ref_factors"]) == 2
    for got, ref in zip(f["factors"], f["ref_factors"]):
        for g, r in zip(got, ref):
            assert g.shape == r.shape
            equal = float((g == r).mean())
            print(f"shadow factors equal on {equal:.6f} of {g.size} rays")
            assert equal >= MIN_EQUAL_FRAC
    # shadows exist: some sun rays of the opaque pass are blocked
    assert (f["factors"][0][0] < 1.0).any()


@pytest.mark.parametrize("half", [False, True], ids=["full_res", "half_res"])
def test_rt_frame_matches_reference(frames, half):
    f = frames[half]
    ref, got = f["ref"], f["img"]
    assert got.shape == ref.shape == (72, 128, 3)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    rmse = float(np.sqrt(np.mean((got - ref) ** 2)))
    print(f"linear LDR RMSE {rmse:.3g}, max abs {np.abs(got - ref).max():.3g}")
    assert rmse <= MAX_RMSE


@pytest.mark.parametrize("half", [False, True], ids=["full_res", "half_res"])
def test_rt_frame_diagnostics_match_reference(frames, half):
    ref, got = frames[half]["ref_diag"], frames[half]["diag"]
    assert not got.overflowed()
    for name in ref._fields:
        r, g = getattr(ref, name), getattr(got, name)
        if isinstance(r, tuple):
            assert tuple(int(x) for x in g) == tuple(int(x) for x in r), name
        else:
            assert int(g) == int(r), name


def test_half_res_shadows_close_to_full_res(frames):
    """tests/test_rt_shadows.py's bound on the port: the half-res factors
    differ from the full-res ones only along shadow edges."""
    full, half = frames[False]["img"], frames[True]["img"]
    rmse = float(np.sqrt(np.mean((full - half) ** 2)))
    print(f"half-res vs full-res RMSE {rmse:.3g}")
    assert 0.0 < rmse < 0.03
