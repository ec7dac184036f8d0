"""The split-sum GGX LUT lookup: ``TRTPU_GGX_LUT`` in both packages.

A seeded 64x64 RGBA PNG stands in for the reference's ggx_lut.png. With
the variable naming it (and both packages' ``default_ggx_lut`` caches
and the port's per-device LUT cache in render_frame cleared):

- the port's ``default_ggx_lut`` equals the reference's bit for bit at
  the native size, at the frame's default size (no reduction) and at a
  reducing size, and ``load_ggx_lut_png`` equals the reference's;
- a file that does not decode falls through to the bake, as the
  reference's does;
- the 128x72 dragon frame (tests/golden_defs.py::CFG, the
  visibility-buffer branch, the reference's arrays through the bridge)
  renders with it within tests/test_torch_frame.py's tolerance of the
  reference's frame (linear RMSE < 1e-3, max abs < 2e-2), and differs
  from the port's frame with the baked LUT.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from golden_defs import CFG, _dragon, _lights, _rig
from transmission_renderer_tpu.render import frame as jframe
from transmission_renderer_tpu.utils import ggx_lut as jlut
from transmission_renderer_tpu_torch import bridge
from transmission_renderer_tpu_torch.render import frame as pframe
from transmission_renderer_tpu_torch.utils import ggx_lut as plut

torch.set_num_threads(1)

CAM = ((0.0, 2.2, 1.5), -0.25)


def _clear_caches():
    jlut.default_ggx_lut.cache_clear()
    plut.default_ggx_lut.cache_clear()
    pframe._default_lut.cache_clear()


@pytest.fixture
def lut_png(tmp_path, monkeypatch):
    """The path of a seeded 64x64 RGBA PNG, named by TRTPU_GGX_LUT."""
    rgba = np.random.default_rng(17).integers(0, 256, (64, 64, 4), dtype=np.uint8)
    path = tmp_path / "ggx_lut.png"
    Image.fromarray(rgba).save(path)
    monkeypatch.setenv("TRTPU_GGX_LUT", str(path))
    _clear_caches()
    yield str(path)
    _clear_caches()  # before the variable goes: no cache keeps this table


@pytest.mark.parametrize("size", [None, 256, 16])
def test_default_lut_equals_reference(lut_png, size):
    got, want = plut.default_ggx_lut(size), jlut.default_ggx_lut(size)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == ((64, 64, 2) if size in (None, 256) else (16, 16, 2))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(plut.load_ggx_lut_png(lut_png),
                                  jlut.load_ggx_lut_png(lut_png))


def test_unreadable_lut_falls_through_to_the_bake(tmp_path, monkeypatch):
    bad = tmp_path / "ggx_lut.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\nnot a png")
    monkeypatch.setenv("TRTPU_GGX_LUT", str(bad))
    _clear_caches()
    try:
        got, want = plut.default_ggx_lut(32), jlut.default_ggx_lut(32)
    finally:
        _clear_caches()
    np.testing.assert_array_equal(got, want)
    monkeypatch.delenv("TRTPU_GGX_LUT")
    np.testing.assert_array_equal(got, plut.default_ggx_lut(32))
    _clear_caches()


def _inputs():
    """The 128x72 dragon frame's reference arguments (scene, draw list,
    params, lights), flags, and the port's inputs from the same arrays."""
    scene, dl, flags = _dragon().finish_bundle()
    rig = _rig(*CAM)
    params = jframe.make_frame_params(CFG, rig.camera.view_matrix(), rig.camera.position,
                                      rig.sun_dir())
    args = (scene, dl, params, _lights())
    host = partial(jax.tree_util.tree_map, np.asarray)
    return args, flags, bridge.from_jax_arrays(*map(host, args), flags, device="cpu")


def test_frame_follows_the_lut(lut_png, monkeypatch):
    args, flags, inputs = _inputs()
    ref = np.asarray(jax.jit(partial(jframe.render_frame, config=CFG, flags=flags))(*args))
    got = pframe.render_frame(*inputs[:4], CFG, flags=inputs[4]).numpy()
    err = np.abs(got - ref)
    rmse = float(np.sqrt(np.mean(err ** 2)))
    print(f"with TRTPU_GGX_LUT: linear LDR RMSE {rmse:.3g}, max abs {err.max():.3g}")
    assert rmse < 1e-3 and err.max() < 2e-2
    monkeypatch.delenv("TRTPU_GGX_LUT")
    _clear_caches()
    baked = pframe.render_frame(*inputs[:4], CFG, flags=inputs[4]).numpy()
    moved = float(np.abs(baked - got).max())
    print(f"the baked LUT's frame differs from it by up to {moved:.3g}")
    assert moved > 0.05
