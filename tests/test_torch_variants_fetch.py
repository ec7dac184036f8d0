"""The pieces of the frame variants, one by one, against the JAX package.

- ``ops/mipchain.py::sample_pyramid_lod(level_set=None)``: the tent
  weights over the whole pyramid against the reference's lerp of the two
  levels bracketing each lod (mipchain.py:677-683), at even and odd level
  sizes, with lods below 0 and past the top and uvs outside [0, 1]: within
  3e-5 of the reference jitted (its compiler contracts the bilinear's
  multiply-adds: ~3 ulp at these values; the combine's own rounding is
  ~2.4e-7).
- Kernel 4's full form's plain version (``transmission_fetch_planes_plain``
  with no level set, the set form over every level): the pyramid half as
  above, the LUT half equal to the reference's ``sample_lut_2ch_quad`` (its
  kernel path's fallback).
- The half-res refraction's upsample against the reference's own
  ``jax.image.resize(..., "linear")``, jitted, at even and odd sizes:
  within 1e-6.
- The bf16 light math's cores (``material_invariants``, ``basic_brdf``,
  ``transmission_btdf`` in bfloat16, results to float32) bit-equal to the
  reference's jitted ones.
- The quad taps' representative pixel: each 2x2 quad's first valid pixel.
- The kernel branch's fused-path gate (the reference's frame.py:1368-1373).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmission_renderer_tpu.ops import mipchain as jmip
from transmission_renderer_tpu.ops.texture import quad_lut_2ch, sample_lut_2ch_quad
from transmission_renderer_tpu.pbr import brdf as jbrdf
from transmission_renderer_tpu_torch.ops import mipchain
from transmission_renderer_tpu_torch.ops.tap_finish import transmission_fetch_planes_plain
from transmission_renderer_tpu_torch.config import RenderConfig
from transmission_renderer_tpu_torch.pbr import brdf
from transmission_renderer_tpu_torch.render.frame import SceneFlags, _fused_transmission
from transmission_renderer_tpu_torch.render.shading import _quad_representative, upsample_linear
from transmission_renderer_tpu_torch.utils.ggx_lut import default_ggx_lut

torch.set_num_threads(1)

SIZES = [(72, 128), (37, 91), (9, 200)]


def _images(h, w, seed=1):
    img = np.random.default_rng(seed).uniform(0, 4, (3, h, w)).astype(np.float32)
    pp = mipchain.build_pyramid(tuple(torch.from_numpy(img[c]) for c in range(3)),
                                level_set=None)
    return img, pp


def _taps(m, top, seed=2):
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-0.2, 1.2, (m, 2)).astype(np.float32)
    lod = rng.uniform(-2.0, top + 3.0, m).astype(np.float32)
    lod[: top + 1] = np.arange(top + 1)  # exactly on every level, the top included
    return uv, lod


@pytest.mark.parametrize("h,w", SIZES)
def test_full_pyramid_sample_matches_reference(h, w):
    """Against the reference jitted (its pyramid built in the same jit)."""
    img, pp = _images(h, w)
    assert all(lv is not None for lv in pp.levels)
    uv, lod = _taps(4096, pp.num_levels - 1)
    got = mipchain.sample_pyramid_lod(pp, torch.from_numpy(uv), torch.from_numpy(lod),
                                      None).numpy()
    jitted = np.asarray(jax.jit(lambda i, u, l: jmip.sample_pyramid_lod(
        jmip.build_pyramid(tuple(i), level_set=None), u, l, None))(img, uv, lod))
    np.testing.assert_allclose(got, jitted, rtol=0, atol=3e-5)


@pytest.mark.parametrize("h,w", SIZES[:2])
def test_full_form_fetch_plain_matches_reference(h, w):
    """Kernel 4's full form, plain: the whole pyramid's taps and the LUT
    tap against the reference's kernel-path fallback, jitted."""
    img, pp = _images(h, w, seed=3)
    uv, lod = _taps(2048, pp.num_levels - 1, seed=4)
    rng = np.random.default_rng(5)
    nov = rng.uniform(-0.1, 1.1, 2048).astype(np.float32)
    rough = rng.uniform(0.0, 1.0, 2048).astype(np.float32)
    lut = default_ggx_lut(32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = transmission_fetch_planes_plain(pp, None, t(uv[:, 0]), t(uv[:, 1]), t(lod), t(nov),
                                          t(rough), t(lut))

    def ref(i, u, l, nov, rough, lut):
        pyr = jmip.build_pyramid(tuple(i), level_set=None)
        return (jmip.sample_pyramid_lod(pyr, u, l, None),
                sample_lut_2ch_quad(quad_lut_2ch(lut), 32, nov, rough))

    ref_t, ref_b = jax.jit(ref)(img, uv, lod, nov, rough, lut)
    np.testing.assert_allclose(np.stack([g.numpy() for g in got[:3]], -1), np.asarray(ref_t),
                               rtol=0, atol=3e-5)
    np.testing.assert_allclose(np.stack([g.numpy() for g in got[3:]], -1), np.asarray(ref_b),
                               rtol=0, atol=1e-6)


def test_full_form_fits_the_kernel_level_guard():
    """Kernel 4 takes at most 16 contiguous levels: the whole pyramid up
    to 32768 px wide (1080p has 11)."""
    assert len(mipchain.pyramid_shapes(1920, 1080)) == 11
    assert len(mipchain.pyramid_shapes(32768, 16)) == 16


@pytest.mark.parametrize("h,w", [(72, 128), (71, 129), (9, 200), (899, 1599)])
def test_half_res_upsample_matches_jax_resize(h, w):
    """The half grid is ceil(n/2): the scale is exactly 2 only at even
    sizes; at odd ones the reference's jitted weights round its sample
    positions with one fused multiply-subtract, which the port mirrors."""
    h2, w2 = (h + 1) // 2, (w + 1) // 2
    c = np.random.default_rng(6).uniform(0, 3, (h2, w2, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda c: jax.image.resize(c, (h, w, 3), "linear"))(c))
    got = upsample_linear(torch.from_numpy(c), h, w).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_bf16_cores_match_reference():
    """The light loop's bf16 cores, as _evaluate_lights_common runs them:
    inputs cast once, results to float32 -> bit-equal to the reference's
    jitted cores (so the frames' bf16 differences come from elsewhere)."""
    rng = np.random.default_rng(0)
    m = 4096

    def unit(v):
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)

    n = unit(rng.normal(size=(m, 3)))
    v = unit(n + 0.8 * rng.normal(size=(m, 3)))
    li = unit(n + 0.8 * rng.normal(size=(m, 3)))
    inten = rng.uniform(0, 5, (m, 3)).astype(np.float32)
    mat = [rng.uniform(0.05, 1, (m, 3)), rng.uniform(0, 1, m), rng.uniform(0.05, 1, m),
           rng.uniform(1.0, 1.8, m), rng.uniform(0, 1, (m, 3)), rng.uniform(0, 1, m)]
    mat = [a.astype(np.float32) for a in mat]

    def ref(n, li, inten, v, *mat):
        c = lambda x: x.astype(jnp.bfloat16)  # noqa: E731
        mc = jbrdf.MaterialParams(*(c(x) for x in mat))
        inv = jbrdf.material_invariants(mc)
        r = jbrdf.basic_brdf(c(n), c(li), c(inten), c(v), mc, inv=inv)
        t = jbrdf.transmission_btdf(mc, c(n), c(v), c(li), inv=inv)
        return (r.diffuse.astype(jnp.float32), r.specular.astype(jnp.float32),
                t.astype(jnp.float32))

    want = [np.asarray(x) for x in jax.jit(ref)(n, li, inten, v, *mat)]
    c = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    mc = brdf.MaterialParams(*(c(x) for x in mat))
    inv = brdf.material_invariants(mc)
    r = brdf.basic_brdf(c(n), c(li), c(inten), c(v), mc, inv=inv)
    t = brdf.transmission_btdf(mc, c(n), c(v), c(li), inv=inv)
    for got, w in zip((r.diffuse, r.specular, t), want):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), w)


def test_quad_representative_is_first_valid_pixel():
    h, w = 6, 8
    rng = np.random.default_rng(7)
    valid = rng.uniform(size=(h, w)) < 0.4
    x = rng.normal(size=(h * w, 2)).astype(np.float32)
    got = _quad_representative(torch.from_numpy(valid.reshape(-1)), h, w)(
        torch.from_numpy(x)).numpy()
    xs = x.reshape(h, w, 2)
    for qy in range(h // 2):
        for qx in range(w // 2):
            order = [(2 * qy, 2 * qx), (2 * qy, 2 * qx + 1), (2 * qy + 1, 2 * qx),
                     (2 * qy + 1, 2 * qx + 1)]
            pick = next((p for p in order if valid[p]), order[0])
            np.testing.assert_array_equal(got[qy * (w // 2) + qx], xs[pick])


def test_fused_path_gate():
    """The fused sparse transmission path needs a sparse tile cap, no
    alpha clip, no half-res refraction and a width that is a multiple of
    128; everything else takes the non-fused raster and shade."""
    flags = SceneFlags(has_alpha_clip=False, has_transmission=True)
    base = RenderConfig(width=1920, height=1080)
    assert _fused_transmission(base, flags)
    for cfg, fl in ((RenderConfig(width=1600, height=900), flags),
                    (RenderConfig(half_res_refraction=True), flags),
                    (RenderConfig(transmission_tile_cap_frac=None), flags),
                    (base, flags._replace(has_alpha_clip=True))):
        assert not _fused_transmission(cfg, fl)
