"""Port samplers (the plain versions of kernels 2 and 4) vs the JAX
package's Pallas kernels in interpret mode and its XLA samplers.

Material tap: atol 1e-6 against sample_bundle_planes(interpret=True),
for the single-class REPEAT / CLAMP / non-power-of-two atlases of
tests/test_tap_finish.py and a multi-class bundle pool (the arithmetic
is the same; only a fused multiply-add may round differently).
Transmission fetch: atol 1e-6 against transmission_fetch_planes
(interpret) for the flagship's level set (2, 3) and a wide set, and
against sample_pyramid_lod + sample_lut_2ch_quad for the set (0,),
whose ROW-form level 0 the reference kernel refuses. Pyramid levels:
bit-equal to the reference's box chain."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmission_renderer_tpu.ops import mipchain as jmip
from transmission_renderer_tpu.ops import tap_finish as jtap
from transmission_renderer_tpu.ops import texture as jtex
from transmission_renderer_tpu.scene.textures import AtlasBuilder as JAtlasBuilder
from transmission_renderer_tpu_torch.ops import mipchain, tap_finish, texture
from transmission_renderer_tpu_torch.scene.textures import AtlasBuilder

# torch runs single-threaded here: the suite runs in several worker
# processes at once, and oversubscribed OpenMP threads stall each other
torch.set_num_threads(1)


def _t(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _pools(bundle_layers, sizes, seed=3):
    """The same bundles pushed into both packages' atlas builders."""
    rng = np.random.default_rng(seed)
    ja, pa, tids = JAtlasBuilder(), AtlasBuilder(), []
    for layers, (h, w) in zip(bundle_layers, sizes):
        imgs = [rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
                for _ in range(layers)]
        tids.append(ja.push_bundle(imgs, [False] * layers))
        pa.push_bundle(imgs, [False] * layers)
    jtexels, jmeta, _ = ja.finish()
    ptexels, pmeta, _ = pa.finish()
    return tids, jnp.asarray(jtexels), jnp.asarray(jmeta), ptexels, pmeta


@pytest.mark.parametrize("bundle_layers,sizes,wrap", [
    ([1, 1], [(16, 16), (8, 32)], jtex.WRAP_REPEAT),
    ([1], [(16, 16)], jtex.WRAP_CLAMP),
    ([1, 1], [(13, 21), (7, 5)], jtex.WRAP_REPEAT),
    ([1, 3, 4], [(16, 16), (16, 16), (8, 8)], jtex.WRAP_REPEAT),
])
def test_material_tap_matches_reference(bundle_layers, sizes, wrap):
    tids, jtexels, jmeta, ptexels, pmeta = _pools(bundle_layers, sizes)
    np.testing.assert_array_equal(ptexels.view(torch.int16).numpy(),
                                  np.asarray(jtexels).view(np.int16))
    np.testing.assert_array_equal(pmeta.numpy(), np.asarray(jmeta))
    classes = jtex.atlas_classes(jmeta)
    assert texture.atlas_classes(pmeta) == classes
    m = 512
    rng = np.random.default_rng(11)
    pick = np.asarray([tids[i] for i in rng.integers(0, len(tids), m)], np.int32)
    rows = np.asarray(jmeta)[pick]
    uv = rng.uniform(-0.6, 1.7, (m, 2)).astype(np.float32)
    lod = rng.uniform(-0.5, 9.0, m).astype(np.float32)
    ref = jax.jit(lambda q, r, u, lo: jtap.sample_bundle_planes(
        q, r, u, lo, wrap, classes, interpret=True))(
            jtexels, jnp.asarray(rows), jnp.asarray(uv), jnp.asarray(lod))
    got = tap_finish.sample_bundle_planes(ptexels, _t(rows), _t(uv), _t(lod), wrap,
                                          classes)
    assert len(got) == len(ref) == 4 * max(classes)
    for k, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6, rtol=0,
                                   err_msg=f"plane {k}")
    # and the port's XLA-sampler oracle equals the reference's
    ref_rows = jtex.sample_bundle_rows(jtexels, jnp.asarray(rows), jnp.asarray(uv),
                                       jnp.asarray(lod), wrap, classes=classes)
    got_rows = texture.sample_bundle_rows(ptexels, _t(rows), _t(uv), _t(lod), wrap,
                                          classes)
    np.testing.assert_allclose(got_rows.numpy(), np.asarray(ref_rows), atol=1e-6)


def _fetch_inputs(seed, h=96, w=160, m=640):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 4.0, (3, h, w)).astype(np.float32)
    lut = rng.uniform(0.0, 1.0, (32, 32, 2)).astype(np.float32)
    uv = rng.uniform(-0.1, 1.1, (m, 2)).astype(np.float32)
    lod = rng.uniform(0.0, 6.5, m).astype(np.float32)
    nov = rng.uniform(-0.1, 1.05, m).astype(np.float32)
    rough = rng.uniform(0.0, 1.0, m).astype(np.float32)
    return img, lut, uv, lod, nov, rough


def test_build_pyramid_levels_bit_equal():
    """Every level equals the reference's 2x box chain (its MXU pairing
    form on CPU), odd sizes included."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0.0, 4.0, (3, 90, 142)).astype(np.float32)
    pyr = mipchain.build_pyramid(tuple(_t(img)), level_set=None)
    planes = [jnp.asarray(p) for p in img]
    assert pyr.widths == tuple(s[0] for s in jmip.pyramid_shapes(142, 90))
    for k in range(pyr.num_levels):
        np.testing.assert_array_equal(pyr.levels[k].numpy(),
                                      np.stack([np.asarray(p) for p in planes]),
                                      err_msg=f"level {k}")
        if k + 1 < pyr.num_levels:
            planes = [jmip._downsample2x_plane_mxu(p) for p in planes]
    sub = mipchain.build_pyramid(tuple(_t(img)), level_set=(2, 3))
    assert [lv is not None for lv in sub.levels][:5] == [False, False, True, True, False]
    np.testing.assert_array_equal(sub.levels[3].numpy(), pyr.levels[3].numpy())


@pytest.mark.parametrize("level_set", [(2, 3), (1, 2, 3, 4, 5)])
def test_transmission_fetch_matches_reference_kernel(level_set):
    img, lut, uv, lod, nov, rough = _fetch_inputs(4)
    jpyr = jmip.build_pyramid(tuple(jnp.asarray(p) for p in img), level_set=level_set)
    lut_q = jtex.quad_lut_2ch(jnp.asarray(lut))
    lod_c = jnp.clip(jnp.asarray(lod), float(min(level_set)), float(max(level_set)))
    parts = jmip.pyramid_fetch_parts(jpyr, jnp.asarray(uv), lod_c, level_set)
    lparts = jtex.lut_2ch_fetch_parts(lut_q, 32, jnp.asarray(nov), jnp.asarray(rough))
    ref = jax.jit(lambda pp, lr, ls, lx, ly: jtap.transmission_fetch_planes(
        pp, lr, ls, lx, ly, interpret=True))(parts, *lparts)
    pyr = mipchain.build_pyramid(tuple(_t(img)), level_set=level_set)
    got = tap_finish.transmission_fetch_planes(
        pyr, level_set, _t(uv[:, 0]), _t(uv[:, 1]), _t(lod), _t(nov), _t(rough),
        _t(lut))
    for k, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6, rtol=0,
                                   err_msg=f"plane {k}")


def test_transmission_fetch_row_form_level0():
    """Set (0,): the reference stores level 0 in ROW form and samples it
    through XLA (sample_pyramid_lod); the port's fetch reads it directly."""
    img, lut, uv, lod, nov, rough = _fetch_inputs(6, h=1100, w=1400, m=1024)
    jpyr = jmip.build_pyramid(tuple(jnp.asarray(p) for p in img), level_set=(0,))
    assert jpyr.level_rows[0] is not None  # ROW form at this size
    ref_t = jmip.sample_pyramid_lod(jpyr, jnp.asarray(uv), jnp.asarray(lod),
                                    level_set=(0,))
    lut_q = jtex.quad_lut_2ch(jnp.asarray(lut))
    ref_b = jtex.sample_lut_2ch_quad(lut_q, 32, jnp.asarray(nov), jnp.asarray(rough))
    pyr = mipchain.build_pyramid(tuple(_t(img)), level_set=(0,))
    got = tap_finish.transmission_fetch_planes(
        pyr, (0,), _t(uv[:, 0]), _t(uv[:, 1]), _t(lod), _t(nov), _t(rough), _t(lut))
    np.testing.assert_allclose(torch.stack(got[:3], -1).numpy(), np.asarray(ref_t),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(torch.stack(got[3:], -1).numpy(), np.asarray(ref_b),
                               atol=1e-6, rtol=0)


def test_lut_quad_helpers_match_reference():
    """quad_lut_2ch / lut_2ch_fetch_parts / sample_lut_2ch_quad, and the
    direct-read LUT tap the fetch kernel uses, against the reference."""
    _, lut, _, _, nov, rough = _fetch_inputs(8)
    for size in (32, 31):
        lt = lut[:size, :size]
        ref_q = jtex.quad_lut_2ch(jnp.asarray(lt))
        got_q = texture.quad_lut_2ch(_t(lt))
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(ref_q))
        ref_parts = jtex.lut_2ch_fetch_parts(ref_q, size, jnp.asarray(nov),
                                             jnp.asarray(rough))
        got_parts = texture.lut_2ch_fetch_parts(got_q, size, _t(nov), _t(rough))
        for g, r in zip(got_parts, ref_parts):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        ref = jtex.sample_lut_2ch_quad(ref_q, size, jnp.asarray(nov), jnp.asarray(rough))
        got = texture.sample_lut_2ch_quad(got_q, size, _t(nov), _t(rough))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
        direct = texture.sample_lut_2ch(_t(lt), _t(nov), _t(rough))
        np.testing.assert_array_equal(direct.numpy(), got.numpy())
