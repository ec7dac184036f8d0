"""The kernel branch's frame variants, against the JAX package's
interpret-mode Pallas frames at 128x72 (tests/variants_defs.py). Each
reference frame costs 15-45 s of tracing, so the variants share two
scenes (three reference frames):

- textured transmissive roughness with ray-traced shadows and the dense
  transmission raster and shade (tile cap None, block cap None): the
  dragon whose glass reads a metallic-roughness texture, built through
  each package's SceneBuilder from the same arrays; no static level set,
  so the dense kernel shade's fetch is kernel 4's full-pyramid form, and
  both passes' shadow rays go in 8x16 groups;
- the small stress scene 200 px wide with alpha clip, ray-traced
  shadows, quad taps and half-res refraction, then with bf16 light math
  too: kernel 1 over a partial last tile column, the clip peel's first
  round (its re-race rounds are held by tests/test_torch_stress_*.py),
  the sparse-tile transmission raster, both shades on the tensor path
  (as the reference's gate sends the flags, and a width that is not a
  multiple of 128), the opaque pass's quad taps, the bf16 light cores,
  the dense transmission shade's half-res fetch.

The compacted worklist's shadow rays are held on the visibility-buffer
branch (tests/test_torch_variants_vis.py), whose non-fused transmission
section is the same code.

Tolerances: linear RMSE <= 1e-5 and every diagnostic equal; shadow factors
equal on every ray; with bf16 the port's frame within a quarter of the
reference's own bf16 error of the reference's frame, that error measured
against the reference's frame without bf16 (the stress frame with the
other two flags, which is also held at 1e-5).
"""

import dataclasses

import numpy as np
import pytest
import torch

from variants_defs import (
    BF16_SHARE,
    PAL,
    FrameCache,
    check_diagnostics,
    check_factors,
    check_image,
    check_range,
    rmse,
)

torch.set_num_threads(1)

FLAGS = dict(half_res_refraction=True, quad_material_taps=True, bf16_light_math=True)
CONFIGS = {
    "rt_dense": dataclasses.replace(PAL, ray_traced_shadows=True, transmission_tile_cap_frac=None,
                                    transmission_block_cap_frac=None),
    "flags_rt_clip_w200": dataclasses.replace(PAL, width=200, ray_traced_shadows=True,
                                              alpha_clip_rounds=1, **FLAGS),
}
CONFIGS["no_bf16"] = dataclasses.replace(CONFIGS["flags_rt_clip_w200"], bf16_light_math=False)
CONFIGS["no_rt"] = dataclasses.replace(CONFIGS["flags_rt_clip_w200"], ray_traced_shadows=False)
CONFIGS["plain"] = dataclasses.replace(CONFIGS["no_bf16"], half_res_refraction=False,
                                       quad_material_taps=False)


@pytest.fixture(scope="module")
def frames():
    return FrameCache(CONFIGS, rt_kinds=("textured_glass", "stress"))


def test_textured_glass_builder_matches_reference(frames):
    """Both builders freeze the same flags: no static ior-adjusted
    roughness (so no level set), the metallic-roughness slot sampled in
    the transmission pass."""
    scenes = frames.scene("textured_glass")
    ref_flags, flags = scenes.ref[2], scenes.port[2]
    assert tuple(flags) == tuple(ref_flags)
    assert flags.transmission_ior_roughness is None and flags.tex_slots_transmission[1]
    np.testing.assert_array_equal(scenes.port[0].materials.tex_metallic_roughness.numpy(),
                                  np.asarray(scenes.ref[0].materials.tex_metallic_roughness))


def test_textured_glass_rt_dense_frame_matches_reference(frames):
    pair = frames("textured_glass", "rt_dense")
    check_image(pair)
    check_diagnostics(pair)
    check_factors(pair, ("2d", "2d"))
    diag = pair["diag"]
    assert diag.transmission_tile_capacity == 0 and diag.transmission_block_capacity == 0
    # the dense kernel shade: kernel 3 over every block of both passes,
    # then kernel 4's full form (no level set) over every pyramid level
    assert len(pair["calls"]["shade"]) == 2
    (fetch,) = pair["calls"]["transmission_fetch"]
    pyramid, level_set = fetch[0][:2]
    assert level_set == tuple(range(pyramid.num_levels))
    assert all(lv is not None for lv in pyramid.levels)
    assert fetch[0][2].shape[0] == 128 * 72
    # the textured roughness spreads the lods over several levels
    lod = fetch[0][4].numpy()
    assert np.unique(np.floor(lod[lod > 0])).size >= 3


def test_flags_rt_alpha_clip_width_200_no_bf16_frame_matches_reference(frames):
    """Quad taps and half-res refraction at 200 px with RT and alpha clip,
    without bf16: at the exact frames' tolerance."""
    pair = frames("stress", "no_bf16")
    check_image(pair)
    check_diagnostics(pair)
    check_factors(pair, ("2d", "2d"))
    assert rmse(pair["img"], frames("stress", "plain", port_only=True)["img"]) > 1e-4


def test_flags_rt_alpha_clip_width_200_frame_matches_reference(frames):
    """With bf16 too; the reference's own bf16 error is its frame against
    its frame without bf16."""
    pair = frames("stress", "flags_rt_clip_w200")
    check_range(pair)
    own = rmse(pair["ref"], frames("stress", "no_bf16")["ref"])
    err = rmse(pair["img"], pair["ref"])
    print(f"port vs reference {err:.3g}, the reference's bf16 error {own:.3g}")
    assert err <= BF16_SHARE * own
    check_diagnostics(pair)
    # both passes traced over the dense grid (8x16 groups need w % 16 == 0,
    # so at 200 px both packages walk row-major)
    check_factors(pair, ("2d", "2d"))
    diag = pair["diag"]
    assert diag.transmission_block_capacity == 0 and int(diag.transmission_tiles) > 0
    calls = pair["calls"]
    # kernel 1 over two tile columns, the second partial; both shades on
    # the tensor path, where the flags and the width send them
    assert calls["raster_gbuf"] and not calls["shade"] and not calls["tap_finish"]
    assert not calls["transmission_fetch"]
    assert all(c[0][4] == 200 for c in calls["raster_gbuf"])
    lit = frames("stress", "no_rt", port_only=True)["hdr"]
    assert (pair["hdr"] <= lit).all() and (pair["hdr"] < lit).any()
