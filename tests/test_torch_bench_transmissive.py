"""The port's smooth-glass dragon (roughness 0) and attenuation frames vs
the JAX package's, on the kernel branch at 128x72 through the fused
sparse transmission path (set-up and tolerances:
tests/test_torch_scenes_bench.py). At roughness 0 the refraction level
set is (0,), so the pyramid keeps level 0 only and kernel 4 reads it in
its row form; the attenuation scene's glass boxes have no UVs. The smooth
dragon has no small golden: it is held to the reference only (and to
tests/goldens/smooth_hd.png on the card)."""

import pytest

from test_torch_scenes_bench import check_diagnostics, check_image, golden_rmse, render_pair
from transmission_renderer_tpu_torch.render.frame import refraction_level_set
from transmission_renderer_tpu_torch.scene.textures import mip_levels_for_size


NAMES = ("smooth", "attenuation")


@pytest.fixture(scope="module")
def pairs():
    """Each scene's frame pair, rendered at its first use."""
    return {}


def pair_of(pairs, name: str) -> dict:
    if name not in pairs:
        pairs[name] = render_pair(name)
    return pairs[name]


@pytest.mark.parametrize("name", NAMES)
def test_transmissive_frame_matches_reference(pairs, name):
    check_image(pair_of(pairs, name))


@pytest.mark.parametrize("name", NAMES)
def test_transmissive_frame_diagnostics_match_reference(pairs, name):
    p = pair_of(pairs, name)
    check_diagnostics(p)
    assert 0 < int(p["diag"].transmission_tiles) <= p["diag"].transmission_tile_capacity


def test_attenuation_frame_matches_golden(pairs):
    """sRGB RMSE < 4e-3 against tests/goldens/attenuation.png."""
    rmse = golden_rmse("attenuation", pair_of(pairs, "attenuation")["img"])
    assert rmse < 4e-3, rmse


@pytest.mark.parametrize("name", NAMES)
def test_transmissive_level_set_is_row_level_0(pairs, name):
    """Roughness 0: level set (0,), a pyramid of level 0 alone, fetched
    once by kernel 4; the glass samples no texture (attenuation's boxes
    have zero UVs)."""
    p = pair_of(pairs, name)
    scene, _, flags, _ = p["port"]
    calls = p["calls"]
    w, h = p["cfg"].width, p["cfg"].height
    assert flags.transmission_ior_roughness == (0.0,)
    assert refraction_level_set(flags, w, mip_levels_for_size(w, h)) == (0,)
    assert [len(calls[k]) for k in ("raster_gbuf", "tap_finish", "shade",
                                    "transmission_fetch")] == [2, 1, 2, 1]
    pyramid, level_set = calls["transmission_fetch"][0][0][:2]
    assert tuple(level_set) == (0,) and tuple(pyramid.levels[0].shape[-2:]) == (h, w)
    if name == "attenuation":
        assert not flags.tex_slots_transmission[0]
        assert float(scene.uvs[-96:].abs().max()) == 0.0
