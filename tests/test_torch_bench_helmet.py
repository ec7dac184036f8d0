"""The port's helmet and test-scene frames vs the JAX package's, on the
kernel branch at 128x72 (set-up and tolerances:
tests/test_torch_scenes_bench.py). The helmet sends kernels 2 and 3 what
the flagship never does: a 4-layer texture bundle (diffuse,
metallic-roughness, normal map, emissive) beside 1-layer images, the
normal-map and emissive slots, and a frame with no transmissive pass,
whose opaque shade runs block-sparse. Each scene's reference frame
compiles in a module fixture."""

import numpy as np
import pytest

from test_torch_scenes_bench import check_diagnostics, check_image, golden_rmse, render_pair


@pytest.fixture(scope="module", params=["helmet", "test_scene"])
def pair(request):
    return request.param, render_pair(request.param)


def test_bench_frame_matches_reference(pair):
    check_image(pair[1])


def test_bench_frame_diagnostics_match_reference(pair):
    name, p = pair
    check_diagnostics(p)
    if name == "helmet":  # block-sparse, every block of the frame a worklist slot
        assert 0 < int(p["diag"].opaque_blocks) <= p["diag"].opaque_block_capacity == 72


def test_bench_frame_matches_golden(pair):
    """sRGB RMSE < 4e-3 against tests/goldens/<name>.png."""
    name, p = pair
    rmse = golden_rmse(name, p["img"])
    assert rmse < 4e-3, rmse


def test_bench_frame_kernel_calls(pair):
    """What the frame sends the kernels: one pass (no transmission), one
    material tap; for the helmet the tap reads the 4-layer bundle's 16
    planes and the shade uses the normal-map and emissive slots."""
    name, p = pair
    calls = p["calls"]
    assert [len(calls[k]) for k in ("raster_gbuf", "tap_finish", "shade",
                                    "transmission_fetch")] == [1, 1, 1, 0]
    (_, rows, uv, _, _, classes), _ = calls["tap_finish"][0]
    inp, spec = calls["shade"][0][0]
    flags = p["port"][2]
    if name == "helmet":
        assert classes == (1, 4) and spec.n_layers == 4
        assert inp.samples.shape == (16, uv.shape[0])
        assert flags.tex_slots[2] and flags.tex_slots[3] and spec.tex_slots == flags.tex_slots
        # pixels on the helmet read their bundle's layers; the floor's 1
        used = np.unique(rows[:, -1].numpy())
        assert set(used.tolist()) == {1, 4}
    else:
        assert classes == (1,) and spec.n_layers == 1
