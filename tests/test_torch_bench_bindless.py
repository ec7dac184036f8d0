"""The port's bindless frame vs the JAX package's, on the kernel branch
at 128x72 under the bench's 48-light rig (set-up and tolerances:
tests/test_torch_scenes_bench.py). It sends kernels 2 and 3 what no other
scene does: mixed-size images (some not a power of two) with no shared
bundle, so kernel 2 runs once per used meta block and kernel 3 maps each
slot to its block's planes, and 48 lights, 4 of them spot lights, through
the cluster lists (the reference runs its mask mode above 16 lights)."""

import numpy as np
import pytest
import torch

from test_torch_scenes_bench import (
    check_diagnostics,
    check_image,
    config,
    golden_rmse,
    light_dicts,
    render_pair,
)
from transmission_renderer_tpu_torch.pbr.lights import pack_lights
from transmission_renderer_tpu_torch.render.frame import render_frame
from transmission_renderer_tpu_torch.render.shading import build_material_matrix, used_meta_cols


@pytest.fixture(scope="module")
def pair():
    return render_pair("bindless")


def test_bindless_frame_matches_reference(pair):
    check_image(pair)


def test_bindless_frame_diagnostics_match_reference(pair):
    check_diagnostics(pair)
    assert 0 < int(pair["diag"].opaque_blocks) <= pair["diag"].opaque_block_capacity == 72


def test_bindless_frame_matches_golden(pair):
    """Under the small golden's own 20-light rig (golden_defs GOLDENS
    "bindless"), sRGB RMSE < 4e-3 against tests/goldens/bindless.png."""
    scene, dl, flags, params = pair["port"]
    lights = pack_lights(light_dicts("bindless", port=True, n_bindless=20), device="cpu")
    img = render_frame(scene, dl, params, lights, config("bindless"), flags)
    rmse = golden_rmse("bindless", img.numpy())
    assert rmse < 4e-3, rmse


def test_bindless_kernel_calls(pair):
    """No slot bundle: one tap per used meta block (diffuse,
    metallic-roughness, emissive), each over the whole worklist, and the
    shade maps each slot to its own block's planes; the shade gets all 48
    lights, 4 of them spots, and some pixel's cluster list holds more than
    16 of them."""
    scene, _, flags, _ = pair["port"]
    calls = pair["calls"]
    mm = build_material_matrix(scene, flags.tex_slots, flags.slot_bundles)
    n_blocks = len(used_meta_cols(mm, flags.tex_slots))
    assert flags.slot_bundles == () and n_blocks == 3
    assert [len(calls[k]) for k in ("raster_gbuf", "tap_finish", "shade",
                                    "transmission_fetch")] == [1, n_blocks, 1, 0]
    inp, spec = calls["shade"][0][0]
    assert spec.n_layers == 1 and inp.samples.shape[0] == 4 * n_blocks
    assert sorted(set(spec.slot_bundle[:2] + spec.slot_bundle[3:4])) == [0, 1, 2]
    for (args, _) in calls["tap_finish"]:
        assert args[2].shape[0] == inp.mid.numel()
    assert inp.lmat.shape == (48, 12) and int((inp.lmat[:, 11] > 0.5).sum()) == 4
    assert int(inp.counts.max()) > 16
    # the frame's pixels see a non-power-of-two image somewhere
    rows = torch.cat([a[1] for a, _ in calls["tap_finish"]])
    w = rows[:, 2].numpy()
    assert ((w & (w - 1)) != 0).any() and np.isin(w, [48, 96, 192]).any()
