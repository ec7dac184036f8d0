"""The port's stress frame vs the reference's under CFG_PAL itself, the
config of tests/test_goldens.py::test_golden_pallas: at 128x72 its
256-tile floor sends the peel's first round and the transmissive raster
down their dense paths. The set-up and tolerances are
tests/test_torch_stress_frame.py's."""

import os

import numpy as np
import pytest

from golden_defs import GOLDEN_DIR
from test_torch_stress_frame import (
    CFGS,
    check_diagnostics,
    check_image,
    render_pair,
    stress_scenes,
)
from transmission_renderer_tpu_torch.scene.textures import linear_to_srgb
from transmission_renderer_tpu_torch.utils.png import read_png


@pytest.fixture(scope="module")
def pair():
    return render_pair("dense", stress_scenes())


def test_dense_stress_frame_matches_reference(pair):
    check_image(pair)


def test_dense_stress_diagnostics_match_reference(pair):
    check_diagnostics(pair, CFGS["dense"])
    diag = pair[3]
    assert diag.clip_tile_capacity == 0 and diag.transmission_tile_capacity == 0
    assert int(diag.transmission_blocks) > 0


def test_dense_stress_frame_matches_golden(pair):
    """sRGB RMSE < 4e-3 against tests/goldens/stress.png."""
    golden = read_png(os.path.join(GOLDEN_DIR, "stress.png"))[..., :3] / 255.0
    rmse = float(np.sqrt(np.mean((linear_to_srgb(pair[2]) - golden) ** 2)))
    assert rmse < 4e-3, rmse
