"""The port's stress frame vs the reference's where the peel's caps bind:
the default 4 rounds and shrinking re-race caps, the 256-tile floor
lowered to 1, and the bench's block-sparse opaque shade
(opaque_block_cap_frac=0.8125). The set-up and tolerances are
tests/test_torch_stress_frame.py's."""

import pytest

from test_torch_stress_frame import (
    CFGS,
    check_diagnostics,
    check_image,
    render_pair,
    stress_scenes,
)


@pytest.fixture(scope="module")
def pair():
    return render_pair("capped", stress_scenes())


def test_capped_stress_frame_matches_reference(pair):
    check_image(pair)


def test_capped_stress_diagnostics_match_reference(pair):
    """Equal diagnostics, where more tiles fail than a round's cap takes,
    so pixels stay unresolved, and the opaque shade ran block-sparse."""
    check_diagnostics(pair, CFGS["capped"])
    diag = pair[3]
    assert any(int(d) > c for d, c in zip(diag.clip_round_demand, diag.clip_round_caps))
    assert int(diag.clip_unresolved) > 0 and diag.overflowed()
    assert diag.opaque_block_capacity > 0 and int(diag.opaque_blocks) > 0
