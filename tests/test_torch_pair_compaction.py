"""Pair-stream compaction (``pallas_pair_cap_frac``) on the port's kernel
branch vs the JAX package.

Binning: ``ops/raster.py::bin_triangles(pair_cap_frac=...)`` on a
numpy-seeded triangle set-up (tile boxes, culls and draw classes; the
edge functions play no part in binning) whose slot stream is longer than
the compaction's 65,536-slot floor, against the reference's
``bin_triangles(materialize=False, pair_cap_frac=...)``: the sorted
stream, ``tile_start``, ``pair_demand`` and ``pair_capacity`` equal, when
the valid pairs fit (then also the uncompacted stream's valid prefix and
``tile_start``) and when they overflow (the reference drops the last
valid pairs in stream order, and so does the port).

Frame: no reference frame of the suite has a stream past the floor (its
kernel-branch scenes hold under 14,500 triangles at 128x72, where the
stream is 2T + 37,376 slots), so the port's 128x72 dragon of 21,006
triangles renders with and without compaction, bit for bit the same, and
its ``pair_demand`` / ``pair_capacity`` equal the reference's binning of
the frame's own set-up. The visibility-buffer branch reports 0 / 0, as
the reference's. ``--check-nan`` prints the pair overflow (the floor
lowered so that a small CLI frame overflows).
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_defs import CFG_PAL, _rig
from transmission_renderer_tpu.ops import raster as jraster
from transmission_renderer_tpu_torch import cli
from transmission_renderer_tpu_torch.models.procedural import build_dragon_scene
from transmission_renderer_tpu_torch.ops import raster
from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
from transmission_renderer_tpu_torch.render import frame
from transmission_renderer_tpu_torch.render.frame import make_frame_params, render_frame

# torch runs single-threaded here: the suite runs in several worker
# processes at once, and oversubscribed OpenMP threads stall each other
torch.set_num_threads(1)

TIERS = CFG_PAL.pallas_tiers
K = CFG_PAL.pallas_tiles_per_tri


def _setup(num_tris: int, tiles_x: int, tiles_y: int, seed: int):
    """A seeded (valid, tile_bbox, class) set: most triangles cover one or
    two tiles, some a few rows (the first tier), a few the whole screen;
    a tenth are culled."""
    rng = np.random.default_rng(seed)
    bw = np.where(rng.random(num_tris) < 0.3, 2, 1)
    bh = np.ones(num_tris, np.int64)
    mid = rng.random(num_tris) < 0.02
    bw[mid], bh[mid] = rng.integers(1, 4, mid.sum()), rng.integers(2, 4, mid.sum())
    tx0 = rng.integers(0, tiles_x - bw + 1)
    ty0 = rng.integers(0, tiles_y - bh + 1)
    bbox = np.stack([tx0, ty0, tx0 + bw - 1, ty0 + bh - 1], -1)
    giant = rng.choice(num_tris, 12, replace=False)
    bbox[giant] = (0, 0, tiles_x - 1, tiles_y - 1)
    valid = rng.random(num_tris) >= 0.1
    cls = rng.integers(0, 2, num_tris)
    return valid, bbox.astype(np.int32), cls.astype(np.int32)


def _bins_pair(num_tris: int, frac, tiles=(15, 20), seed=3):
    """(the port's bins with ``frac``, the port's uncompacted bins, the
    reference's bins with ``frac``) of one seeded set-up."""
    valid, bbox, cls = _setup(num_tris, *tiles, seed)
    z = np.zeros((num_tris, 3, 3), np.float32)
    # binning reads no pixel box: a zero one stands in
    ps = raster.TriangleSetup(torch.from_numpy(z), torch.from_numpy(z[:, 0]),
                              torch.from_numpy(z[:, 0]), torch.from_numpy(valid),
                              torch.from_numpy(bbox), torch.zeros(num_tris, 4))
    js = jraster.TriangleSetup(jnp.asarray(z), jnp.asarray(z[:, 0]), jnp.asarray(z[:, 0]),
                               jnp.asarray(valid), jnp.asarray(bbox))
    args = (ps, *tiles, K, torch.from_numpy(cls), 2, TIERS)
    ref = jraster.bin_triangles(
        js, *tiles, K, CFG_PAL.max_tris_per_tile, CFG_PAL.pallas_max_big_tris,
        materialize=False, class_flags=jnp.asarray(cls), num_classes=2, tiers=TIERS,
        pair_cap_frac=frac)
    return raster.bin_triangles(*args, pair_cap_frac=frac), raster.bin_triangles(*args), ref


def _assert_bins_equal(got, ref):
    np.testing.assert_array_equal(got.sorted_tri_ids.numpy(), np.asarray(ref.sorted_tri_ids))
    np.testing.assert_array_equal(got.tile_start.numpy(), np.asarray(ref.tile_start))
    assert int(got.pair_demand) == int(ref.pair_demand)
    assert got.pair_capacity == ref.pair_capacity


@pytest.mark.parametrize("case,num_tris,frac", [("fits", 60000, 0.5),
                                                ("overflows", 60000, 0.01),
                                                ("fits at the floor", 40000, 0.01)])
def test_binning_matches_reference(case, num_tris, frac):
    got, plain, ref = _bins_pair(num_tris, frac)
    s_len = plain.sorted_tri_ids.shape[0]
    assert s_len > raster.PAIR_CAP_FLOOR
    assert got.pair_capacity == max(int(s_len * frac) + 1, raster.PAIR_CAP_FLOOR)
    assert 0 < got.pair_capacity < s_len
    assert got.sorted_tri_ids.shape == (got.pair_capacity,)
    _assert_bins_equal(got, ref)
    demand = int(got.pair_demand)
    assert demand == int(plain.tile_start[-1])  # every valid pair, unclamped
    if case == "overflows":
        assert demand > got.pair_capacity
        assert int(got.tile_start[-1]) == got.pair_capacity
    else:
        assert demand <= got.pair_capacity
        torch.testing.assert_close(got.tile_start, plain.tile_start, rtol=0, atol=0)
        assert torch.equal(got.sorted_tri_ids[:demand], plain.sorted_tri_ids[:demand])
        assert bool((got.sorted_tri_ids[demand:] == -1).all())
    assert int(plain.pair_demand) == 0 and plain.pair_capacity == 0


def test_short_stream_is_not_compacted():
    """A stream no longer than the floor stays as it is: capacity 0, as
    the reference reports."""
    got, plain, ref = _bins_pair(2000, 0.01, tiles=(3, 4))
    assert plain.sorted_tri_ids.shape[0] <= raster.PAIR_CAP_FLOOR
    _assert_bins_equal(got, ref)
    assert got.pair_capacity == 0 and int(got.pair_demand) == 0
    assert torch.equal(got.sorted_tri_ids, plain.sorted_tri_ids)


@pytest.fixture(scope="module")
def dragon():
    scene, dl, flags = build_dragon_scene(stacks=64, sectors=128).finish_bundle(device="cpu")
    lights = pack_lights([point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)], device="cpu")
    return scene, dl, flags, lights


def _frame(dragon, cfg, monkeypatch=None):
    """(image, diagnostics, the bin_triangles calls' arguments)."""
    scene, dl, flags, lights = dragon
    rig = _rig((0.0, 2.2, 1.5), -0.25)
    params = make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                               rig.sun_dir(), device="cpu")
    seen = []
    if monkeypatch is not None:
        def spy(*args, **kw):
            seen.append(args)
            return raster.bin_triangles(*args, **kw)

        monkeypatch.setattr(frame, "bin_triangles", spy)
    img, diag = render_frame(scene, dl, params, lights, cfg, flags=flags,
                             return_diagnostics=True)
    return img, diag, seen


def test_compacted_frame_equals_uncompacted(dragon, monkeypatch):
    plain_img, plain_diag, _ = _frame(dragon, CFG_PAL)
    cfg = dataclasses.replace(CFG_PAL, pallas_pair_cap_frac=0.5)
    img, diag, seen = _frame(dragon, cfg, monkeypatch)
    assert diag.pair_capacity == raster.PAIR_CAP_FLOOR
    assert 0 < int(diag.pair_demand) <= diag.pair_capacity and not diag.overflowed()
    assert torch.equal(img, plain_img)
    assert plain_diag.pair_capacity == 0 and int(plain_diag.pair_demand) == 0
    # the reference's binning of the frame's own set-up reports the same
    (setup, tiles_x, tiles_y, k, cls, num_classes, tiers, frac), = seen
    assert frac == 0.5
    # the reference's set-up has no pixel box (binning does not read it)
    js = jraster.TriangleSetup(*(jnp.asarray(a.numpy()) for a in setup[:5]))
    ref = jraster.bin_triangles(
        js, tiles_x, tiles_y, k, cfg.max_tris_per_tile, cfg.pallas_max_big_tris,
        materialize=False, class_flags=jnp.asarray(cls.numpy()), num_classes=num_classes,
        mid_tile_cap=cfg.pallas_mid_tile_cap, max_mid_tris=cfg.pallas_max_mid_tris,
        tiers=tiers, pair_cap_frac=frac)
    assert (int(diag.pair_demand), diag.pair_capacity) == (int(ref.pair_demand),
                                                           ref.pair_capacity)


def test_visibility_branch_reports_no_pairs(dragon):
    """The reference compacts only the kernel branch's stream: the
    visibility-buffer branch reports 0 / 0 with the knob on."""
    cfg = dataclasses.replace(CFG_PAL, pallas_pair_cap_frac=0.01, use_pallas_raster=False)
    img, diag, _ = _frame(dragon, cfg)
    assert bool(torch.isfinite(img).all())
    assert int(diag.pair_demand) == 0 and diag.pair_capacity == 0


def test_check_nan_prints_the_pair_overflow(tmp_path, monkeypatch, capsys):
    """An overflowing compaction: --check-nan prints the diagnostics line
    with pair_demand past pair_capacity, and the frame stays finite in
    [0, 1] (the CLI has no flag for the knob, as the reference's, so the
    config carries it here; the floor is lowered so that a 128x72 frame
    overflows)."""
    from transmission_renderer_tpu_torch import config

    base = config.RenderConfig
    monkeypatch.setattr(raster, "PAIR_CAP_FLOOR", 1024)
    monkeypatch.setattr(config, "RenderConfig", lambda **kw: base(
        **dict(kw, use_pallas_raster=True, pallas_pair_cap_frac=0.001)))
    frames = []
    argv = ["--cpu", "--procedural", "dragon", "--detail", "0.2", "--width", "128",
            "--height", "72", "--check-nan", "-o", str(tmp_path / "f.png")]
    assert cli.main(argv, frames_out=frames) == 0
    err = capsys.readouterr().err
    line = next(ln for ln in err.splitlines() if "VALIDATION: capacity overflow!" in ln)
    assert "pair_capacity=1024" in line
    assert int(re.search(r"pair_demand=(?:tensor\()?(\d+)", line)[1]) > 1024
    img = frames[0]
    assert np.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0
