"""The port's whole frame vs the JAX package's render_frame.

The small dragon golden scene (tests/golden_defs.py "dragon") at 128x72
with 8x128 tiles renders through both packages on the CPU: the reference
under CFG_PAL (its Pallas branch, interpret mode), the port through its
kernels' plain versions. At 128x72 the 256-tile floor would send the
reference's transmissive raster down its dense path, so both take the
same config with the floor lowered, which keeps the flagship's fused
sparse path (frame.py:1374-1416) at this size.

Tolerances: linear LDR RMSE < 1e-3 and max abs < 2e-2 (the reference's
compiler fuses multiply-adds, so a shared-edge pixel can pick the
neighbouring triangle), integer diagnostics equal, and sRGB RMSE < 4e-3
against tests/goldens/dragon.png (tests/test_goldens.py's tolerance)."""

import dataclasses
import os
from functools import partial

import jax
import numpy as np
import pytest
import torch

from golden_defs import CFG_PAL, GOLDEN_DIR, _lights, _rig
from transmission_renderer_tpu.models.procedural import build_dragon_scene as jdragon
from transmission_renderer_tpu.render import make_frame_params as jparams
from transmission_renderer_tpu.render import render_frame as jrender
from transmission_renderer_tpu_torch import bridge
from transmission_renderer_tpu_torch.models.procedural import build_dragon_scene
from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
from transmission_renderer_tpu_torch.render.frame import make_frame_params, render_frame
from transmission_renderer_tpu_torch.scene.textures import linear_to_srgb
from transmission_renderer_tpu_torch.utils.png import read_png

# torch runs single-threaded here: the suite runs in several worker
# processes at once, and oversubscribed OpenMP threads stall each other
torch.set_num_threads(1)

CFG = dataclasses.replace(CFG_PAL, sparse_raster_tile_floor=1,
                          transmission_tile_cap_frac=0.85)
CAM = ((0.0, 2.2, 1.5), -0.25)


@pytest.fixture(scope="module")
def frames():
    scene, dl, flags = jdragon(stacks=40, sectors=80, roughness_override=0.25).finish_bundle()
    rig = _rig(*CAM)
    params = jparams(CFG, rig.camera.view_matrix(), rig.camera.position, rig.sun_dir())
    lights = _lights()
    ref_img, ref_diag = jax.jit(partial(jrender, config=CFG, flags=flags,
                                        return_diagnostics=True))(scene, dl, params, lights)
    ref_diag = jax.tree_util.tree_map(np.asarray, ref_diag)

    pscene, pdl, pflags = build_dragon_scene(stacks=40, sectors=80).finish_bundle(device="cpu")
    pparams = make_frame_params(CFG, rig.camera.view_matrix(), rig.camera.position,
                                rig.sun_dir(), device="cpu")
    plights = pack_lights([point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)], device="cpu")
    img, diag = render_frame(pscene, pdl, pparams, plights, CFG, pflags,
                             return_diagnostics=True)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    bridged = bridge.from_jax_arrays(as_np(scene), as_np(dl), as_np(params),
                                     as_np(lights), flags, device="cpu")
    return np.asarray(ref_img), ref_diag, img.numpy(), diag, bridged


def test_frame_matches_reference(frames):
    ref, _, got, _, _ = frames
    assert got.shape == ref.shape == (72, 128, 3)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    err = np.abs(got - ref)
    rmse = float(np.sqrt(np.mean(err**2)))
    print(f"linear LDR RMSE {rmse:.3g}, max abs {err.max():.3g}")
    assert rmse < 1e-3
    assert err.max() < 2e-2


def test_frame_diagnostics_match_reference(frames):
    _, ref, _, got, _ = frames
    assert not got.overflowed()
    assert bool(ref.overflowed()) is False
    for f in ref._fields:
        r, g = getattr(ref, f), getattr(got, f)
        if isinstance(r, tuple):
            assert tuple(int(x) for x in g) == tuple(int(x) for x in r), f
        else:
            assert int(g) == int(r), f
    assert int(got.transmission_tiles) > 0


def test_frame_matches_golden(frames):
    _, _, got, _, _ = frames
    golden = read_png(os.path.join(GOLDEN_DIR, "dragon.png"))[..., :3] / 255.0
    rmse = float(np.sqrt(np.mean((linear_to_srgb(got) - golden) ** 2)))
    assert rmse < 4e-3, rmse


def test_frame_from_bridged_inputs(frames):
    """The port rendering the reference's own arrays (via the bridge)
    gives the same image as from its own builder."""
    _, _, got, _, (scene, dl, params, lights, flags) = frames
    img = render_frame(scene, dl, params, lights, CFG, flags)
    np.testing.assert_array_equal(img.numpy(), got)


def test_golden_hd_dropped_tiles_are_the_references():
    """chip_smoke.py compares with tests/goldens/dragon_hd.png outside
    GOLDEN_DROPPED_TILES. Those must be exactly the tiles whose bins the
    reference's pure-JAX raster path (which rendered that golden)
    overflows at the golden's config, counted by the reference's own
    setup_triangles / bin_triangles, not by the port."""
    from golden_defs import CFG_HD
    from test_torch_bench_hd import dropped_tiles, smoke_module

    smoke = smoke_module()
    cfg = CFG_HD
    scene, dl, _ = jdragon(roughness_override=0.25).finish_bundle()
    rig = _rig(*CAM)
    rig.sun_yaw = 4.8
    params = jparams(cfg, rig.camera.view_matrix(), rig.camera.position, rig.sun_dir())
    over = dropped_tiles(cfg, scene, dl, params)
    assert over == smoke.GOLDEN_DROPPED_TILES
    keep = smoke.golden_keep_mask(cfg)
    assert keep.shape == (cfg.height, cfg.width)
    assert keep.size - keep.sum() == len(over) * cfg.tile_w * cfg.tile_h


def test_sparse_block_helpers_match_reference():
    """block_gather / block_scatter / pixel_coords over a worklist with
    empty slots and a partial last block, exactly as the reference."""
    from transmission_renderer_tpu.render import sparse as jsparse
    from transmission_renderer_tpu_torch.render import sparse

    h, w = 9, 200  # 1800 px: 15 blocks, the last one partial
    nb = sparse.num_blocks(h, w)
    assert nb == jsparse.num_blocks(h, w) == 15
    ids = np.array([3, nb, 0, 14, nb, 7], np.int32)
    rng = np.random.default_rng(2)
    img = rng.uniform(size=(h, w, 3)).astype(np.float32)
    vals = rng.uniform(size=(len(ids) * 128, 3)).astype(np.float32)
    jwk = jsparse.BlockWork(block_ids=jax.numpy.asarray(ids), count=4,
                            n_blocks=nb, cap_b=len(ids), shape=(h, w))
    wk = sparse.BlockWork(block_ids=torch.from_numpy(ids), count=4, n_blocks=nb,
                          cap_b=len(ids), shape=(h, w))
    np.testing.assert_array_equal(
        sparse.block_gather(wk, torch.from_numpy(img)).numpy(),
        np.asarray(jsparse.block_gather(jwk, jax.numpy.asarray(img))))
    np.testing.assert_array_equal(
        sparse.block_scatter(wk, torch.from_numpy(vals), torch.from_numpy(img)).numpy(),
        np.asarray(jsparse.block_scatter(jwk, jax.numpy.asarray(vals),
                                         jax.numpy.asarray(img))))
    for g, r in zip(sparse.pixel_coords(wk), jsparse.pixel_coords(jwk)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_unported_branches_refuse():
    """The branches outside the port raise NotImplementedError (no silent
    detour): the G-buffer kernel with tiles other than 8x128, and
    pair-stream compaction. Alpha clip on the visibility-buffer branch
    (ROADMAP queue 1, item 6a) renders since it was ported: here the
    dragon with the flag on and no clip-bucket triangle gives the frame
    without it, bit for bit (tests/test_torch_vis_clip.py holds the stress
    scene to the reference). (The quality flags, every width, the dense
    transmission shade, ray-traced shadows on every transmission path and
    on the visibility-buffer branch, and textured transmissive roughness
    render since they were ported: tests/test_torch_variants_*.py; so do
    the block-sparse opaque shade, the 256-tile floor's dense paths and
    kernel-branch alpha clip:
    tests/test_torch_stress_frame.py::test_former_refusals_render, and
    ``debug_clusters``: tests/test_torch_cli.py.)"""
    builder = build_dragon_scene(stacks=8, sectors=16)
    scene, dl, flags = builder.finish_bundle(device="cpu")
    rig = _rig(*CAM)
    lights = pack_lights([point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)], device="cpu")
    vis = dataclasses.replace(CFG, use_pallas_raster=False)
    params = make_frame_params(vis, rig.camera.view_matrix(), rig.camera.position,
                               rig.sun_dir(), device="cpu")
    clipped = render_frame(scene, dl, params, lights, vis, flags._replace(has_alpha_clip=True))
    assert bool(torch.isfinite(clipped).all())
    assert torch.equal(clipped, render_frame(scene, dl, params, lights, vis, flags))
    for bad, fl, why in (
            (dataclasses.replace(CFG, tile_w=32), flags, "8x128"),
            (dataclasses.replace(CFG, pallas_pair_cap_frac=0.5), flags, "left out")):
        params = make_frame_params(bad, rig.camera.view_matrix(), rig.camera.position,
                                   rig.sun_dir(), device="cpu")
        with pytest.raises(NotImplementedError, match=why):
            render_frame(scene, dl, params, lights, bad, fl)
