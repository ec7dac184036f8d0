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

    pscene, pdl, pflags = build_dragon_scene(stacks=40, sectors=80).finish_bundle()
    pparams = make_frame_params(CFG, rig.camera.view_matrix(), rig.camera.position,
                                rig.sun_dir())
    plights = pack_lights([point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)])
    img, diag = render_frame(pscene, pdl, pparams, plights, CFG, pflags,
                             return_diagnostics=True)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    bridged = bridge.from_jax_arrays(as_np(scene), as_np(dl), as_np(params),
                                     as_np(lights), flags)
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
    import importlib.util

    from golden_defs import CFG_HD
    from transmission_renderer_tpu.config import (
        BUCKET_ALPHA_CLIP, BUCKET_OPAQUE, BUCKET_TRANSMISSION,
        BUCKET_TRANSMISSION_ALPHA_CLIP)
    from transmission_renderer_tpu.ops.cull import bucket_triangle_masks, cull_instances
    from transmission_renderer_tpu.ops.raster import bin_triangles, setup_triangles
    from transmission_renderer_tpu.scene.types import Similarity, similarity_apply
    from transmission_renderer_tpu.utils.platform import f32_matmuls

    path = os.path.join(os.path.dirname(GOLDEN_DIR), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    cfg = CFG_HD
    scene, dl, _ = jdragon(roughness_override=0.25).finish_bundle()
    rig = _rig(*CAM)
    rig.sun_yaw = 4.8
    params = jparams(cfg, rig.camera.view_matrix(), rig.camera.position, rig.sun_dir())

    @jax.jit
    @f32_matmuls
    def raw_counts(scene, dl, params):
        # the vertex transform of the reference's render_frame (frame.py:985-1002)
        inst_t = Similarity(translation=scene.inst_transform.translation[dl.vtx_inst],
                            scale=scene.inst_transform.scale[dl.vtx_inst],
                            rotation=scene.inst_transform.rotation[dl.vtx_inst])
        pos = similarity_apply(inst_t, scene.positions[dl.vtx_src])
        clip = jax.numpy.concatenate([pos, jax.numpy.ones_like(pos[:, :1])], -1) @ params.proj_view.T
        visible = cull_instances(scene, params.view, params.frustum_x_xz,
                                 params.frustum_y_yz, cfg.z_near)
        out = []
        for buckets in ((BUCKET_OPAQUE, BUCKET_ALPHA_CLIP),
                        (BUCKET_TRANSMISSION, BUCKET_TRANSMISSION_ALPHA_CLIP)):
            mask = bucket_triangle_masks(dl.tri_inst, dl.tri_bucket, visible, buckets)
            setup = setup_triangles(clip, dl.tri_vtx, mask, cfg.width, cfg.height,
                                    cfg.tile_w, cfg.tile_h)
            bins = bin_triangles(setup, cfg.tiles_x, cfg.tiles_y, cfg.max_tiles_per_tri,
                                 cfg.max_tris_per_tile, cfg.max_big_tris)
            out.append(bins.tile_start[1:] - bins.tile_start[:-1])
        return out

    over = set()
    for counts in raw_counts(scene, dl, params):
        over |= set(np.nonzero(np.asarray(counts) > cfg.max_tris_per_tile)[0].tolist())
    assert tuple(sorted(over)) == smoke.GOLDEN_DROPPED_TILES
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
    """Branches outside the slice raise NotImplementedError (no silent
    detour)."""
    scene, dl, flags = build_dragon_scene(stacks=8, sectors=16).finish_bundle()
    rig = _rig(*CAM)
    lights = pack_lights([point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)])
    for bad in (dataclasses.replace(CFG, use_pallas_raster=False),
                dataclasses.replace(CFG, ray_traced_shadows=True),
                dataclasses.replace(CFG, opaque_block_cap_frac=0.5),
                dataclasses.replace(CFG, sparse_raster_tile_floor=256),
                dataclasses.replace(CFG, width=120)):
        params = make_frame_params(bad, rig.camera.view_matrix(), rig.camera.position,
                                   rig.sun_dir())
        with pytest.raises(NotImplementedError):
            render_frame(scene, dl, params, lights, bad, flags)
    with pytest.raises(NotImplementedError):
        render_frame(scene, dl, make_frame_params(CFG, rig.camera.view_matrix(),
                                                  rig.camera.position, rig.sun_dir()),
                     lights, CFG, flags._replace(has_alpha_clip=True))
