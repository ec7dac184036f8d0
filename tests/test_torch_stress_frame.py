"""The port's stress frame (alpha-clip depth peeling on the kernel branch)
vs the JAX package's render_frame.

The small stress golden scene (tests/golden_defs.py "stress":
build_stress_scene(grid=3), its camera and light) at 128x72 with 8x128
tiles renders through both packages on the CPU: the reference on its
Pallas branch in interpret mode, as tests/test_goldens.py::test_golden_pallas
runs it, the port on its kernel branch through the kernels' plain
versions. Three configs, each in a file of its own so that they run on
separate test workers (a reference frame takes 70-110 s to compile in
interpret mode):

- "converged" (this file): CFG_PAL (8 peel rounds, full re-race caps)
  with the 256-tile floor lowered to 1 and the transmission tile cap
  raised to 0.85, so the clip peel's first round, the transmissive
  raster and every re-race run sparse, nothing overflows, and the peel
  converges (no unresolved pixel);
- "capped" (tests/test_torch_stress_capped.py): the default 4 rounds and
  shrinking re-race caps, floor 1 and the bench's
  opaque_block_cap_frac=0.8125: the caps bind, so pixels stay
  unresolved, and the opaque shade runs block-sparse;
- "dense" (tests/test_torch_stress_dense.py): CFG_PAL itself, whose
  256-tile floor sends the peel's first round and the transmissive
  raster down their dense paths.

Tolerances: linear LDR RMSE < 1e-3 (tests/test_torch_frame.py's), every
FrameDiagnostics field equal (the clip fields included), and sRGB RMSE
< 4e-3 against tests/goldens/stress.png (tests/test_goldens.py's). The
`slow` test re-renders tests/goldens/stress_hd.png with the JAX package.
"""

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_defs import CFG_PAL, GOLDEN_DIR, _lights, _rig
from transmission_renderer_tpu.models.procedural import build_stress_scene as jstress
from transmission_renderer_tpu.render import make_frame_params as jparams
from transmission_renderer_tpu.render import render_frame as jrender
from transmission_renderer_tpu_torch.config import RenderConfig
from transmission_renderer_tpu_torch.models.procedural import (
    build_dragon_scene,
    build_stress_scene,
)
from transmission_renderer_tpu_torch.ops import raster_gbuf
from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
from transmission_renderer_tpu_torch.render.frame import make_frame_params, render_frame
from transmission_renderer_tpu_torch.scene.camera import CameraRig
from transmission_renderer_tpu_torch.utils.png import read_png

# torch runs single-threaded here: the suite runs in several worker
# processes at once, and oversubscribed OpenMP threads stall each other
torch.set_num_threads(1)

CAM = ((0.0, 3.0, 2.5), -0.5)  # golden_defs.GOLDENS["stress"]
CFGS = {
    # the 0.25 transmission tile cap (3 of 9 tiles) would drop one of the
    # 4 tiles the glass covers here: 0.85, as tests/test_torch_frame.py
    "converged": dataclasses.replace(CFG_PAL, sparse_raster_tile_floor=1,
                                     transmission_tile_cap_frac=0.85),
    "capped": dataclasses.replace(CFG_PAL, sparse_raster_tile_floor=1, alpha_clip_rounds=4,
                                  clip_retile_cap_frac=(0.30, 0.08, 0.02),
                                  opaque_block_cap_frac=0.8125),
    "dense": CFG_PAL,
}


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _leaves(tree, prefix=""):
    """(name, leaf) pairs of a nested NamedTuple."""
    if hasattr(tree, "_fields"):
        return [x for f in tree._fields for x in _leaves(getattr(tree, f), f"{prefix}{f}.")]
    return [(prefix[:-1], tree)]


def bits(x):
    """A leaf as a numpy array, bfloat16 as its int16 bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def render_pair(name: str, scenes) -> tuple:
    """(reference image, reference diagnostics, port image, port
    diagnostics, the port's recorded kernel-1 calls) of config ``name``."""
    cfg = CFGS[name]
    (scene, dl, flags), (pscene, pdl, pflags) = scenes
    rig = _rig(*CAM)
    params = jparams(cfg, rig.camera.view_matrix(), rig.camera.position, rig.sun_dir())
    ref_img, ref_diag = jax.jit(partial(jrender, config=cfg, flags=flags,
                                        return_diagnostics=True))(scene, dl, params, _lights())
    pparams = make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                                rig.sun_dir(), device="cpu")
    plights = pack_lights([point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)], device="cpu")
    raster_gbuf.KERNEL.recorder = []
    try:
        img, diag = render_frame(pscene, pdl, pparams, plights, cfg, flags=pflags,
                                 return_diagnostics=True)
    finally:
        calls, raster_gbuf.KERNEL.recorder = raster_gbuf.KERNEL.recorder, None
    return np.asarray(ref_img), _np(ref_diag), img.numpy(), diag, calls


def stress_scenes() -> tuple:
    """(reference (scene, draw list, flags), the port's on the CPU)."""
    return jstress(grid=3).finish_bundle(), build_stress_scene(grid=3).finish_bundle(device="cpu")


def check_image(pair) -> None:
    """Linear LDR RMSE < 1e-3 against the reference's frame."""
    ref, _, got, _, _ = pair
    assert got.shape == ref.shape == (72, 128, 3)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    rmse = float(np.sqrt(np.mean((got - ref) ** 2)))
    print(f"linear LDR RMSE {rmse:.3g}, max abs {np.abs(got - ref).max():.3g}")
    assert rmse < 1e-3


def check_diagnostics(pair, cfg) -> None:
    """Every FrameDiagnostics field equal to the reference's."""
    _, ref, _, got, _ = pair
    for f in ref._fields:
        r, g = getattr(ref, f), getattr(got, f)
        if isinstance(r, tuple):
            assert tuple(int(x) for x in g) == tuple(int(x) for x in r), f
        else:
            assert int(g) == int(r), f
    assert len(got.clip_round_demand) == cfg.alpha_clip_rounds - 1


@pytest.fixture(scope="module")
def scenes():
    return stress_scenes()


@pytest.fixture(scope="module")
def pair(scenes):
    return render_pair("converged", scenes)


def test_stress_frame_matches_reference(pair):
    check_image(pair)


def test_stress_diagnostics_match_reference(pair):
    """The converged config: the peel leaves no pixel unresolved."""
    check_diagnostics(pair, CFGS["converged"])
    diag = pair[3]
    assert int(diag.clip_unresolved) == 0 and int(diag.clip_tiles) > 0
    assert int(diag.transmission_tiles) > 0 and not diag.overflowed()


def test_clip_alpha_test_matches_reference(scenes, pair):
    """_clip_alpha_ok_tiles on the channels of the port's first class-2
    race (a captured kernel-1 call of the converged frame) equals the
    reference's on the same channels, and both fail some winners."""
    from transmission_renderer_tpu.render.frame import _clip_alpha_ok_tiles as jok
    from transmission_renderer_tpu_torch.render.frame import _clip_alpha_ok_tiles

    (scene, _, _), (pscene, _, _) = scenes
    call = next(c for c in pair[4] if c[1].get("pass_class") == 2)
    ch = raster_gbuf.KERNEL.replay(call, False)
    got = _clip_alpha_ok_tiles(pscene, ch).numpy()
    ref = np.asarray(jok(scene, {k: jnp.asarray(v.numpy()) for k, v in ch.items()}))
    np.testing.assert_array_equal(got, ref)
    winners = ch["tri"].numpy() >= 0
    assert (~got & winners).any() and (got & winners).any()


@pytest.mark.parametrize("form", ["grid", "band"])
def test_clip_alpha_plain_scatters_by_slot_ids(scenes, pair, form):
    """The peel's alpha test in its plain form (render/frame.py::
    CLIP_ALPHA_KERNEL, the kernel's counterpart on the CPU) on the
    channels of the port's first class-2 race: each slot's
    _clip_alpha_ok_tiles lands at the slot's tile id, and an empty slot
    (id n_tiles) writes nothing, so every other row, the pad row included,
    keeps what it held. "grid": ids spread over a grid wider than the
    worklist; "band": a band's local ids, the worklist as long as the
    band, so the empty slots leave some of its tiles out."""
    from transmission_renderer_tpu_torch.render.frame import (
        CLIP_ALPHA_KERNEL,
        _clip_alpha_ok_tiles,
        _clip_alpha_test,
    )

    _, (pscene, _, _) = scenes
    call = next(c for c in pair[4] if c[1].get("pass_class") == 2)
    ch = raster_gbuf.KERNEL.replay(call, False)
    k = ch["tri"].shape[0]
    gen = torch.Generator().manual_seed(17)
    n_tiles = 2 * k + 1 if form == "grid" else k
    ids = torch.randperm(n_tiles, generator=gen)[:k].to(torch.int32)
    ids[::3] = n_tiles  # empty slots, the first among them
    base = torch.rand((n_tiles + 1, 8, 128), generator=gen) < 0.5
    want = base.clone()
    tested = _clip_alpha_ok_tiles(pscene, ch)
    for slot, tile in enumerate(ids.tolist()):
        if tile < n_tiles:
            want[tile] = tested[slot]
    before = CLIP_ALPHA_KERNEL.launches
    got = _clip_alpha_test(pscene, ch, ids, n_tiles, base.clone())
    assert torch.equal(got, want)
    assert torch.equal(got[n_tiles], base[n_tiles])
    assert CLIP_ALPHA_KERNEL.launches == before  # the plain form launches nothing
    winners = ch["tri"] >= 0
    assert bool((~tested & winners).any()) and bool((tested & winners).any())


def test_stress_builder_matches_reference(scenes):
    """build_stress_scene freezes the reference's arrays bit for bit (the
    atlas as bf16 bit patterns), with the same flags, and the same atlas
    layer classes: two image sizes (the 256^2 checker, the 128^2 leaf) in
    one diffuse slot."""
    from transmission_renderer_tpu.ops.texture import atlas_classes as jclasses
    from transmission_renderer_tpu_torch.ops.texture import atlas_classes

    (ref_scene, ref_dl, ref_flags), (scene, dl, flags) = scenes
    for ref, got in ((ref_scene, scene), (ref_dl, dl)):
        ref_leaves, got_leaves = dict(_leaves(ref)), dict(_leaves(got))
        assert set(ref_leaves) == set(got_leaves)
        for name, a in ref_leaves.items():
            np.testing.assert_array_equal(bits(got_leaves[name]), bits(a), err_msg=name)
    assert tuple(flags) == tuple(ref_flags)
    assert flags.has_alpha_clip and flags.slot_bundles == ref_flags.slot_bundles
    assert atlas_classes(scene.atlas_meta) == jclasses(ref_scene.atlas_meta)
    sizes = {tuple(r) for r in scene.atlas_meta[:, 2:4].tolist()}
    assert sizes == {(256, 256), (128, 128)}


@pytest.mark.parametrize("axis,angle", [((0, 1, 0), 2.3), ((1, 0, 0), 1.57),
                                        ((0.3, -2.0, 0.5), -0.7)])
def test_quat_from_axis_angle_matches_reference(axis, angle):
    from transmission_renderer_tpu.scene.types import quat_from_axis_angle as jquat
    from transmission_renderer_tpu_torch.scene.types import quat_from_axis_angle

    np.testing.assert_array_equal(quat_from_axis_angle(axis, angle), jquat(axis, angle))


def _bundle_atlas(builder_cls):
    """A 256^2 checker, a 128^2 image and a 2-layer 64^2 bundle in one
    atlas (layer classes 1 and 2)."""
    rng = np.random.default_rng(8)
    b = builder_cls()
    refs = [b.add_texture(rng.integers(0, 256, (256, 256, 4)).astype(np.uint8), srgb=True),
            b.add_texture(rng.integers(0, 256, (128, 128, 4)).astype(np.uint8), srgb=False)]
    refs += b.add_texture_bundle([(rng.integers(0, 256, (64, 64, 4)).astype(np.uint8), True),
                                  (rng.integers(0, 256, (64, 64, 4)).astype(np.uint8), False)])
    return b.atlas.finish(), refs


@pytest.mark.parametrize("with_layer", [False, True])
def test_sample_texture_rows_matches_reference(with_layer):
    """sample_texture_rows over mixed image sizes (and, with a layer, a
    two-class atlas holding a 2-layer bundle) at random uv and lod."""
    from transmission_renderer_tpu.ops.texture import atlas_classes as jclasses
    from transmission_renderer_tpu.ops.texture import sample_texture_rows as jsample
    from transmission_renderer_tpu.scene.builder import SceneBuilder as JBuilder
    from transmission_renderer_tpu_torch.ops.texture import atlas_classes, sample_texture_rows
    from transmission_renderer_tpu_torch.scene.builder import SceneBuilder
    from transmission_renderer_tpu_torch.scene.textures import (
        IMAGE_MASK, LAYER_SHIFT, META_COLS, WRAP_REPEAT)

    (texels, meta, _), refs = _bundle_atlas(SceneBuilder)
    (jtexels, jmeta, _), jrefs = _bundle_atlas(JBuilder)
    assert refs == jrefs
    classes = atlas_classes(meta)
    assert classes == jclasses(jnp.asarray(jmeta)) == (1, 2)
    rng = np.random.default_rng(12)
    n = 4096
    packed = np.array(refs if with_layer else refs[:2], np.int32)[rng.integers(0, 4 if with_layer else 2, n)]
    rows = np.asarray(jmeta)[packed & IMAGE_MASK][:, :META_COLS].astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    lod = rng.uniform(-1.0, 9.0, n).astype(np.float32)
    layer = packed >> LAYER_SHIFT
    ref = jsample(jnp.asarray(jtexels), jnp.asarray(rows), jnp.asarray(uv), jnp.asarray(lod),
                  WRAP_REPEAT, layer=jnp.asarray(layer) if with_layer else None,
                  classes=classes)
    got = sample_texture_rows(texels, torch.from_numpy(rows), torch.from_numpy(uv),
                              torch.from_numpy(lod), WRAP_REPEAT, classes,
                              layer=torch.from_numpy(layer) if with_layer else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    if with_layer:
        assert (layer > 0).any()


def test_former_refusals_render():
    """The options the kernel branch refused before alpha clip was ported
    now render the dragon: the block-sparse opaque shade gives the dense
    shade's image while its cap holds; the 256-tile floor takes the dense
    transmissive raster and the compacted shade, and alpha clip on a
    scene without clip triangles takes the non-fused path with two empty
    peels: both give the fused sparse path's image."""
    scene, dl, flags = build_dragon_scene(stacks=8, sectors=16).finish_bundle(device="cpu")
    cfg = RenderConfig(width=128, height=72, use_pallas_raster=True,
                       sparse_raster_tile_floor=1, transmission_tile_cap_frac=0.85)
    rig = CameraRig()
    rig.camera.position = np.array([0.0, 2.2, 1.5], np.float32)
    rig.camera.pitch = -0.25
    params = make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                               rig.sun_dir(), device="cpu")
    lights = pack_lights([point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)], device="cpu")
    base = render_frame(scene, dl, params, lights, cfg, flags=flags)
    sparse, diag = render_frame(scene, dl, params, lights,
                                dataclasses.replace(cfg, opaque_block_cap_frac=1.0), flags=flags,
                                return_diagnostics=True)
    assert not diag.overflowed() and 0 < int(diag.opaque_blocks) <= diag.opaque_block_capacity
    assert torch.equal(sparse, base)
    for variant, fl in ((dataclasses.replace(cfg, sparse_raster_tile_floor=256), flags),
                        (cfg, flags._replace(has_alpha_clip=True))):
        img, diag = render_frame(scene, dl, params, lights, variant, flags=fl,
                                 return_diagnostics=True)
        assert not diag.overflowed()
        np.testing.assert_allclose(img.numpy(), base.numpy(), rtol=0, atol=1e-6)


def test_block_sparse_opaque_shade_gathers_shadow_factors():
    """With ray-traced shadows, the block-sparse opaque shade reads each
    pixel's shadow factors from the worklist: the dense shade's image."""
    builder = build_dragon_scene(stacks=8, sectors=16)
    scene, dl, flags = builder.finish_bundle(device="cpu")
    cfg = RenderConfig(width=128, height=72, use_pallas_raster=True, ray_traced_shadows=True,
                       sparse_raster_tile_floor=1, transmission_tile_cap_frac=0.85)
    rig = CameraRig()
    rig.camera.position = np.array([0.0, 2.2, 1.5], np.float32)
    rig.camera.pitch = -0.25
    params = make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                               rig.sun_dir(), device="cpu")
    lights = pack_lights([point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)], device="cpu")
    bvh = builder.build_rt_bvh(device="cpu")
    dense = render_frame(scene, dl, params, lights, cfg, flags=flags, bvh=bvh)
    sparse = render_frame(scene, dl, params, lights,
                          dataclasses.replace(cfg, opaque_block_cap_frac=1.0), flags=flags, bvh=bvh)
    assert torch.equal(sparse, dense)


def test_stress_refusals():
    """The stress scene's former refusal renders: alpha clip on the
    visibility-buffer branch (ROADMAP queue 1, item 6a, kernel 6's alpha
    form; tests/test_torch_vis_clip.py holds it to the reference): finite,
    in [0, 1], and not the kernel branch's unpeeled image. Ray-traced
    shadows with alpha clip render (the compacted worklist's shadow rays):
    finite, in [0, 1], and in HDR nowhere brighter than the frame without
    them and darker somewhere."""
    builder = build_stress_scene(grid=2)
    scene, dl, flags = builder.finish_bundle(device="cpu")
    rig = _rig(*CAM)
    lights = pack_lights([point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)], device="cpu")
    pal = dataclasses.replace(CFGS["converged"], pallas_interpret=False)
    cfg = dataclasses.replace(pal, use_pallas_raster=False)
    params = make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                               rig.sun_dir(), device="cpu")
    vis = render_frame(scene, dl, params, lights, cfg, flags=flags)
    assert torch.isfinite(vis).all() and vis.min() >= 0.0 and vis.max() <= 1.0
    unclipped = render_frame(scene, dl, params, lights, cfg,
                             flags=flags._replace(has_alpha_clip=False))
    assert (vis != unclipped).any()
    rt = dataclasses.replace(pal, ray_traced_shadows=True, alpha_clip_rounds=2)
    params = make_frame_params(rt, rig.camera.view_matrix(), rig.camera.position,
                               rig.sun_dir(), device="cpu")
    _, lit = render_frame(scene, dl, params, lights, rt, flags=flags, return_hdr=True)
    img, hdr = render_frame(scene, dl, params, lights, rt, flags=flags, return_hdr=True,
                            bvh=builder.build_rt_bvh(device="cpu"))
    assert torch.isfinite(img).all() and img.min() >= 0.0 and img.max() <= 1.0
    assert (hdr <= lit).all() and (hdr < lit).any()


# ---------------------------------------------------------------------------
# the 1080p golden
# ---------------------------------------------------------------------------

# the bench's stress config (bench.py:276), camera (bench.py:86-90, the
# CameraRig's default sun) and two lights (bench.py:93-99)
HD_CFG = RenderConfig(width=1920, height=1080, opaque_block_cap_frac=0.8125)


def render_stress_hd_golden() -> np.ndarray:
    """The JAX package's 1080p stress frame at the bench's config, camera
    (yaw 0) and lights, through its CPU default, the visibility-buffer
    branch, whose in-raster alpha test the depth peel converges to ->
    sRGB [1080, 1920, 3] float."""
    from transmission_renderer_tpu import config as jconfig
    from transmission_renderer_tpu.pbr.lights import pack_lights as jpack
    from transmission_renderer_tpu.pbr.lights import point_light as jpoint
    from transmission_renderer_tpu.scene.camera import CameraRig as JRig
    from transmission_renderer_tpu.scene.textures import linear_to_srgb as jsrgb

    cfg = jconfig.RenderConfig(width=1920, height=1080, opaque_block_cap_frac=0.8125)
    scene, dl, flags = jstress().finish_bundle()
    rig = JRig()
    rig.camera.position = np.array([0.0, 2.2, 1.5], np.float32)
    rig.camera.pitch = -0.25
    params = jparams(cfg, rig.camera.view_matrix(), rig.camera.position, rig.sun_dir())
    lights = jpack([jpoint([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0),
                    jpoint([8.0, 0.8, 0.0], [0.0, 1.0, 0.0], 10.0)])
    ldr, diag = jax.jit(partial(jrender, config=cfg, flags=flags, return_diagnostics=True))(
        scene, dl, params, lights)
    assert not bool(diag.overflowed()), diag
    return jsrgb(np.asarray(ldr))


@pytest.mark.slow
def test_stress_hd_golden_is_the_references():
    """tests/goldens/stress_hd.png (which tests/test_torch_card_hd.py holds
    the port's 1080p kernel-branch frame to) is the reference's own render,
    with no bin overflow."""
    golden = read_png(os.path.join(GOLDEN_DIR, "stress_hd.png"))[..., :3] / 255.0
    got = render_stress_hd_golden()
    rmse = float(np.sqrt(np.mean((got - golden) ** 2)))
    assert rmse < 4e-3, rmse
