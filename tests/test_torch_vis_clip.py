"""Alpha clip on the visibility-buffer branch: kernel 6's alpha form (its
plain version here) against the reference's in-raster alpha test.

The small stress golden scene (tests/golden_defs.py "stress":
build_stress_scene(grid=3), its camera and light) at
tests/golden_defs.py::CFG (128x72, 32x8 tiles), which on the CPU takes
the visibility-buffer branch in both packages: the reference's pure
raster with ``alpha_coverage_fn`` (render/frame.py::_make_alpha_fn), the
port's kernel 6 with its ``VisAlpha``. Each pass's triangle ids equal the
reference's on every pixel (the reference's two raster passes replayed
over its own setup and bins), the linear frame is within RMSE 1e-5,
every FrameDiagnostics field is equal (the clip fields are a branch's
without a peel), and the port's own scene meets tests/goldens/stress.png
at tests/test_goldens.py's sRGB RMSE < 4e-3.

The ``slow`` test renders the reference's 1080p stress frame on this
branch (the render of tests/goldens/stress_hd.png, ~2.5 min) and holds
chip_smoke.py's pinned STRESS_VIS_DIAGNOSTICS, which phase 13 holds the
port's frame on the card to, to its diagnostics.

Units: the alpha test's keep and kill decisions equal _make_alpha_fn's on
numpy-seeded fragments, with the cutoff set within 1e-6 of each
fragment's alpha (the two alphas agree to 2.1e-7 on these fragments:
the reference's compiler contracts the uv derivatives); the plain raster
with alpha gives the same bits whole or segmented.
"""

import importlib.util
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_defs import CFG, GOLDEN_DIR, _lights, _rig
from transmission_renderer_tpu.config import (
    BUCKET_ALPHA_CLIP,
    BUCKET_OPAQUE,
    BUCKET_TRANSMISSION,
    BUCKET_TRANSMISSION_ALPHA_CLIP,
)
from transmission_renderer_tpu.models.procedural import build_stress_scene as jstress
from transmission_renderer_tpu.ops import cull as jcull
from transmission_renderer_tpu.ops import raster as jraster
from transmission_renderer_tpu.pbr.lights import pack_lights as jpack
from transmission_renderer_tpu.pbr.lights import point_light as jpoint
from transmission_renderer_tpu.render import frame as jframe
from transmission_renderer_tpu.scene.types import Similarity, similarity_apply
from transmission_renderer_tpu.utils.platform import f32_matmuls
from transmission_renderer_tpu_torch import bridge
from transmission_renderer_tpu_torch.models.procedural import build_stress_scene
from transmission_renderer_tpu_torch.ops import raster_vis
from transmission_renderer_tpu_torch.ops.cull import transform_vertices
from transmission_renderer_tpu_torch.ops.raster import setup_triangles, untile_image
from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
from transmission_renderer_tpu_torch.render.frame import make_frame_params, render_frame, vis_alpha
from transmission_renderer_tpu_torch.scene.textures import linear_to_srgb
from transmission_renderer_tpu_torch.utils.png import read_png

# torch runs single-threaded here: the suite runs in several worker
# processes at once, and oversubscribed OpenMP threads stall each other
torch.set_num_threads(1)

CAM = ((0.0, 3.0, 2.5), -0.5)  # golden_defs.GOLDENS["stress"]
PASSES = ((BUCKET_OPAQUE, BUCKET_ALPHA_CLIP),
          (BUCKET_TRANSMISSION, BUCKET_TRANSMISSION_ALPHA_CLIP))


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def reference_passes(scene, dl, params, cfg):
    """The reference's two visibility-buffer raster passes of its frame
    (frame.py:1004-1006, 1055-1064, 1159-1166, 1457-1463): its transform,
    cull, setup, materialised bins and pure raster with _make_alpha_fn,
    the transmissive pass seeded with the opaque depth -> [VisibilityBuffer]."""

    @jax.jit
    @f32_matmuls
    def passes(scene, dl, params):
        inst_t = Similarity(*(a[dl.vtx_inst] for a in scene.inst_transform))
        world = similarity_apply(inst_t, scene.positions[dl.vtx_src])
        clip = jnp.concatenate([world, jnp.ones_like(world[:, :1])], -1) @ params.proj_view.T
        visible = jcull.cull_instances(scene, params.view, params.frustum_x_xz,
                                       params.frustum_y_yz, cfg.z_near)
        alpha_fn = jframe._make_alpha_fn(scene, dl, scene.uvs[dl.vtx_src], cfg.width,
                                         cfg.height)
        out, depth = [], None
        for buckets in PASSES:
            mask = jcull.bucket_triangle_masks(dl.tri_inst, dl.tri_bucket, visible, buckets)
            setup = jraster.setup_triangles(clip, dl.tri_vtx, mask, cfg.width, cfg.height,
                                            cfg.tile_w, cfg.tile_h)
            bins = jraster.bin_triangles(setup, cfg.tiles_x, cfg.tiles_y, cfg.max_tiles_per_tri,
                                         cfg.max_tris_per_tile, cfg.max_big_tris)
            vis = jraster.rasterize(setup, bins, cfg.width, cfg.height, cfg.tile_w, cfg.tile_h,
                                    alpha_coverage_fn=alpha_fn, init_depth=depth)
            depth = vis.depth if depth is None else depth
            out.append(vis)
        return out

    return _np(passes(scene, dl, params))


@pytest.fixture(scope="module")
def frames():
    """The reference's frame (image, HDR, diagnostics) and its two raster
    passes; the port's frame from the same arrays and its recorded
    kernel-6 calls."""
    scene, dl, flags = jstress(grid=3).finish_bundle()
    rig = _rig(*CAM)
    params = jframe.make_frame_params(CFG, rig.camera.view_matrix(), rig.camera.position,
                                      rig.sun_dir())
    lights = _lights()
    ref = _np(jax.jit(partial(jframe.render_frame, config=CFG, flags=flags, return_hdr=True,
                              return_diagnostics=True))(scene, dl, params, lights))
    ref_vis = reference_passes(scene, dl, params, CFG)
    inputs = bridge.from_jax_arrays(_np(scene), _np(dl), _np(params), _np(lights), flags,
                                    device="cpu")
    assert inputs[4].has_alpha_clip
    raster_vis.KERNEL.recorder = []
    try:
        got = render_frame(*inputs[:4], CFG, flags=inputs[4], return_hdr=True,
                           return_diagnostics=True)
    finally:
        calls, raster_vis.KERNEL.recorder = raster_vis.KERNEL.recorder, None
    return ref, ref_vis, got, calls


def _untile(t):
    return untile_image(t, CFG.tiles_x, CFG.tiles_y, CFG.tile_w, CFG.tile_h, CFG.width,
                        CFG.height).numpy()


def test_vis_clip_tri_ids_match_reference(frames):
    """Both passes: the same triangle on every pixel as the reference's
    raster with its alpha test, and the alpha test kills somewhere."""
    _, ref_vis, _, calls = frames
    assert len(calls) == 2 and all("alpha" in kw for _, kw in calls)
    for (args, kw), ref in zip(calls, ref_vis):
        tri = _untile(raster_vis.KERNEL.replay((args, kw), False)[0])
        np.testing.assert_array_equal(tri, ref.tri_id)
    args, kw = calls[0]
    no_alpha = {k: v for k, v in kw.items() if k != "alpha"}
    unclipped = _untile(raster_vis.KERNEL.replay((args, no_alpha), False)[0])
    assert (unclipped != ref_vis[0].tri_id).sum() > 100


def test_vis_clip_frame_matches_reference(frames):
    (ref_img, ref_hdr, _), _, (img, hdr, _), _ = frames
    assert bool(torch.isfinite(img).all()) and 0.0 <= float(img.min()) <= float(img.max()) <= 1.0
    rmse = float(np.sqrt(np.mean((img.numpy() - ref_img) ** 2)))
    print(f"linear LDR RMSE {rmse:.3g}, max abs {np.abs(img.numpy() - ref_img).max():.3g}")
    assert rmse <= 1e-5
    # HDR as tests/test_torch_vis_frame.py holds it
    bad = ~np.isclose(hdr.numpy(), ref_hdr, atol=1e-4, rtol=1e-4)
    assert bad.sum() <= 1e-3 * bad.size, (int(bad.sum()), float(np.abs(hdr.numpy() - ref_hdr).max()))


def test_vis_clip_diagnostics_match_reference(frames):
    """Every field equal: the bins' (the port's transform is bit-equal, so
    degenerate triangles count alike) and the clip fields of a branch
    without a peel."""
    (_, _, ref), _, (_, _, got), _ = frames
    assert got._fields == ref._fields
    for f in ref._fields:
        r, g = getattr(ref, f), getattr(got, f)
        if isinstance(r, tuple):
            assert tuple(int(x) for x in g) == tuple(int(x) for x in r), f
        else:
            assert int(g) == int(r), f
    assert got.clip_tile_capacity == 0 and got.clip_round_demand == ()
    assert not got.overflowed()


def test_vis_clip_frame_meets_golden():
    """The port's own stress scene on the visibility-buffer branch against
    tests/goldens/stress.png (the reference's render of this branch)."""
    scene, dl, flags = build_stress_scene(grid=3).finish_bundle(device="cpu")
    rig = _rig(*CAM)
    params = make_frame_params(CFG, rig.camera.view_matrix(), rig.camera.position,
                               rig.sun_dir(), device="cpu")
    lights = pack_lights([point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)], device="cpu")
    img = render_frame(scene, dl, params, lights, CFG, flags=flags)
    golden = read_png(os.path.join(GOLDEN_DIR, "stress.png"))[..., :3] / 255.0
    rmse = float(np.sqrt(np.mean((linear_to_srgb(img.numpy()) - golden) ** 2)))
    print(f"sRGB RMSE vs stress.png {rmse:.3g}")
    assert rmse < 4e-3


@pytest.mark.slow
def test_stress_vis_hd_diagnostics_are_the_references():
    """chip_smoke.py's STRESS_VIS_DIAGNOSTICS are the reference's own for
    its 1080p stress frame on the visibility-buffer branch (the bench's
    config, camera and lights: tests/goldens/stress_hd.png's render)."""
    from transmission_renderer_tpu import config as jconfig
    from transmission_renderer_tpu.scene.camera import CameraRig as JRig

    path = os.path.join(os.path.dirname(GOLDEN_DIR), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = jconfig.RenderConfig(width=1920, height=1080, opaque_block_cap_frac=0.8125)
    scene, dl, flags = jstress().finish_bundle()
    rig = JRig()  # the CameraRig's default sun, as the bench's
    rig.camera.position = np.array([0.0, 2.2, 1.5], np.float32)
    rig.camera.pitch = -0.25
    params = jframe.make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                                      rig.sun_dir())
    lights = jpack([jpoint([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0),
                    jpoint([8.0, 0.8, 0.0], [0.0, 1.0, 0.0], 10.0)])
    _, diag = jax.jit(partial(jframe.render_frame, config=cfg, flags=flags,
                              return_diagnostics=True))(scene, dl, params, lights)
    assert smoke.diagnostics_dict(_np(diag)) == smoke.STRESS_VIS_DIAGNOSTICS


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------

def _fragments(n_clip: int = 240, n_other: int = 80, seed: int = 3):
    """Numpy-seeded fragments of the stress scene at CFG: covered pixels of
    clip-bucket triangles and of others -> (port scene, draw list, uvs,
    setup, tri [N], nx, ny)."""
    scene, dl, _ = build_stress_scene(grid=3).finish_bundle(device="cpu")
    rig = _rig(*CAM)
    params = make_frame_params(CFG, rig.camera.view_matrix(), rig.camera.position,
                               rig.sun_dir(), device="cpu")
    _, _, uvs, clip, _ = transform_vertices(scene, dl, params.proj_view)
    t = dl.tri_vtx.shape[0]
    setup = setup_triangles(clip, dl.tri_vtx, torch.ones(t, dtype=torch.bool), CFG.width,
                            CFG.height, CFG.tile_w, CFG.tile_h)
    px = torch.arange(CFG.width, dtype=torch.float32) + 0.5
    py = torch.arange(CFG.height, dtype=torch.float32) + 0.5
    nx = (px * (2.0 / CFG.width) - 1.0)[None, :].expand(CFG.height, -1).reshape(-1)
    ny = (py * (2.0 / CFG.height) - 1.0)[:, None].expand(-1, CFG.width).reshape(-1)
    adj = setup.adj.reshape(t, 9)
    is_clip = ((dl.tri_bucket == BUCKET_ALPHA_CLIP)
               | (dl.tri_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP))
    pools = ([], [])
    for tri in torch.nonzero(setup.valid)[:, 0].tolist():
        f = lambda i: adj[tri, i]  # noqa: E731
        e = raster_vis._edges(f, nx, ny)
        cov = torch.nonzero(raster_vis._covered(e[0], f(0), f(1))
                            & raster_vis._covered(e[1], f(3), f(4))
                            & raster_vis._covered(e[2], f(6), f(7)))[:, 0]
        pools[0 if bool(is_clip[tri]) else 1].extend((tri, int(p)) for p in cov)
    rng = np.random.default_rng(seed)
    picks = [pools[0][i] for i in rng.choice(len(pools[0]), n_clip, replace=False)]
    picks += [pools[1][i] for i in rng.choice(len(pools[1]), n_other, replace=False)]
    tri = torch.tensor([p[0] for p in picks])
    pix = torch.tensor([p[1] for p in picks])
    return scene, dl, uvs, setup, tri, nx[pix], ny[pix]


def test_alpha_test_matches_make_alpha_fn():
    """alpha_keep's decisions equal the reference's alpha_fn's on seeded
    fragments (clip-bucket and other triangles), at the scene's cutoffs
    and with each fragment's cutoff moved to within 1e-6 of its alpha
    (both sides of it), which bounds the two alphas' difference below
    5e-7."""
    scene, dl, uvs, setup, tri, nx, ny = _fragments()
    alpha = vis_alpha(scene, dl, uvs)
    rec = raster_vis.pack_payload(setup)[tri]
    f = lambda i: rec[:, i]  # noqa: E731
    e = raster_vis._edges(f, nx, ny)
    clip, value, cutoff = raster_vis.alpha_test(alpha, f, e, CFG.width, CFG.height)
    assert 200 <= int(clip.sum()) < tri.numel()
    keep = raster_vis.alpha_keep(alpha, f, e, CFG.width, CFG.height)
    assert (~keep).any() and keep[clip].any()

    jscene, jdl, _ = jstress(grid=3).finish_bundle()
    adj = jnp.asarray(setup.adj.numpy()[tri.numpy()])

    def ref_keep(cut, tri, nx, ny, adj):
        """_make_alpha_fn with every material's cutoff at ``cut`` (None: the
        scene's own)."""
        sc = jscene
        if cut is not None:
            m = jscene.materials
            sc = jscene._replace(materials=m._replace(
                alpha_clipping_cutoff=jnp.full_like(m.alpha_clipping_cutoff, cut)))
        fn = jframe._make_alpha_fn(sc, jdl, jnp.asarray(uvs.numpy()), CFG.width, CFG.height)
        return fn(tri, 0.0, 0.0, nx, ny, adj)

    args = (jnp.asarray(tri.numpy()), jnp.asarray(nx.numpy()), jnp.asarray(ny.numpy()), adj)
    own = np.asarray(jax.jit(jax.vmap(partial(ref_keep, None)))(*args))
    np.testing.assert_array_equal(keep.numpy(), own)
    ref = jax.jit(jax.vmap(ref_keep))
    for offset in (-1e-6, -5e-7, 5e-7, 1e-6):
        cut = value + offset
        got = ~clip | (value >= cut)  # alpha_keep's rule at these cutoffs
        np.testing.assert_array_equal(got[clip].numpy(), np.full(int(clip.sum()), offset < 0))
        np.testing.assert_array_equal(np.asarray(ref(jnp.asarray(cut.numpy()), *args)),
                                      got.numpy(), err_msg=f"cutoff = alpha {offset:+g}")


def test_raster_vis_alpha_segmented_equals_sequential(frames):
    """The plain raster with alpha gives the same bits sequentially and in
    kernel 6's segments (ties across segments included), on both of the
    frame's calls."""
    _, _, _, calls = frames
    for args, kw in calls:
        whole = raster_vis.raster_vis_plain(*args, **kw)
        for seg in (1, 7, raster_vis.SEG):
            part = raster_vis.raster_vis_plain(*args, **kw, segment=seg)
            assert torch.equal(whole[0], part[0]), seg
            for a, b in zip(whole[1:], part[1:]):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32)), seg


def test_alpha_needs_xla_order(frames):
    """Kernel-6 order (the reference's Pallas raster) has no alpha test."""
    _, _, _, calls = frames
    args, kw = calls[0]
    with pytest.raises(ValueError, match="XLA-raster order"):
        raster_vis.raster_vis_plain(*args, **dict(kw, xla_order=False))
