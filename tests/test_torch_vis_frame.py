"""The port's visibility-buffer frame vs the JAX package's.

Both packages render the small dragon golden scene on the CPU down the
reference's visibility-buffer branch (``render_frame`` with config auto
on a CPU backend: materialised bins, the pure raster, interpolate_gbuffer,
the XLA shade), at tests/golden_defs.py::CFG (128x72, 32x8 tiles) and at
200x120 (a width that is not a multiple of 128), the port from the
reference's own arrays (bridge.from_jax_arrays) through kernel 6's plain
version and its tensor shading path.

Tolerances: the raster is bit-exact (tests/test_torch_raster_vis.py), so
what differs is float32 rounding in the G-buffer and shading sums, which
the reference's compiler contracts into fused multiply-adds: HDR and LDR
within atol 1e-4 / rtol 1e-4 on all but 0.1% of the values (a texel
footprint can round to its neighbour on the checkerboard), linear LDR
RMSE < 1e-4, every diagnostic equal. Against tests/goldens/dragon.png the
port's own scene holds tests/test_goldens.py's sRGB RMSE < 4e-3.

Unit parity on the textured helmet analogue (normal maps, 4-layer
bundles) and the dragon: interpolate_gbuffer (atol 1e-5 / rtol 1e-4),
_evaluate_pixel_material and _evaluate_lights_common (atol 1e-5 /
rtol 1e-4) and ibl_volume_refraction (atol 1e-6 / rtol 1e-5) on the same
inputs.

At the 1080p golden's config (golden_defs.CFG_HD, the frame
tests/test_torch_card_hd.py renders on the card): the binning-decided
diagnostics that card_defs.py pins (HD_VIS_DIAGNOSTICS) are recomputed from the
reference's own binning and the port's; the ``slow`` test renders the
whole frame through both packages and holds every diagnostic and the
golden dragon_hd.png (sRGB RMSE < 4e-3 over the whole frame)."""

import dataclasses
import functools
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from card_defs import HD_VIS_DIAGNOSTICS, diagnostics_dict
from golden_defs import CFG, CFG_HD, GOLDEN_DIR, _dragon, _lights, _rig
from pixel_box_defs import pixel_box
from transmission_renderer_tpu.config import (
    BUCKET_ALPHA_CLIP,
    BUCKET_OPAQUE,
    BUCKET_TRANSMISSION,
    BUCKET_TRANSMISSION_ALPHA_CLIP,
)
from transmission_renderer_tpu.models import build_dragon_scene as jdragon
from transmission_renderer_tpu.models import build_opaque_scene
from transmission_renderer_tpu.ops import cull as jcull
from transmission_renderer_tpu.ops import raster as jraster
from transmission_renderer_tpu.pbr import brdf as jbrdf
from transmission_renderer_tpu.pbr.clustering import assign_lights_to_clusters
from transmission_renderer_tpu.pbr.lights import pack_lights as jpack
from transmission_renderer_tpu.pbr.lights import point_light as jpoint
from transmission_renderer_tpu.render import frame as jframe
from transmission_renderer_tpu.render import gbuffer as jgbuffer
from transmission_renderer_tpu.render import shading as jshading
from transmission_renderer_tpu.scene.types import Similarity, quat_rotate, similarity_apply
from transmission_renderer_tpu.utils.ggx_lut import default_ggx_lut
from transmission_renderer_tpu.utils.platform import f32_matmuls
from transmission_renderer_tpu_torch import bridge
from transmission_renderer_tpu_torch.models.procedural import build_dragon_scene
from transmission_renderer_tpu_torch.ops import raster
from transmission_renderer_tpu_torch.ops.raster import TriangleSetup
from transmission_renderer_tpu_torch.pbr import brdf
from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
from transmission_renderer_tpu_torch.render import gbuffer, shading
from transmission_renderer_tpu_torch.render.frame import make_frame_params, render_frame
from transmission_renderer_tpu_torch.scene.textures import linear_to_srgb
from transmission_renderer_tpu_torch.utils.png import read_png

# torch runs single-threaded here: the suite runs in several worker
# processes at once, and oversubscribed OpenMP threads stall each other
torch.set_num_threads(1)

CAM = ((0.0, 2.2, 1.5), -0.25)
SIZES = {"128x72": CFG, "200x120": dataclasses.replace(CFG, width=200, height=120)}


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module", params=sorted(SIZES))
def frames(request):
    """(reference image, HDR, diagnostics; the port's from the same arrays)."""
    cfg = SIZES[request.param]
    scene, dl, flags = _dragon().finish_bundle()
    rig = _rig(*CAM)
    params = jframe.make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                                      rig.sun_dir())
    lights = _lights()
    ref = jax.jit(partial(jframe.render_frame, config=cfg, flags=flags, return_hdr=True,
                          return_diagnostics=True))(scene, dl, params, lights)
    inputs = bridge.from_jax_arrays(_np(scene), _np(dl), _np(params), _np(lights), flags,
                                    device="cpu")
    got = render_frame(*inputs[:4], cfg, flags=inputs[4], return_hdr=True,
                       return_diagnostics=True)
    return _np(ref), got


def test_vis_frame_matches_reference(frames):
    (ref_img, ref_hdr, _), (img, hdr, _) = frames
    assert img.shape == ref_img.shape
    assert bool(torch.isfinite(img).all()) and 0.0 <= float(img.min()) <= float(img.max()) <= 1.0
    for got, ref in ((hdr.numpy(), ref_hdr), (img.numpy(), ref_img)):
        bad = ~np.isclose(got, ref, atol=1e-4, rtol=1e-4)
        assert bad.sum() <= 1e-3 * bad.size, (int(bad.sum()), float(np.abs(got - ref).max()))
    rmse = float(np.sqrt(np.mean((img.numpy() - ref_img) ** 2)))
    print(f"linear LDR RMSE {rmse:.3g}, max abs {np.abs(img.numpy() - ref_img).max():.3g}")
    assert rmse < 1e-4


def test_vis_frame_diagnostics_match_reference(frames):
    (_, _, ref), (_, _, got) = frames
    assert got._fields == ref._fields
    for f in ref._fields:
        r, g = getattr(ref, f), getattr(got, f)
        if isinstance(r, tuple):
            assert tuple(int(x) for x in g) == tuple(int(x) for x in r), f
        else:
            assert int(g) == int(r), f
    assert got.overflowed() == ref.overflowed()
    assert int(got.transmission_blocks) > 0 and got.bin_capacity == CFG.max_tris_per_tile


def test_vis_frame_matches_golden():
    """The port's own scene and params (no bridge) on its default CPU
    branch against tests/goldens/dragon.png."""
    scene, dl, flags = build_dragon_scene(stacks=40, sectors=80).finish_bundle(device="cpu")
    rig = _rig(*CAM)
    params = make_frame_params(CFG, rig.camera.view_matrix(), rig.camera.position,
                               rig.sun_dir(), device="cpu")
    lights = pack_lights([point_light([0.0, 0.8, 0.0], [1, 0, 0], 5.0)], device="cpu")
    img, diag = render_frame(scene, dl, params, lights, CFG, flags=flags, return_diagnostics=True)
    assert not diag.overflowed() and diag.transmission_tiles == 0  # the vis branch
    golden = read_png(os.path.join(GOLDEN_DIR, "dragon.png"))[..., :3] / 255.0
    rmse = float(np.sqrt(np.mean((linear_to_srgb(img.numpy()) - golden) ** 2)))
    assert rmse < 4e-3, rmse


# ---------------------------------------------------------------------------
# unit parity
# ---------------------------------------------------------------------------

def _scene(name):
    if name == "helmet":
        return build_opaque_scene(stacks=12, sectors=24, texture_size=64)
    return _dragon()


@functools.lru_cache(maxsize=None)
def _units(name):
    """The reference's opaque visibility buffer, setup, G-buffer and
    shading context on a scene at CFG; the port's bridged copies."""
    cfg = CFG
    scene, dl, flags = _scene(name).finish_bundle()
    rig = _rig(*CAM)
    params = jframe.make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                                      rig.sun_dir())
    lights = jpack([jpoint([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0),
                    jpoint([1.0, 0.5, -1.0], [0.0, 1.0, 0.0], 2.0),
                    dict(jpoint([-1.0, 2.5, -3.0], [0.3, 0.4, 1.0], 14.0),
                         spot_epsilon=np.float32(np.cos(0.3) - np.cos(0.7)),
                         spot_direction=np.array([0.3, -1.0, -0.2], np.float32),
                         spot_outer_angle=np.float32(0.7))])

    @jax.jit
    def raster(scene, dl, params):
        inst_t = Similarity(*(a[dl.vtx_inst] for a in scene.inst_transform))
        world = similarity_apply(inst_t, scene.positions[dl.vtx_src])
        nrm = quat_rotate(inst_t.rotation, scene.normals[dl.vtx_src])
        uvs = scene.uvs[dl.vtx_src]
        clip = jnp.concatenate([world, jnp.ones_like(world[:, :1])], -1) @ params.proj_view.T
        vis = jcull.cull_instances(scene, params.view, params.frustum_x_xz,
                                   params.frustum_y_yz, cfg.z_near)
        mask = jcull.bucket_triangle_masks(dl.tri_inst, dl.tri_bucket, vis,
                                           (BUCKET_OPAQUE, BUCKET_ALPHA_CLIP))
        setup = jraster.setup_triangles(clip, dl.tri_vtx, mask, cfg.width, cfg.height,
                                        cfg.tile_w, cfg.tile_h)
        bins = jraster.bin_triangles(setup, cfg.tiles_x, cfg.tiles_y, cfg.max_tiles_per_tri,
                                     cfg.max_tris_per_tile, cfg.max_big_tris)
        vbuf = jraster.rasterize(setup, bins, cfg.width, cfg.height, cfg.tile_w, cfg.tile_h)
        scale = scene.inst_transform.scale[dl.tri_inst]
        g = jgbuffer.interpolate_gbuffer(vbuf, setup, dl.tri_vtx, dl.tri_material, scale,
                                         world, nrm, uvs, cfg.width, cfg.height)
        return vbuf, setup, g, (world, nrm, uvs, scale), clip

    vbuf, setup, g, attrs, clip = raster(scene, dl, params)
    coeffs, amin, amax = jframe._static_cluster_data(cfg)
    lp_h = jnp.concatenate([lights.position, jnp.ones_like(lights.position[:, :1])], -1)
    counts, indices = assign_lights_to_clusters(
        amin, amax, (lp_h @ params.view.T)[:, :3], lights.falloff_distance_sq,
        lights.is_a_spotlight(), lights.spot_direction @ params.view[:3, :3].T,
        lights.spot_outer_angle, cfg.max_lights_per_cluster)
    lut = jnp.asarray(default_ggx_lut(cfg.ggx_lut_size))
    jctx = jshading.ShadeContext(
        view_position=params.view_position, proj_view=params.proj_view,
        sun_dir=params.sun_dir, sun_intensity=params.sun_intensity,
        framebuffer_size=(cfg.width, cfg.height),
        cluster_size_in_pixels=cfg.cluster_size_in_pixels,
        num_clusters_xy=(cfg.num_clusters_x, cfg.num_clusters_y), cluster_coeffs=coeffs,
        cluster_light_counts=counts, cluster_light_indices=indices, lights=lights,
        ggx_lut=lut, tex_slots=flags.tex_slots,
        mat_matrix=jshading.build_material_matrix(scene, flags.tex_slots, flags.slot_bundles))
    pscene, _, pparams, plights, pflags = bridge.from_jax_arrays(
        _np(scene), _np(dl), _np(params), _np(lights), flags, device="cpu")
    pctx = shading.ShadeContext(
        view_position=pparams.view_position, proj_view=pparams.proj_view,
        sun_dir=pparams.sun_dir, sun_intensity=pparams.sun_intensity,
        framebuffer_size=(cfg.width, cfg.height),
        cluster_size_in_pixels=cfg.cluster_size_in_pixels,
        num_clusters_xy=(cfg.num_clusters_x, cfg.num_clusters_y), cluster_coeffs=coeffs,
        cluster_light_counts=torch.from_numpy(np.asarray(counts).astype(np.int32)),
        cluster_light_indices=torch.from_numpy(np.asarray(indices).astype(np.int32)),
        lights=plights, ggx_lut=torch.from_numpy(np.asarray(lut)),
        tex_slots=pflags.tex_slots,
        mat_matrix=shading.build_material_matrix(pscene, pflags.tex_slots,
                                                 pflags.slot_bundles))
    return dict(scene=scene, flags=flags, vbuf=vbuf, setup=setup, g=g, attrs=attrs,
                clip=clip, dl=dl, jctx=jctx, pscene=pscene, pctx=pctx)


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(g):
    """Reference [H, W] G-buffer -> (its flat form, the port's flat copy)."""
    jflat = jshading.flatten_gbuffer(g)
    return jflat, gbuffer.GBuffer(*(_t(a) for a in jflat))


def _close(got, ref, atol, rtol, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("name", ["dragon", "helmet"])
def test_interpolate_gbuffer_matches_reference(name):
    u = _units(name)
    world, nrm, uvs, scale = (_t(a) for a in u["attrs"])
    # the reference's set-up has no pixel box: the port's is computed alike
    box = pixel_box(np.asarray(u["clip"]), np.asarray(u["dl"].tri_vtx), CFG.width, CFG.height)
    psetup = TriangleSetup(*(_t(a) for a in u["setup"]), torch.from_numpy(box))
    got = gbuffer.interpolate_gbuffer(bridge.vis_buffer(u["vbuf"], device="cpu"), psetup,
                                      _t(u["dl"].tri_vtx), _t(u["dl"].tri_material), scale,
                                      world, nrm, uvs, CFG.width, CFG.height)
    assert int(got.valid.sum()) > 1000
    for f in got._fields:
        _close(getattr(got, f), getattr(u["g"], f), 1e-5, 1e-4, f)


@pytest.mark.parametrize("name", ["dragon", "helmet"])
def test_evaluate_pixel_material_matches_reference(name):
    u = _units(name)
    jflat, pflat = _flat(u["g"])
    tex_slots = u["flags"].tex_slots
    ref = jshading._evaluate_pixel_material(u["scene"], jflat, tex_slots,
                                            mat_matrix=u["jctx"].mat_matrix)
    got = shading._evaluate_pixel_material(u["pscene"], pflat, tex_slots,
                                           mat_matrix=u["pctx"].mat_matrix)
    if name == "helmet":  # normal map, metallic-roughness and emission taps run
        assert tex_slots[2] and tex_slots[1] and tex_slots[3]
    for f in ref.params._fields:
        _close(getattr(got.params, f), getattr(ref.params, f), 1e-5, 1e-4, f)
    for f in ref._fields[1:]:
        _close(getattr(got, f), getattr(ref, f), 1e-5, 1e-4, f)


@pytest.mark.parametrize("with_transmission", [False, True])
@pytest.mark.parametrize("name", ["dragon", "helmet"])
def test_evaluate_lights_common_matches_reference(name, with_transmission):
    u = _units(name)
    jflat, pflat = _flat(u["g"])
    h, w = CFG.height, CFG.width
    jpx, jpy = jshading._dense_coords(h, w)
    ppx, ppy = shading._dense_coords(h, w, "cpu")
    jm = jshading._evaluate_pixel_material(u["scene"], jflat, u["flags"].tex_slots,
                                           mat_matrix=u["jctx"].mat_matrix)
    jview = jflat.position - u["jctx"].view_position
    jview = -jview / jnp.maximum(jnp.linalg.norm(jview, axis=-1, keepdims=True), 1e-12)
    pview = _t(jview)
    ref = jax.jit(lambda m, v, p, n, d: jshading._evaluate_lights_common(
        u["jctx"], m, v, p, n, d, jpx, jpy, with_transmission))(
            jm.params, jview, jflat.position, jm.normal, jflat.depth)
    got = shading._evaluate_lights_common(
        u["pctx"], brdf.MaterialParams(*(_t(a) for a in jm.params)), pview,
        pflat.position, _t(jm.normal), pflat.depth, ppx, ppy, with_transmission)
    valid = np.asarray(jflat.valid)
    assert int(np.asarray(ref[3])[valid].max()) >= 2  # pixels lit by 2+ cluster lights
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    for what, g, r in (("diffuse", got[0].diffuse, ref[0].diffuse),
                       ("specular", got[0].specular, ref[0].specular)):
        _close(g[valid], np.asarray(r)[valid], 1e-5, 1e-4, what)
    if with_transmission:
        _close(got[1][valid], np.asarray(ref[1])[valid], 1e-5, 1e-4, "transmission")
    else:
        assert got[1] is None and ref[1] is None


def test_ibl_volume_refraction_matches_reference():
    """Random unit normals and views, materials and thicknesses; both
    sides sample the same analytic framebuffer and LUT functions."""
    rng = np.random.default_rng(8)
    m = 4096

    def unit(n):
        v = rng.normal(size=(n, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    normal = unit(m)
    view = unit(m)
    view = np.where((np.sum(normal * view, 1) < 0)[:, None], -view, view)  # front-facing
    mat = dict(diffuse_colour=rng.uniform(0, 1, (m, 3)), metallic=rng.uniform(0, 1, m),
               perceptual_roughness=rng.uniform(0, 1, m),
               index_of_refraction=rng.uniform(1.0, 2.0, m),
               specular_colour=rng.uniform(0, 1, (m, 3)), specular_factor=rng.uniform(0, 1, m))
    mat = {k: v.astype(np.float32) for k, v in mat.items()}
    # a projection whose w stays near 1 over the exit points
    pv = (np.eye(4) + 0.1 * rng.normal(size=(4, 4))).astype(np.float32)
    pos = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
    thick = rng.uniform(0, 0.5, m).astype(np.float32)
    scale = rng.uniform(0.5, 2, m).astype(np.float32)
    att_d = np.where(rng.uniform(size=m) < 0.3, np.inf, rng.uniform(0.1, 3, m)).astype(np.float32)
    att_c = rng.uniform(0.05, 1, (m, 3)).astype(np.float32)

    def fb(uv, lod, xp):
        return xp.stack([uv[..., 0] * 0.5 + 0.25, uv[..., 1] * uv[..., 0], lod * 0.1], -1)

    def lut(nov, rough, xp):
        return xp.stack([nov * 0.5 + 0.25, rough * 0.3 + 0.1], -1)

    ref = jbrdf.ibl_volume_refraction(
        jbrdf.MaterialParams(**{k: jnp.asarray(v) for k, v in mat.items()}), jnp.float32(200.0),
        jnp.asarray(normal), jnp.asarray(view), jnp.asarray(pv), jnp.asarray(pos),
        jnp.asarray(thick), jnp.asarray(scale), jnp.asarray(att_d), jnp.asarray(att_c),
        partial(fb, xp=jnp), partial(lut, xp=jnp))
    got = brdf.ibl_volume_refraction(
        brdf.MaterialParams(**{k: _t(v) for k, v in mat.items()}), 200, _t(normal), _t(view),
        _t(pv), _t(pos), _t(thick), _t(scale), _t(att_d), _t(att_c),
        partial(fb, xp=torch), partial(lut, xp=torch))
    assert np.isfinite(np.asarray(ref)).all()
    _close(got, ref, 1e-6, 1e-5, "ibl_volume_refraction")


# ---------------------------------------------------------------------------
# the 1080p golden's config
# ---------------------------------------------------------------------------

def _hd_inputs():
    """The golden's scene, params and lights in the reference."""
    scene, dl, flags = jdragon(roughness_override=0.25).finish_bundle()
    rig = _rig(*CAM)
    rig.sun_yaw = 4.8
    params = jframe.make_frame_params(CFG_HD, rig.camera.view_matrix(), rig.camera.position,
                                      rig.sun_dir())
    lights = jpack([jpoint([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0),
                    jpoint([8.0, 0.8, 0.0], [0.0, 1.0, 0.0], 10.0)])
    return scene, dl, flags, params, lights


def test_hd_vis_binning_diagnostics_are_the_references():
    """max_bin_count, big_tri_count and the capacities that card_defs.py
    pins for the 1080p visibility-buffer frame are what the reference's
    materialised binning gives per pass (the frame reports the larger of
    its two passes), and the port's binning of the same clip coordinates
    gives the same per-tile counts, lists and big lists."""
    cfg = CFG_HD
    scene, dl, _, params, _ = _hd_inputs()

    @jax.jit
    @f32_matmuls
    def passes(scene, dl, params):
        inst_t = Similarity(*(a[dl.vtx_inst] for a in scene.inst_transform))
        world = similarity_apply(inst_t, scene.positions[dl.vtx_src])
        clip = jnp.concatenate([world, jnp.ones_like(world[:, :1])], -1) @ params.proj_view.T
        vis = jcull.cull_instances(scene, params.view, params.frustum_x_xz,
                                   params.frustum_y_yz, cfg.z_near)
        out = []
        for buckets in ((BUCKET_OPAQUE, BUCKET_ALPHA_CLIP),
                        (BUCKET_TRANSMISSION, BUCKET_TRANSMISSION_ALPHA_CLIP)):
            mask = jcull.bucket_triangle_masks(dl.tri_inst, dl.tri_bucket, vis, buckets)
            setup = jraster.setup_triangles(clip, dl.tri_vtx, mask, cfg.width, cfg.height,
                                            cfg.tile_w, cfg.tile_h)
            out.append((mask, jraster.bin_triangles(
                setup, cfg.tiles_x, cfg.tiles_y, cfg.max_tiles_per_tri,
                cfg.max_tris_per_tile, cfg.max_big_tris)))
        return clip, out

    clip, out = _np(passes(scene, dl, params))
    pinned = HD_VIS_DIAGNOSTICS
    assert pinned["bin_capacity"] == cfg.max_tris_per_tile
    assert pinned["big_tri_capacity"] == cfg.max_big_tris
    assert pinned["max_bin_count"] == max(int(b.max_bin_count) for _, b in out)
    assert pinned["big_tri_count"] == max(int(b.big_tri_count) for _, b in out)
    assert pinned["max_bin_count"] > pinned["bin_capacity"]  # overflowed()
    for mask, ref in out:
        setup = raster.setup_triangles(_t(clip), _t(dl.tri_vtx), _t(mask), cfg.width,
                                       cfg.height, cfg.tile_w, cfg.tile_h)
        got = raster.bin_triangles_materialized(setup, cfg.tiles_x, cfg.tiles_y,
                                                cfg.max_tiles_per_tri, cfg.max_tris_per_tile,
                                                cfg.max_big_tris)
        for f in ("tile_tri_count", "tile_tri_ids", "big_tri_ids", "big_tri_count",
                  "max_bin_count"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                          err_msg=f)


@pytest.mark.slow
def test_hd_vis_frame_matches_reference_and_golden():
    """The whole 1080p frame on both packages' visibility-buffer branch:
    every diagnostic of each equals card_defs.py's pinned values, the
    port's image is within linear LDR RMSE 1e-3 of the reference's, and
    within sRGB RMSE 4e-3 of dragon_hd.png over the whole frame (the
    golden's dropped triangles are dropped by the port too)."""
    scene, dl, flags, params, lights = _hd_inputs()
    ref, ref_diag = jax.jit(partial(jframe.render_frame, config=CFG_HD, flags=flags,
                                    return_diagnostics=True))(scene, dl, params, lights)
    inputs = bridge.from_jax_arrays(_np(scene), _np(dl), _np(params), _np(lights), flags,
                                    device="cpu")
    img, diag = render_frame(*inputs[:4], CFG_HD, flags=inputs[4], return_diagnostics=True)
    assert diagnostics_dict(_np(ref_diag)) == HD_VIS_DIAGNOSTICS
    assert diagnostics_dict(diag) == HD_VIS_DIAGNOSTICS
    assert diag.overflowed()
    img = img.numpy()
    ref_rmse = float(np.sqrt(np.mean((img - np.asarray(ref)) ** 2)))
    golden = read_png(os.path.join(GOLDEN_DIR, "dragon_hd.png"))[..., :3] / 255.0
    rmse = float(np.sqrt(np.mean((linear_to_srgb(img) - golden) ** 2)))
    print(f"1080p visibility-buffer frame: linear LDR RMSE {ref_rmse:.4g} against the "
          f"reference, sRGB RMSE {rmse:.4g} against dragon_hd.png")
    assert ref_rmse < 1e-3
    assert rmse < 4e-3, rmse
