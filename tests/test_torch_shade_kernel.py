"""Port fused shade (kernel 3's plain version) vs the JAX package's
shade kernel in interpret mode, on 256x64 G-buffers of three scenes: the
small dragon (the flagship's material set, transmission), the helmet
analogue (a 4-layer texture bundle, normal mapping, emission) and the
bindless scene under 20 lights (mixed-image bundles, many materials, the
reference kernel's many-light mask mode, which it takes above 16 lights).

The reference rasterises each scene with its G-buffer kernel, builds the
shading context as render_frame does, and shades it with
shade_opaque_pallas_planes and shade_transmission_pallas_pre
(interpret=True, jitted as in the frame).
The same G-buffer, cluster lists, lights and material-tap samples cross
to the port through the bridge. Tolerance: atol 1e-5 on all but at most
0.05% of the pixels — the reference's compiler fuses multiply-adds in
the BRDF chains, and a transcendental ulp can move a cluster-boundary
pixel to its neighbouring z-slice (shade_kernel.py:30-34); the test
prints that count."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmission_renderer_tpu.config import (
    BUCKET_OPAQUE, BUCKET_TRANSMISSION, RenderConfig)
from transmission_renderer_tpu.models.procedural import (
    bindless_lights, build_bindless_scene, build_dragon_scene, build_opaque_scene)
from transmission_renderer_tpu.ops import cull as jcull
from transmission_renderer_tpu.ops import raster as jraster
from transmission_renderer_tpu.ops import raster_pallas_gbuf as jgbuf
from transmission_renderer_tpu.pbr.clustering import assign_lights_to_clusters
from transmission_renderer_tpu.pbr.lights import pack_lights, point_light, spot_light
from transmission_renderer_tpu.render import frame as jframe
from transmission_renderer_tpu.render import shade_kernel as jshade
from transmission_renderer_tpu.render import shading as jshading
from transmission_renderer_tpu.scene.camera import CameraRig
from transmission_renderer_tpu.scene.types import Similarity, quat_rotate, similarity_apply
from transmission_renderer_tpu.utils.ggx_lut import default_ggx_lut
from transmission_renderer_tpu_torch import bridge
from transmission_renderer_tpu_torch.render import shade_kernel, shading

# torch runs single-threaded here: the suite runs in several worker
# processes at once, and oversubscribed OpenMP threads stall each other
torch.set_num_threads(1)

W, H = 256, 64
ATOL = 1e-5
MAX_BAD_FRAC = 5e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _three_lights():
    return [
        point_light([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0),
        point_light([8.0, 0.8, 0.0], [0.0, 1.0, 0.0], 10.0),
        spot_light([-1.0, 2.5, -3.0], [0.3, 0.4, 1.0], 14.0,
                   [0.3, -1.0, -0.2], 0.3, 0.7),
    ]


# name -> (scene builder, camera position, pitch, lights)
SCENES = {
    "dragon": (lambda: build_dragon_scene(stacks=40, sectors=80),
               (0.0, 2.2, 1.5), -0.25, _three_lights),
    "helmet": (lambda: build_opaque_scene(stacks=12, sectors=24, texture_size=64),
               (0.0, 2.2, 1.5), -0.25, _three_lights),
    "bindless": (lambda: build_bindless_scene(grid=5, n_images=48),
                 (0.0, 4.0, 3.0), -0.6, lambda: bindless_lights(20)),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """Reference G-buffers + shading context, and the port's bridged copy."""
    cfg = RenderConfig(width=W, height=H, use_pallas_raster=True,
                       pallas_interpret=True)
    builder, cam, pitch, light_list = SCENES[name]
    scene, dl, flags = builder().finish_bundle()
    rig = CameraRig()
    rig.camera.position = np.array(cam, np.float32)
    rig.camera.pitch = pitch
    params = jframe.make_frame_params(cfg, rig.camera.view_matrix(),
                                      rig.camera.position, rig.sun_dir())
    lights = pack_lights(light_list())

    @jax.jit
    def raster(scene, dl, params):
        # the frame's geometry + binning + raster (frame.py:984-1150)
        inst_t = Similarity(*(a[dl.vtx_inst] for a in scene.inst_transform))
        world = similarity_apply(inst_t, scene.positions[dl.vtx_src])
        nrm = quat_rotate(inst_t.rotation, scene.normals[dl.vtx_src])
        uvs = scene.uvs[dl.vtx_src]
        clip = jnp.concatenate([world, jnp.ones_like(world[:, :1])], -1) @ params.proj_view.T
        vis = jcull.cull_instances(scene, params.view, params.frustum_x_xz,
                                   params.frustum_y_yz, cfg.z_near)
        mask = jcull.bucket_triangle_masks(dl.tri_inst, dl.tri_bucket, vis,
                                           (BUCKET_OPAQUE, BUCKET_TRANSMISSION))
        cls = (dl.tri_bucket == BUCKET_TRANSMISSION).astype(jnp.int32)
        setup = jraster.setup_triangles(clip, dl.tri_vtx, mask, W, H, 128, 8)
        bins = jraster.bin_triangles(
            setup, 2, 8, cfg.pallas_tiles_per_tri, 2048, 32, materialize=False,
            class_flags=cls, num_classes=2, mid_tile_cap=128, max_mid_tris=512,
            tiers=cfg.pallas_tiers)
        rec = jgbuf.pack_gbuf_payload(
            setup, dl.tri_vtx, dl.tri_material,
            scene.inst_transform.scale[dl.tri_inst], world, nrm, uvs, cls)
        payload = jgbuf.gather_gbuf_payload(rec, bins)
        g_o = jgbuf.rasterize_gbuffer_pallas(rec, bins, W, H, pass_class=0,
                                             payload=payload, interpret=True)
        g_t = jgbuf.rasterize_gbuffer_pallas(
            rec, bins, W, H, pass_class=1, payload=payload, init_depth=g_o.depth,
            interpret=True, pos_derivs=False, uv_channels=False)
        return g_o, g_t

    g_o, g_t = raster(scene, dl, params)
    coeffs, aabb_min, aabb_max = jframe._static_cluster_data(cfg)
    lp_h = jnp.concatenate([lights.position, jnp.ones_like(lights.position[:, :1])], -1)
    counts, indices = assign_lights_to_clusters(
        aabb_min, aabb_max, (lp_h @ params.view.T)[:, :3], lights.falloff_distance_sq,
        lights.is_a_spotlight(), lights.spot_direction @ params.view[:3, :3].T,
        lights.spot_outer_angle, cfg.max_lights_per_cluster)
    lut = jnp.asarray(default_ggx_lut(cfg.ggx_lut_size))
    jctx = jshading.ShadeContext(
        view_position=params.view_position, proj_view=params.proj_view,
        sun_dir=params.sun_dir, sun_intensity=params.sun_intensity,
        framebuffer_size=(W, H), cluster_size_in_pixels=cfg.cluster_size_in_pixels,
        num_clusters_xy=(cfg.num_clusters_x, cfg.num_clusters_y),
        cluster_coeffs=coeffs, cluster_light_counts=counts,
        cluster_light_indices=indices, lights=lights, ggx_lut=lut,
        tex_slots=flags.tex_slots,
        mat_matrix=jshading.build_material_matrix(scene, flags.tex_slots,
                                                  flags.slot_bundles),
        pallas_shade=True, pallas_interpret=True,
    )
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    pscene, _, pparams, plights, pflags = bridge.from_jax_arrays(
        as_np(scene), as_np(dl), as_np(params), as_np(lights), flags, device="cpu")
    pctx = shading.ShadeContext(
        view_position=pparams.view_position, proj_view=pparams.proj_view,
        sun_dir=pparams.sun_dir, sun_intensity=pparams.sun_intensity,
        framebuffer_size=(W, H), cluster_size_in_pixels=cfg.cluster_size_in_pixels,
        num_clusters_xy=(cfg.num_clusters_x, cfg.num_clusters_y),
        cluster_coeffs=coeffs, cluster_light_counts=_t(counts).to(torch.int32),
        cluster_light_indices=_t(indices).to(torch.int32), lights=plights,
        ggx_lut=_t(lut), tex_slots=pflags.tex_slots,
        mat_matrix=shading.build_material_matrix(pscene, pflags.tex_slots,
                                                 pflags.slot_bundles),
    )
    bid = jnp.arange(W * H // 128, dtype=jnp.int32)
    return dict(scene=scene, flags=flags, jctx=jctx, pscene=pscene, pctx=pctx,
                g_o=g_o, g_t=g_t, block_py=bid // (W // 128),
                block_px0=(bid % (W // 128)) * 128)


def _flat_port(g):
    """Reference [H, W] G-buffer -> the port's flat GBuffer tensors."""
    from transmission_renderer_tpu_torch.render.gbuffer import GBuffer

    return GBuffer(*(_t(np.asarray(a).reshape((H * W,) + a.shape[2:])) for a in g))


def _compare(got: list, ref: list, names):
    valid_px = None
    worst = 0
    for name, g, r in zip(names, got, ref):
        g, r = g.numpy(), np.asarray(r)
        bad = ~np.isclose(g, r, atol=ATOL, rtol=0, equal_nan=True)
        worst = max(worst, int(bad.sum()))
        valid_px = g.size
        assert bad.sum() <= MAX_BAD_FRAC * g.size, (
            f"{name}: {bad.sum()} pixels beyond atol {ATOL}, max err "
            f"{np.nanmax(np.abs(g - r)[bad]) if bad.any() else 0}")
    print(f"pixels beyond atol {ATOL}: {worst} of {valid_px}")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_material_matrix_matches_reference(name):
    case = _case(name)
    ref = jshading.build_material_matrix(case["scene"], case["flags"].tex_slots,
                                         case["flags"].slot_bundles)
    got = case["pctx"].mat_matrix
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(ref.table))
    assert got.meta_col == ref.meta_col


@pytest.mark.parametrize("name", sorted(SCENES))
def test_opaque_shade_matches_reference(name):
    from transmission_renderer_tpu.ops.tap_finish import PlanarBundle

    case = _case(name)
    jctx, pctx = case["jctx"], case["pctx"]
    assert jshade.pallas_shade_supported(jctx, int(jctx.mat_matrix.table.shape[0]), W)
    gflat = jshading.flatten_gbuffer(case["g_o"])
    bundles, _ = jshading.bundle_tap_samples(
        case["scene"], gflat, jctx.tex_slots, jctx.mat_matrix, False,
        pallas_finish=True, interpret=True)
    n_layers = bundles[0].n_layers if bundles else 0
    # jitted as in the frame; the context's statics stay Python values
    ref = jax.jit(lambda g, bpy, bpx, chans: jshade.shade_opaque_pallas_planes(
        case["scene"], g, jctx, bpy, bpx,
        [PlanarBundle(ch, n_layers) for ch in chans], jctx.tex_slots,
        interpret=True))(gflat, case["block_py"], case["block_px0"],
                         [list(b.chans) for b in bundles])
    pg = _flat_port(case["g_o"])
    # kernel 2 on the same pixels (its own pin is tests/test_torch_tap_finish)
    psamples = shading.bundle_tap_samples(case["pscene"], pg, pctx.tex_slots,
                                          pctx.mat_matrix)
    assert len(psamples) == len(bundles)
    for pb, jb in zip(psamples, bundles):
        for g, r in zip(pb, jb.chans):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6, rtol=0)
    shared = [[_t(c) for c in b.chans] for b in bundles]
    got = shade_kernel.shade_opaque_pallas_planes(
        None, pg, pctx, _t(case["block_py"]), _t(case["block_px0"]), shared,
        pctx.tex_slots)
    assert float(np.abs(np.asarray(ref[0])).max()) > 0.05
    _compare(got, ref, ("r", "g", "b"))


def test_transmission_preshade_matches_reference():
    case = _case("dragon")
    jctx, pctx = case["jctx"], case["pctx"]
    tslots = case["flags"].tex_slots_transmission
    jctx_t = jctx._replace(tex_slots=tslots, mat_matrix=jshading.build_material_matrix(
        case["scene"], tslots, case["flags"].slot_bundles))
    pctx_t = pctx._replace(tex_slots=tslots, mat_matrix=shading.build_material_matrix(
        case["pscene"], tslots, case["flags"].slot_bundles))
    gflat = jshading.flatten_gbuffer(case["g_t"])
    assert int(np.asarray(gflat.valid).sum()) > 500
    ref = jax.jit(lambda g, bpy, bpx: jshade.shade_transmission_pallas_pre(
        case["scene"], g, jctx_t, bpy, bpx, [], tslots, interpret=True))(
            gflat, case["block_py"], case["block_px0"])
    got = shade_kernel.shade_transmission_pallas_pre(
        None, _flat_port(case["g_t"]), pctx_t, _t(case["block_py"]),
        _t(case["block_px0"]), [], tslots)
    names = shade_kernel.TRANS_NAMES
    assert set(got) == set(ref) == set(names)
    _compare([got[n] for n in names], [ref[n] for n in names], names)


def _factors(n_lights, seed):
    """Shadow factors as render_frame makes them: 0/1, with the half-res
    upsample's 0.25 / 0.5 / 0.75 blends; [M] for the sun, [M, L] per light."""
    rng = np.random.default_rng(seed)
    vals = np.array([0.0, 0.25, 0.5, 0.75, 1.0], np.float32)
    sun = vals[rng.integers(0, 5, W * H)]
    lights = vals[rng.integers(0, 5, (W * H, n_lights))]
    return sun, lights


@pytest.mark.parametrize("name", ["dragon", "bindless"])
def test_opaque_shade_with_shadow_factors_matches_reference(name):
    """The sun and per-light factor planes (ray-traced shadows): the sun's
    ambient floor and each light's factor by light id; bindless runs the
    reference kernel's 20-light mask mode."""
    from transmission_renderer_tpu.ops.tap_finish import PlanarBundle

    case = _case(name)
    sun, lf = _factors(case["pctx"].lights.num, seed=7)
    jctx = case["jctx"]._replace(sun_shadow_factor=jnp.asarray(sun),
                                 light_shadow_factors=jnp.asarray(lf))
    pctx = case["pctx"]._replace(sun_shadow_factor=_t(sun), light_shadow_factors=_t(lf))
    gflat = jshading.flatten_gbuffer(case["g_o"])
    bundles, _ = jshading.bundle_tap_samples(
        case["scene"], gflat, jctx.tex_slots, jctx.mat_matrix, False,
        pallas_finish=True, interpret=True)
    n_layers = bundles[0].n_layers if bundles else 0
    ref = jax.jit(lambda g, bpy, bpx, chans, sf, lf: jshade.shade_opaque_pallas_planes(
        case["scene"], g, jctx._replace(sun_shadow_factor=sf, light_shadow_factors=lf),
        bpy, bpx, [PlanarBundle(ch, n_layers) for ch in chans], jctx.tex_slots,
        interpret=True))(gflat, case["block_py"], case["block_px0"],
                         [list(b.chans) for b in bundles], jctx.sun_shadow_factor,
                         jctx.light_shadow_factors)
    shared = [[_t(c) for c in b.chans] for b in bundles]
    got = shade_kernel.shade_opaque_pallas_planes(
        None, _flat_port(case["g_o"]), pctx, _t(case["block_py"]),
        _t(case["block_px0"]), shared, pctx.tex_slots)
    plain = shade_kernel.shade_opaque_pallas_planes(
        None, _flat_port(case["g_o"]), case["pctx"], _t(case["block_py"]),
        _t(case["block_px0"]), shared, pctx.tex_slots)
    # the factors darken: never brighter, and darker somewhere
    assert all(bool((g <= p + 1e-6).all()) for g, p in zip(got, plain))
    assert any(bool((g < p - 1e-3).any()) for g, p in zip(got, plain))
    _compare(got, ref, ("r", "g", "b"))


def test_transmission_preshade_with_shadow_factors_matches_reference():
    """The transmission variant applies the raw sun factor (no floor)."""
    case = _case("dragon")
    tslots = case["flags"].tex_slots_transmission
    sun, lf = _factors(case["pctx"].lights.num, seed=8)
    jctx_t = case["jctx"]._replace(
        tex_slots=tslots, sun_shadow_factor=jnp.asarray(sun),
        light_shadow_factors=jnp.asarray(lf),
        mat_matrix=jshading.build_material_matrix(case["scene"], tslots,
                                                  case["flags"].slot_bundles))
    pctx_t = case["pctx"]._replace(
        tex_slots=tslots, sun_shadow_factor=_t(sun), light_shadow_factors=_t(lf),
        mat_matrix=shading.build_material_matrix(case["pscene"], tslots,
                                                 case["flags"].slot_bundles))
    gflat = jshading.flatten_gbuffer(case["g_t"])
    ref = jax.jit(lambda g, bpy, bpx: jshade.shade_transmission_pallas_pre(
        case["scene"], g, jctx_t, bpy, bpx, [], tslots, interpret=True))(
            gflat, case["block_py"], case["block_px0"])
    got = shade_kernel.shade_transmission_pallas_pre(
        None, _flat_port(case["g_t"]), pctx_t, _t(case["block_py"]),
        _t(case["block_px0"]), [], tslots)
    names = shade_kernel.TRANS_NAMES
    _compare([got[n] for n in names], [ref[n] for n in names], names)


def test_shade_gate_matches_reference():
    """The port takes the kernel exactly where the reference does."""
    case = _case("dragon")
    jctx, pctx = case["jctx"], case["pctx"]
    for n_mat, w in ((5, 256), (200, 256), (5, 200)):
        assert shade_kernel.pallas_shade_supported(pctx, n_mat, w) == \
            jshade.pallas_shade_supported(jctx, n_mat, w)


def _crafted_shade_inputs():
    """Two 128-pixel row blocks on three cluster columns (x 0-47, 48-95,
    96-127 of the first block), one z-slice: cluster 0 lists lights 0 and
    1, cluster 1 light 1, cluster 2 none; light 1 is a spot. The first 10
    pixels and the whole second block are invalid (sky). Material 0 (x <
    64) holds a diffuse texture, material 1 none; the diffuse slot is the
    only one in use."""
    m = 256
    pix = torch.zeros((len(shade_kernel.PIX_BASE), m))
    pix[0:3] = torch.linspace(-1.0, 1.0, m)  # positions
    pix[5] = 1.0  # normal +z
    pix[6] = 0.5  # depth
    pix[7, 10:128] = 1.0  # valid
    pix[8] = 1.0
    mat = torch.zeros((2, shade_kernel.MAT_COLS))
    mat[:, shade_kernel._C_TID0:] = -1.0
    mat[0, shade_kernel._C_TID0] = 0.0  # diffuse texture, layer 0
    mat[:, shade_kernel._C_IOR] = 1.5
    mat[:, shade_kernel._C_ROUGHNESS] = 0.5
    mat[:, shade_kernel._C_DIFFUSE : shade_kernel._C_DIFFUSE + 3] = 0.5
    mat[:, shade_kernel._C_SPEC_FACTOR] = 1.0
    mat[:, shade_kernel._C_SPEC_COLOUR : shade_kernel._C_SPEC_COLOUR + 3] = 1.0
    lmat = torch.zeros((2, 12))
    lmat[:, 0:3] = torch.tensor([0.0, 2.0, 1.0])
    lmat[:, 3:6] = 1.0
    lmat[1, 11] = 1.0  # is_spot
    inp = shade_kernel.ShadeInputs(
        # view position (0, 0, 5), sun from +z, white
        scalars=torch.tensor([0.0, 0.0, 5.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0] + [0.0] * 23),
        mat=mat, lmat=lmat,
        counts=torch.tensor([2, 1, 0], dtype=torch.int32),
        indices=torch.tensor([[0, 1], [1, 0], [0, 0]], dtype=torch.int32),
        block_py=torch.tensor([3, 3], dtype=torch.int32),
        block_px0=torch.tensor([0, 128], dtype=torch.int32), pix=pix,
        mid=(torch.arange(m) >= 64).to(torch.int32), samples=torch.ones((4, m)))
    spec = shade_kernel.ShadeSpec(
        n_layers=1, tex_slots=(True,) + (False,) * 8, slot_bundle=(0,) * 8, ncx=3, ncy=1,
        n_slices=1, rcp_csx=float(np.float32(1.0 / 48.0)), rcp_csy=float(np.float32(1e-3)),
        coeff_scale=1.0, coeff_bias=0.0, z_near=0.1, z_far=100.0, transmission=False,
        fb_width=256.0)
    return inp, spec


@pytest.mark.parametrize("transmission", [False, True])
def test_shade_work_counts_by_hand(transmission):
    """shade_work (kernel 3's bound) on crafted inputs against a hand
    count: 118 valid pixels, 38 with lights 0 and 1, 48 with light 1 and 32
    with none (124 lights, 86 of them the spot); 54 valid pixels with a
    diffuse texture. A valid pixel costs 174 operations opaque and 361 in
    transmission, a light 122 (+ 11 for a spot) and 236, the diffuse slot 3
    and its multiplies 3. Four warps hold valid pixels; the second spans
    clusters 0 and 1."""
    inp, spec = _crafted_shade_inputs()
    spec = spec._replace(transmission=transmission)
    w = shade_kernel.shade_work(inp, spec)
    assert (w.valid, w.lights, w.warps, w.uniform_warps) == (118, 124, 4, 3)
    tables = 32 * 4 + 2 * 29 * 4 + 2 * 12 * 4 + 3 * 4 + 6 * 4 + 2 * 4 + 2 * 4
    if transmission:
        assert w.ops == 118 * 361 + 124 * 236 + 118 * 3 + 54 * 3
        # all 256 pixels: valid flag and 32 planes out; valid ones: 8 planes
        # (with the thickness scale), the material id, 4 sample channels
        assert w.nbytes == tables + 256 * 4 * 33 + 118 * 4 * (8 + 1 + 4)
    else:
        assert w.ops == 118 * 174 + 124 * 122 + 86 * 11 + 118 * 3 + 54 * 3
        assert w.nbytes == tables + 256 * 4 * 4 + 118 * 4 * (7 + 1 + 4)
    # and the plain version shades exactly the valid pixels
    out = torch.stack(shade_kernel.fused_shade_plain(inp, spec))
    assert bool((out[:, inp.pix[7] == 0] == 0).all())
    assert bool((out[:, inp.pix[7] > 0] != 0).any(dim=0).all())
