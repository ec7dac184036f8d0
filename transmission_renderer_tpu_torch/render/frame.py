"""render_frame — the flagship frame on PyTorch and the four CUDA kernels.

Counterpart of ``transmission_renderer_tpu/render/frame.py``: DrawList,
SceneFlags and their host derivation (expand_draw_list_numpy,
build_draw_list_from_numpy, scene_flags_from_arrays),
refraction_level_set, FrameDiagnostics, FrameParams, make_frame_params,
_static_cluster_data, _class_tile_worklist, _tile_cap and render_frame.

``render_frame`` covers the branch the flagship takes in the reference:
the G-buffer raster kernel with class-split binning (frame.py:1073-1158),
no alpha clip, no ray tracing, ``w % 128 == 0``, the fused-kernel shade,
and the fused sparse transmission path (frame.py:1374-1416, 1486-1528).
Pass order: vertex transform + cull, setup + binning, payload, opaque
raster (kernel 1), clustering, opaque shade (kernels 2 + 3), mip pyramid,
sparse transmissive raster (kernel 1), transmission shade (kernels 3 +
4), tonemap. Every other branch raises NotImplementedError naming its
ROADMAP item: the port never takes a silent detour.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from transmission_renderer_tpu.utils.ggx_lut import default_ggx_lut
from transmission_renderer_tpu_torch.config import (
    BUCKET_ALPHA_CLIP,
    BUCKET_OPAQUE,
    BUCKET_TRANSMISSION,
    BUCKET_TRANSMISSION_ALPHA_CLIP,
    RenderConfig,
)
from transmission_renderer_tpu_torch.ops.cull import (
    bucket_triangle_masks,
    cull_instances,
    frustum_planes_from_projection,
    transform_vertices,
)
from transmission_renderer_tpu_torch.ops.mipchain import build_pyramid
from transmission_renderer_tpu_torch.ops.raster import (
    bin_triangles,
    setup_triangles,
    tile_image,
)
from transmission_renderer_tpu_torch.ops.raster_gbuf import (
    TILE_H,
    TILE_W,
    gather_gbuf_payload,
    gbuffer_from_channels,
    pack_gbuf_payload,
    rasterize_gbuffer_pallas,
    rasterize_gbuffer_tiles,
)
from transmission_renderer_tpu_torch.pbr.clustering import (
    assign_lights_to_clusters,
    cluster_coefficients,
    write_cluster_data,
)
from transmission_renderer_tpu_torch.pbr.lights import Lights
from transmission_renderer_tpu_torch.pbr.tonemap import (
    bake_lottes_params,
    lottes_tonemap_planes,
)
from transmission_renderer_tpu_torch.render.shading import (
    ShadeContext,
    build_material_matrix,
    shade_opaque,
    shade_transmission_flat,
)
from transmission_renderer_tpu_torch.render.sparse import (
    BLOCK,
    BlockWork,
    block_gather,
    block_scatter,
    num_blocks,
)
from transmission_renderer_tpu_torch.scene.camera import perspective_matrix_reversed
from transmission_renderer_tpu_torch.scene.textures import (
    IMAGE_MASK,
    mip_levels_for_size,
)
from transmission_renderer_tpu_torch.scene.types import Scene
from transmission_renderer_tpu_torch.utils.platform import f32_matmuls
from transmission_renderer_tpu_torch.utils.profiling import pass_scope


class DrawList(NamedTuple):
    """Static (instance x primitive) expansion, flattened at freeze."""

    vtx_src: torch.Tensor  # [VV] int32 into the scene vertex pool
    vtx_inst: torch.Tensor  # [VV] int32
    tri_vtx: torch.Tensor  # [TT, 3] int32 into the expanded pool
    tri_inst: torch.Tensor  # [TT] int32
    tri_bucket: torch.Tensor  # [TT] int32
    tri_material: torch.Tensor  # [TT] int32


def expand_draw_list_numpy(inst_prim, inst_mat, prim_first_tri, prim_tri_count,
                           prim_bucket, indices) -> dict:
    """NumPy instance x geometry expansion."""
    if len(inst_prim) == 0:
        raise ValueError("draw-list expansion requires at least one instance")
    vtx_src, vtx_inst = [], []
    tri_vtx, tri_inst, tri_bucket, tri_material = [], [], [], []
    vtx_offset = 0
    for i, p in enumerate(inst_prim):
        t0 = prim_first_tri[p]
        tc = prim_tri_count[p]
        tris = indices[t0 : t0 + tc]
        v_lo = tris.min() if tc else 0
        v_hi = tris.max() + 1 if tc else 0
        count = v_hi - v_lo
        vtx_src.append(np.arange(v_lo, v_hi, dtype=np.int32))
        vtx_inst.append(np.full(count, i, np.int32))
        tri_vtx.append(tris - v_lo + vtx_offset)
        tri_inst.append(np.full(tc, i, np.int32))
        tri_bucket.append(np.full(tc, prim_bucket[p], np.int32))
        tri_material.append(np.full(tc, inst_mat[i], np.int32))
        vtx_offset += count
    return dict(
        vtx_src=np.concatenate(vtx_src),
        vtx_inst=np.concatenate(vtx_inst),
        tri_vtx=np.concatenate(tri_vtx).astype(np.int32),
        tri_inst=np.concatenate(tri_inst),
        tri_bucket=np.concatenate(tri_bucket),
        tri_material=np.concatenate(tri_material),
    )


def build_draw_list_from_numpy(*args, device="cpu") -> DrawList:
    d = expand_draw_list_numpy(*args)
    return DrawList(**{k: torch.from_numpy(v).to(device) for k, v in d.items()})


class SceneFlags(NamedTuple):
    """Static facts about a scene that gate whole passes (see the
    reference's SceneFlags for each field's meaning)."""

    has_alpha_clip: bool
    has_transmission: bool
    tex_slots: tuple = (True,) * 9
    tex_slots_transmission: tuple = (True,) * 9
    transmission_ior_roughness: tuple | None = None
    slot_bundles: tuple = ()
    atlas_pot: bool = False


TEX_SLOT_NAMES = (
    "tex_diffuse", "tex_metallic_roughness", "tex_normal_map",
    "tex_emissive", "tex_occlusion", "tex_transmission", "tex_thickness",
    "tex_specular", "tex_specular_colour",
)


def atlas_all_pot(atlas_meta) -> bool:
    m = np.asarray(atlas_meta)
    w = m[:, 2].astype(np.int64)
    h = m[:, 3].astype(np.int64)
    return bool(np.all((w & (w - 1)) == 0) and np.all((h & (h - 1)) == 0))


def compute_slot_bundles(tex_columns: dict) -> tuple:
    """One group of all sampled slots when every material's sampled
    slots reference a single atlas image, else ()."""
    names = tuple(n for n in TEX_SLOT_NAMES if n != "tex_occlusion")
    stack = np.stack([np.asarray(tex_columns[n]) for n in names])
    imgs = np.where(stack >= 0, stack & IMAGE_MASK, -1)
    mx = imgs.max(axis=0)
    ok = np.all((imgs < 0) | (imgs == mx[None]), axis=0)
    return (names,) if np.all(ok) else ()


def compute_tex_slot_flags(tex_columns: dict, inst_material=None,
                           restrict_to=None) -> tuple:
    if restrict_to is not None and inst_material is not None:
        mids = np.unique(inst_material[restrict_to])
        if len(mids) == 0:
            return (False,) * len(TEX_SLOT_NAMES)
        return tuple(bool(np.any(np.asarray(tex_columns[n])[mids] >= 0))
                     for n in TEX_SLOT_NAMES)
    return tuple(bool(np.any(np.asarray(tex_columns[n]) >= 0))
                 for n in TEX_SLOT_NAMES)


def static_ior_roughness_values(roughs, iors) -> tuple:
    """apply_ior_to_roughness over parallel factor arrays, in float32."""
    r = np.asarray(roughs, np.float32)
    ior = np.asarray(iors, np.float32)
    v = r * np.clip(ior * np.float32(2.0) - np.float32(2.0), np.float32(0),
                    np.float32(1))
    return tuple(sorted(set(float(x) for x in v.astype(np.float32))))


def scene_flags_from_arrays(prim_buckets, inst_prim, inst_mat, cols: dict,
                            roughness_factor, index_of_refraction,
                            atlas_meta) -> SceneFlags:
    """The SceneFlags derivation on host arrays (keys off instanced
    primitives, as the reference)."""
    buckets = np.asarray(prim_buckets)
    inst_bucket = buckets[np.asarray(inst_prim, np.int64)]
    inst_mat = np.asarray(inst_mat)
    cols = {n: np.asarray(c) for n, c in cols.items()}
    trans_inst = (inst_bucket == BUCKET_TRANSMISSION) | (
        inst_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP)
    trans_mids = np.unique(inst_mat[trans_inst])
    if len(trans_mids) and not np.any(cols["tex_metallic_roughness"][trans_mids] >= 0):
        tir = static_ior_roughness_values(
            np.asarray(roughness_factor, np.float32)[trans_mids],
            np.asarray(index_of_refraction, np.float32)[trans_mids],
        )
    else:
        tir = None
    return SceneFlags(
        has_alpha_clip=bool(np.any(inst_bucket == BUCKET_ALPHA_CLIP)
                            | np.any(inst_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP)),
        has_transmission=bool(np.any(inst_bucket == BUCKET_TRANSMISSION)
                              | np.any(inst_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP)),
        tex_slots=compute_tex_slot_flags(cols),
        tex_slots_transmission=compute_tex_slot_flags(cols, inst_mat, trans_inst),
        transmission_ior_roughness=tir,
        slot_bundles=compute_slot_bundles(cols),
        atlas_pot=atlas_all_pot(atlas_meta),
    )


def refraction_level_set(flags: SceneFlags, width: int, num_levels: int):
    """Static pyramid level set covering every lod the transmission pass
    can fetch (lod = log2(fb_width) * ior-adjusted roughness), with a
    +-1e-3 guard band; None when roughness is per-pixel."""
    vals = flags.transmission_ior_roughness
    if vals is None:
        return None
    mx = num_levels - 1
    log2w = float(np.log2(np.float32(width)))
    levels = set()
    for v in vals:
        lod = float(np.float32(log2w) * np.float32(v))
        if lod == np.floor(lod):
            levels.add(int(min(max(lod, 0.0), mx)))
            continue
        for guard in (lod - 1e-3, lod + 1e-3):
            g = min(max(guard, 0.0), float(mx))
            l0 = int(np.floor(g))
            levels.add(l0)
            levels.add(min(l0 + 1, mx))
    return tuple(range(min(levels), max(levels) + 1))


class FrameDiagnostics(NamedTuple):
    """Runtime capacity diagnostics; a value above its capacity means the
    frame silently lost work. Counts are 0-d tensors or ints."""

    max_bin_count: object
    bin_capacity: int
    big_tri_count: object
    big_tri_capacity: int
    opaque_blocks: object
    opaque_block_capacity: int
    transmission_blocks: object
    transmission_block_capacity: int
    clip_unresolved: object = 0
    mid_tri_count: object = 0
    mid_tri_capacity: int = 0
    transmission_tiles: object = 0
    transmission_tile_capacity: int = 0
    clip_tiles: object = 0
    clip_tile_capacity: int = 0
    tier_overflow: object = 0
    clip_round_demand: tuple = ()
    clip_round_caps: tuple = ()
    pair_demand: object = 0
    pair_capacity: int = 0

    def overflowed(self) -> bool:
        checks = [
            (int(self.max_bin_count), self.bin_capacity),
            (int(self.big_tri_count), self.big_tri_capacity),
            (int(self.opaque_blocks), self.opaque_block_capacity),
            (int(self.transmission_blocks), self.transmission_block_capacity),
            (int(self.mid_tri_count), self.mid_tri_capacity),
            (int(self.transmission_tiles), self.transmission_tile_capacity),
            (int(self.clip_tiles), self.clip_tile_capacity),
            (int(self.pair_demand), self.pair_capacity),
        ]
        return (
            any(cap and n > cap for n, cap in checks)
            or int(self.clip_unresolved) > 0
            or int(self.tier_overflow) > 0
        )


class FrameParams(NamedTuple):
    """Per-frame camera/sun uniforms (shared-structs/src/lib.rs:11-29)."""

    proj_view: torch.Tensor  # [4, 4]
    view: torch.Tensor  # [4, 4]
    inverse_perspective: torch.Tensor  # [4, 4]
    view_position: torch.Tensor  # [3]
    frustum_x_xz: torch.Tensor  # [2]
    frustum_y_yz: torch.Tensor  # [2]
    sun_dir: torch.Tensor  # [3]
    sun_intensity: torch.Tensor  # [3]


def make_frame_params(config: RenderConfig, view_matrix, view_position, sun_dir,
                      sun_intensity=(3.0, 3.0, 3.0), device="cpu") -> FrameParams:
    proj = perspective_matrix_reversed(
        config.width, config.height, config.vertical_fov, config.z_near,
        config.z_far,
    )
    fx, fy = frustum_planes_from_projection(proj)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return FrameParams(
        proj_view=t(proj @ view_matrix),
        view=t(view_matrix),
        inverse_perspective=t(np.linalg.inv(proj)),
        view_position=t(view_position),
        frustum_x_xz=t(fx),
        frustum_y_yz=t(fy),
        sun_dir=t(sun_dir),
        sun_intensity=t(sun_intensity),
    )


@functools.lru_cache(maxsize=8)
def _static_cluster_data(config: RenderConfig):
    """Cluster coefficients + view-space cluster AABBs (CPU tensors),
    computed once per config: they depend only on the projection and the
    cluster grid (src/main.rs:832-840)."""
    proj = perspective_matrix_reversed(
        config.width, config.height, config.vertical_fov, config.z_near,
        config.z_far,
    )
    coeffs = cluster_coefficients(config.z_near, config.z_far,
                                  config.num_depth_slices)
    inv = torch.from_numpy(np.linalg.inv(proj).astype(np.float32))
    aabb_min, aabb_max = write_cluster_data(
        inv, (config.width, config.height),
        (config.num_clusters_x, config.num_clusters_y), coeffs,
    )
    return coeffs, aabb_min, aabb_max


@functools.lru_cache(maxsize=4)
def _default_lut(size: int, device: torch.device) -> torch.Tensor:
    """The default split-sum GGX LUT on ``device``, uploaded once."""
    return torch.from_numpy(default_ggx_lut(size)).to(device)


def _class_tile_worklist(tile_start: torch.Tensor, n_tiles: int,
                         num_classes: int, cls: int, cap: int):
    """Ids of the tiles holding >= 1 record of draw class ``cls``,
    compacted into a static [cap] list padded with n_tiles -> (ids,
    active count, pad tile = a tile with the fewest records of cls)."""
    dev = tile_start.device
    base = torch.arange(n_tiles, dtype=torch.int64, device=dev) * num_classes + cls
    counts = tile_start[base + 1] - tile_start[base]
    active = counts > 0
    pad_tile = torch.argmin(counts).to(torch.int32)
    pos = torch.cumsum(active.to(torch.int32), 0) - 1
    count = active.to(torch.int32).sum().to(torch.int32)
    tgt = torch.where(active & (pos < cap), pos, cap).long()
    ids = torch.full((cap + 1,), n_tiles, dtype=torch.int32, device=dev)
    ids[tgt] = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    return ids[:cap], count, pad_tile


def _tile_cap(frac: float | None, n_tiles: int, floor: int) -> int:
    """Static sparse-raster tile cap: a fraction of the grid with a
    floor; 0 = dense (also when the cap would cover the whole grid)."""
    if frac is None:
        return 0
    cap = max(int(np.ceil(n_tiles * frac)), floor)
    return 0 if cap >= n_tiles else cap


def _check_branch(config: RenderConfig, flags: SceneFlags) -> None:
    """Refuse every branch of the reference frame this port lacks."""
    def refuse(what, item):
        raise NotImplementedError(f"{what}: ROADMAP queue 1, {item}")

    if flags.has_alpha_clip:
        refuse("alpha-clip depth peeling", "other frame variants")
    if config.ray_traced_shadows:
        refuse("ray-traced shadows", "ray tracing")
    if config.debug_clusters:
        refuse("--debug-clusters", "other frame variants")
    if config.use_pallas_raster is False or (config.tile_w, config.tile_h) != (TILE_W, TILE_H):
        refuse("the pure raster path (use_pallas_raster=False or non-8x128 "
               "tiles)", "other frame variants")
    if config.pallas_shade is False:
        refuse("the XLA shading path (pallas_shade=False)", "other frame variants")
    if config.width % BLOCK:
        refuse("a width that is not a multiple of 128", "other frame variants")
    if config.opaque_block_cap_frac is not None:
        refuse("the block-sparse opaque shade", "other frame variants")
    if config.half_res_refraction or config.quad_material_taps or config.bf16_light_math:
        refuse("the quality flags", "other frame variants")
    if config.pallas_pair_cap_frac is not None:
        refuse("pair-stream compaction (measured negative in the reference)",
               "leave out of the port")


def render_frame(
    scene: Scene,
    dl: DrawList,
    params: FrameParams,
    lights: Lights,
    config: RenderConfig,
    flags: SceneFlags,
    ggx_lut: torch.Tensor | None = None,
    return_hdr: bool = False,
    return_diagnostics: bool = False,
):
    """Render one frame -> tonemapped linear [H, W, 3] in [0, 1] on the
    scene's device; with ``return_diagnostics`` also FrameDiagnostics
    (check ``overflowed()``)."""
    f32_matmuls()
    _check_branch(config, flags)
    dev = scene.positions.device
    w, h = config.width, config.height
    tiles_x, tiles_y = config.tiles_x, config.tiles_y
    n_tiles = tiles_x * tiles_y
    if ggx_lut is None:
        ggx_lut = _default_lut(config.ggx_lut_size, dev)

    # ---- 1. vertex transform + frustum culling ---------------------------
    with pass_scope("geometry"):
        world_pos, world_nrm, uvs, clip, tri_scale = transform_vertices(
            scene, dl, params.proj_view)
        visible = cull_instances(scene, params.view, params.frustum_x_xz,
                                 params.frustum_y_yz, config.z_near)
    mask = bucket_triangle_masks(
        dl.tri_inst, dl.tri_bucket, visible,
        (BUCKET_OPAQUE, BUCKET_ALPHA_CLIP, BUCKET_TRANSMISSION,
         BUCKET_TRANSMISSION_ALPHA_CLIP) if flags.has_transmission
        else (BUCKET_OPAQUE, BUCKET_ALPHA_CLIP),
    )
    # draw classes: 0 opaque, 1 transmission (no clip classes here)
    tri_class = ((dl.tri_bucket == BUCKET_TRANSMISSION)
                 | (dl.tri_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP)).to(torch.int32)
    num_classes = 2

    # ---- 2. setup + class-split binning, payload, opaque raster ---------
    with pass_scope("binning"):
        setup = setup_triangles(clip, dl.tri_vtx, mask, w, h, config.tile_w,
                                config.tile_h)
        bins = bin_triangles(
            setup, tiles_x, tiles_y, config.pallas_tiles_per_tri, tri_class,
            num_classes, config.pallas_tiers,
        )
        tier_overflow = torch.zeros((), dtype=torch.int32, device=dev)
        for demand, slots in zip(bins.tier_demands, bins.tier_slots):
            tier_overflow = torch.maximum(tier_overflow, demand - slots)
    with pass_scope("payload"):
        records = pack_gbuf_payload(setup, dl.tri_vtx, dl.tri_material,
                                    tri_scale, world_pos, world_nrm, uvs,
                                    tri_class)
        gpayload = gather_gbuf_payload(records, bins)

    def sampled(slots):  # slot 4 (occlusion) is loaded, never sampled
        return any(s for i, s in enumerate(slots) if i != 4)

    with pass_scope("raster_opaque"):
        g_o = rasterize_gbuffer_pallas(
            records, bins, w, h, pass_class=0, payload=gpayload,
            pos_derivs=flags.tex_slots[2], uv_channels=sampled(flags.tex_slots),
        )

    # ---- 3. clustered lighting --------------------------------------------
    coeffs, aabb_min, aabb_max = _static_cluster_data(config)
    with pass_scope("clustering"):
        lp_h = torch.cat([lights.position, torch.ones_like(lights.position[:, :1])], -1)
        light_pos_view = (lp_h @ params.view.T)[:, :3]
        spot_dir_view = lights.spot_direction @ params.view[:3, :3].T
        counts, indices = assign_lights_to_clusters(
            aabb_min.to(dev), aabb_max.to(dev), light_pos_view,
            lights.falloff_distance_sq, lights.is_a_spotlight(), spot_dir_view,
            lights.spot_outer_angle, config.max_lights_per_cluster,
        )
    ctx = ShadeContext(
        view_position=params.view_position,
        proj_view=params.proj_view,
        sun_dir=params.sun_dir,
        sun_intensity=params.sun_intensity,
        framebuffer_size=(w, h),
        cluster_size_in_pixels=config.cluster_size_in_pixels,
        num_clusters_xy=(config.num_clusters_x, config.num_clusters_y),
        cluster_coeffs=coeffs,
        cluster_light_counts=counts,
        cluster_light_indices=indices,
        lights=lights,
        ggx_lut=ggx_lut,
        tex_slots=flags.tex_slots,
        mat_matrix=build_material_matrix(scene, flags.tex_slots, flags.slot_bundles),
    )

    # ---- 4. opaque shade (dense) -------------------------------------------
    with pass_scope("shade_opaque"):
        hdr_planes = shade_opaque(scene, g_o, ctx)

    nb = num_blocks(h, w)
    transmission_blocks = torch.zeros((), dtype=torch.int32, device=dev)
    transmission_tiles = torch.zeros((), dtype=torch.int32, device=dev)
    cap_t = cap_rt = 0
    if flags.has_transmission:
        # ---- 5. opaque mip pyramid over the static level set -------------
        level_set = refraction_level_set(flags, w, mip_levels_for_size(w, h))
        with pass_scope("mip_pyramid"):
            pyramid = build_pyramid(hdr_planes, level_set=level_set)

        # ---- 6-7. fused sparse transmissive raster -> sparse shade ---------
        cap_rt = _tile_cap(config.transmission_tile_cap_frac, n_tiles,
                           config.sparse_raster_tile_floor)
        if not cap_rt:
            raise NotImplementedError(
                "dense (non-sparse) transmission raster: ROADMAP queue 1, "
                "non-fused and dense transmission paths")
        init_tiles = tile_image(g_o.depth, TILE_W, TILE_H)
        ids_t, t_count, pad_t = _class_tile_worklist(
            bins.tile_start, n_tiles, num_classes, 1, cap_rt)
        transmission_tiles = t_count
        safe_t = torch.where(ids_t >= n_tiles, pad_t, ids_t).contiguous()
        with pass_scope("raster_transmission"):
            sub_t = rasterize_gbuffer_tiles(
                gpayload, safe_t, bins.tile_start, 0, w, h,
                init_depth_tiles=init_tiles[safe_t.long()].contiguous(),
                pass_class=1, pos_derivs=flags.tex_slots_transmission[2],
                uv_channels=sampled(flags.tex_slots_transmission),
            )
        g_tf = gbuffer_from_channels({
            n: a.reshape((cap_rt * TILE_H * TILE_W,) + a.shape[3:])
            for n, a in sub_t.items()
        })
        # every 8-px tile row is one flat 128-px block (w % 128 == 0); the
        # pad block nb stands in for empty slots and rows past the bottom
        bpr = w // BLOCK
        r8 = torch.arange(TILE_H, dtype=torch.int32, device=dev)
        prow = (ids_t // tiles_x)[:, None] * TILE_H + r8[None, :]
        ok_b = (ids_t[:, None] < n_tiles) & (prow < h)
        bids = torch.where(ok_b, prow * bpr + (ids_t % tiles_x)[:, None], nb).reshape(-1)
        wk_t = BlockWork(block_ids=bids, count=t_count * TILE_H, n_blocks=nb,
                         cap_b=cap_rt * TILE_H, shape=(h, w))
        ctx_t = ctx._replace(
            tex_slots=flags.tex_slots_transmission,
            mat_matrix=build_material_matrix(
                scene, flags.tex_slots_transmission, flags.slot_bundles),
        )
        with pass_scope("shade_transmission"):
            transmission_blocks = wk_t.count
            cap_t = wk_t.cap_b
            bid_t = torch.clamp(wk_t.block_ids, max=nb - 1)
            hdr_t = shade_transmission_flat(
                scene, g_tf, ctx_t, pyramid, level_set,
                bid_t // bpr, (bid_t % bpr) * 128,
            )
            hdr_planes = tuple(
                block_scatter(wk_t, torch.where(
                    g_tf.valid, hdr_t[:, c], block_gather(wk_t, hp)), hp)
                for c, hp in enumerate(hdr_planes)
            )

    # ---- 8. tonemap ----------------------------------------------------------
    with pass_scope("tonemap"):
        ldr = torch.stack(lottes_tonemap_planes(hdr_planes, bake_lottes_params()), -1)
    out = (ldr,)
    if return_hdr:
        out += (torch.stack(hdr_planes, -1),)
    if return_diagnostics:
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        out += (FrameDiagnostics(
            max_bin_count=zero,
            bin_capacity=config.max_tris_per_tile,
            big_tri_count=bins.big_tri_count,
            big_tri_capacity=config.pallas_tiers[-1][1],
            opaque_blocks=zero,
            opaque_block_capacity=0,
            transmission_blocks=transmission_blocks,
            transmission_block_capacity=cap_t,
            clip_unresolved=zero,
            mid_tri_count=bins.mid_tri_count,
            mid_tri_capacity=config.pallas_max_mid_tris,
            transmission_tiles=transmission_tiles,
            transmission_tile_capacity=cap_rt,
            clip_tiles=zero,
            clip_tile_capacity=0,
            tier_overflow=tier_overflow,
            pair_demand=zero,
            pair_capacity=0,
        ),)
    return out[0] if len(out) == 1 else out
