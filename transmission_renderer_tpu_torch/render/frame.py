"""render_frame — the frame on PyTorch and the CUDA kernels.

Counterpart of ``transmission_renderer_tpu/render/frame.py``: DrawList,
SceneFlags and their host derivation (expand_draw_list_numpy,
build_draw_list_from_numpy, scene_flags_from_arrays, and from a frozen
Scene build_draw_list and scene_flags),
refraction_level_set, FrameDiagnostics, FrameParams, make_frame_params,
_static_cluster_data, _class_tile_worklist, _tile_cap, _gather_gbuffer,
the alpha-clip depth peel (_clip_alpha_ok_tiles, _merge_gbuffers,
_default_gbuf_channels, _scatter_tile_channels, _rasterize_class_sparse,
_rasterize_clip_peeled), the in-raster alpha test's inputs (vis_alpha,
for _make_alpha_fn) and render_frame, on both raster branches of the
reference:

- the G-buffer kernel branch (the flagship on the card; frame.py:1073-1158):
  class-split binning (four draw classes with alpha clip), the G-buffer
  raster (kernel 1, partial last tiles at any width), each alpha-clip
  class depth-peeled after its pass (frame.py:1151-1158, 1439-1456; each
  round's alpha test one launch of csrc/clip_alpha.cu, CLIP_ALPHA_KERNEL,
  whose plain version is _clip_alpha_ok_tiles scattered by tile id; each
  re-race round's worklist and merge over the stacked state one launch
  each of csrc/clip_peel.cu, CLIP_WORKLIST_KERNEL and CLIP_MERGE_KERNEL,
  whose plain versions are its gather, where and index-put; a peel's
  re-race rounds one C call, CLIP_ROUNDS_KERNEL, whose plain version is
  the Python loop of the per-round handles), the
  dense or block-sparse opaque shade (frame.py:1278-1322), and the fused
  sparse transmission path (frame.py:1374-1416, 1486-1528) or, with alpha
  clip, half-res refraction, no tile cap or a width that is not a
  multiple of 128, the sparse-tile or dense transmissive raster and the
  compacted or dense shade (frame.py:1417-1438, 1529-1600). Pass order:
  vertex transform + cull (+ BVH refit), setup + binning, payload, opaque
  raster (kernel 1) and its clip peel, clustering, opaque shadow rays
  (kernel 5), opaque shade (kernels 2 + 3), mip pyramid, transmissive
  raster (kernel 1) and its clip peel, transmission shadow rays (kernel
  5), transmission shade (kernels 3 + 4), tonemap.
- the visibility-buffer branch (``use_pallas_raster=False``, and the
  default on the CPU or with tiles other than 8x128; frame.py:1055-1064,
  1159-1166, 1457-1463, 1470-1600): per pass a setup, materialised bins
  capped at ``max_tris_per_tile``, the visibility raster (kernel 6 in
  XLA-raster order, with alpha clip its alpha form, which kills a
  clip-bucket fragment below its cutoff inside the depth race:
  frame.py:1004-1006) and interpolate_gbuffer; the opaque shade dense, the
  transmissive raster seeded with the opaque depth, the transmission
  shade over a compacted block worklist (or dense), through the tensor
  shading path unless ``pallas_shade`` asks for the kernels.

On both branches: ray-traced shadows (frame.py:1007-1016, 1222-1277,
1492-1591) with each transmission path's ray order (the fused path's
tiles, the compacted worklist's own order, the dense shade's 8x16
groups); per-pixel (textured) transmissive roughness over the whole
pyramid (no level set); and the quality flags (``half_res_refraction``,
``quad_material_taps``, ``bf16_light_math``), which the reference's gate
sends to the tensor shade. A pass shades through the kernels only at
widths that are multiples of 128 (single-row 128-px blocks).

The kernel branch's binning compacts its pair stream before the sort
when ``pallas_pair_cap_frac`` is set (frame.py:1093-1105,
ops/raster.py::bin_triangles), reporting ``pair_demand`` against
``pair_capacity``. One branch raises NotImplementedError, saying why:
the G-buffer kernel with tiles other than its fixed 8x128. The port
never takes a silent detour.
"""

from __future__ import annotations

import ctypes
import functools
import warnings
from typing import NamedTuple

import numpy as np
import torch

from transmission_renderer_tpu_torch import kernels
from transmission_renderer_tpu_torch.config import (
    BUCKET_ALPHA_CLIP,
    BUCKET_OPAQUE,
    BUCKET_TRANSMISSION,
    BUCKET_TRANSMISSION_ALPHA_CLIP,
    RenderConfig,
)
from transmission_renderer_tpu_torch.ops.bvh import BVH, refit_bvh
from transmission_renderer_tpu_torch.ops.cull import (
    bucket_triangle_masks,
    cull_instances,
    frustum_planes_from_projection,
    transform_vertices,
)
from transmission_renderer_tpu_torch.ops.mipchain import build_pyramid
from transmission_renderer_tpu_torch.ops.raster import (
    bin_triangles,
    bin_triangles_materialized,
    setup_triangles,
    tile_image,
    untile_image,
)
from transmission_renderer_tpu_torch.ops import raster_gbuf
from transmission_renderer_tpu_torch.ops.raster_gbuf import (
    INT_CHANNELS,
    TILE_H,
    TILE_W,
    active_channels,
    gather_gbuf_payload,
    gbuffer_from_channels,
    pack_gbuf_payload,
    rasterize_gbuffer_pallas,
    rasterize_gbuffer_tiles,
)
from transmission_renderer_tpu_torch.ops.raster_vis import (
    VisAlpha,
    gather_bin_payload,
    rasterize,
)
from transmission_renderer_tpu_torch.ops.texture import (
    WRAP_REPEAT,
    atlas_classes,
    class_mask,
    sample_texture_rows,
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
from transmission_renderer_tpu_torch.render.gbuffer import GBuffer, interpolate_gbuffer
from transmission_renderer_tpu_torch.render.raytrace import shadow_factors
from transmission_renderer_tpu_torch.render.shading import (
    ShadeContext,
    _mip_lod,
    build_material_matrix,
    cluster_light_mask,
    shade_opaque,
    shade_opaque_flat,
    shade_transmission,
    shade_transmission_flat,
)
from transmission_renderer_tpu_torch.render.sparse import (
    BLOCK,
    BlockWork,
    block_gather,
    block_origins,
    block_scatter,
    compact_blocks,
    num_blocks,
    pixel_coords,
)
from transmission_renderer_tpu_torch.scene.camera import perspective_matrix_reversed
from transmission_renderer_tpu_torch.scene.textures import (
    IMAGE_MASK,
    LAYER_SHIFT,
    META_COLS,
    mip_levels_for_size,
)
from transmission_renderer_tpu_torch.scene.types import Scene
from transmission_renderer_tpu_torch.utils.ggx_lut import default_ggx_lut
from transmission_renderer_tpu_torch.utils.platform import CARD, f32_matmuls, resolve_device
from transmission_renderer_tpu_torch.utils.profiling import FRAME_SPAN, current_tracer, pass_scope


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


def build_draw_list_from_numpy(*args, device=CARD) -> DrawList:
    device = resolve_device(device)
    d = expand_draw_list_numpy(*args)
    return DrawList(**{k: torch.from_numpy(v).to(device) for k, v in d.items()})


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def build_draw_list(scene: Scene) -> DrawList:
    """The DrawList of a frozen Scene, on the scene's device. It reads the
    scene's tensors back to the host; ``SceneBuilder.finish_bundle`` gives
    the same without the readback."""
    return build_draw_list_from_numpy(
        _host(scene.inst_primitive_id), _host(scene.inst_material_id),
        _host(scene.prim_first_tri), _host(scene.prim_tri_count),
        _host(scene.prim_draw_bucket), _host(scene.indices),
        device=scene.positions.device)


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


def scene_flags(scene: Scene) -> SceneFlags:
    """The SceneFlags of a frozen Scene (reads its tensors back to the
    host)."""
    m = scene.materials
    return scene_flags_from_arrays(
        _host(scene.prim_draw_bucket), _host(scene.inst_primitive_id),
        _host(scene.inst_material_id), {n: _host(getattr(m, n)) for n in TEX_SLOT_NAMES},
        _host(m.roughness_factor), _host(m.index_of_refraction), _host(scene.atlas_meta))


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


# FrameDiagnostics' demand fields beside their capacity fields
_CAPACITIES = (
    ("max_bin_count", "bin_capacity"), ("big_tri_count", "big_tri_capacity"),
    ("opaque_blocks", "opaque_block_capacity"),
    ("transmission_blocks", "transmission_block_capacity"),
    ("mid_tri_count", "mid_tri_capacity"),
    ("transmission_tiles", "transmission_tile_capacity"),
    ("clip_tiles", "clip_tile_capacity"), ("pair_demand", "pair_capacity"),
)


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

    def demands(self) -> dict:
        """Each demand beside its capacity, as ints: {name: (demand,
        capacity)}, capacity 0 for the unresolved clip pixels and the tier
        overflow (which must be 0), and the peel's per-round failing tiles
        beside the rounds' caps as lists. Reads the device counts."""
        out = {n: (int(getattr(self, n)), getattr(self, cap)) for n, cap in _CAPACITIES}
        out["clip_unresolved"] = (int(self.clip_unresolved), 0)
        out["tier_overflow"] = (int(self.tier_overflow), 0)
        out["clip_round_demand"] = ([int(d) for d in self.clip_round_demand],
                                    list(self.clip_round_caps))
        return out

    def overflowed(self) -> bool:
        counts = ((int(getattr(self, n)), getattr(self, cap)) for n, cap in _CAPACITIES)
        return (
            any(cap and n > cap for n, cap in counts)
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
                      sun_intensity=(3.0, 3.0, 3.0), device=CARD) -> FrameParams:
    device = resolve_device(device)
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


def _pixel_grid(h: int, w: int, device) -> tuple:
    """[H, W] int32 (x, y) of every pixel."""
    return (torch.arange(w, dtype=torch.int32, device=device)[None, :].expand(h, w),
            torch.arange(h, dtype=torch.int32, device=device)[:, None].expand(h, w))


def _up2(a: torch.Tensor, axis: int, nxt_override: torch.Tensor | None = None) -> torch.Tensor:
    """2x upsample of a half-res sample grid whose samples sit at
    full-res pixels 2i: even outputs copy their sample, odd outputs
    average the two flanking samples (edge-clamped). ``nxt_override``
    replaces the shifted-by-one neighbour array (a row band passes its
    neighbour's boundary row, parallel/sharded.py)."""
    n = a.shape[axis]
    if nxt_override is None:
        nxt = torch.cat([a.narrow(axis, 1, n - 1), a.narrow(axis, n - 1, 1)], dim=axis)
    else:
        nxt = nxt_override
    pair = torch.stack([a, 0.5 * (a + nxt)], dim=axis + 1)
    return pair.reshape(a.shape[:axis] + (2 * n,) + a.shape[axis + 1 :])


def _sampled(slots: tuple) -> bool:
    """Whether a pass samples any texture slot (slot 4, occlusion, is
    loaded and never sampled)."""
    return any(s for i, s in enumerate(slots) if i != 4)


def _cluster_lights(config: RenderConfig, params: FrameParams, lights: Lights, dev) -> tuple:
    """The frame's light clusters -> (cluster coefficients, per-cluster
    light counts, light indices)."""
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
    return coeffs, counts, indices


def _check_branch(config: RenderConfig, flags: SceneFlags, use_pallas: bool) -> None:
    """Refuse the one branch of the reference frame this port lacks: the
    kernel branch with tiles other than 8x128 (which the reference's auto
    branch never picks and its kernel cannot run)."""
    if use_pallas and (config.tile_w, config.tile_h) != (TILE_W, TILE_H):
        raise NotImplementedError(
            f"the G-buffer kernel with {config.tile_h}x{config.tile_w} tiles: its tile "
            "is 8x128, as the reference kernel's")


def _fused_transmission(config: RenderConfig, flags: SceneFlags) -> bool:
    """Whether the kernel branch's transmissive raster feeds the shade
    straight from its tiles (frame.py:1368-1373): a sparse tile cap, no
    alpha clip (whose peel needs the dense G-buffer), no half-res
    refraction (which needs the dense shade's 2-D grid), and a width that
    is a multiple of 128 (each tile row one 128-px shading block)."""
    cap_rt = _tile_cap(config.transmission_tile_cap_frac, config.tiles_x * config.tiles_y,
                       config.sparse_raster_tile_floor)
    return (bool(cap_rt) and not flags.has_alpha_clip and not config.half_res_refraction
            and config.width % TILE_W == 0)


def _gather_gbuffer(wk: BlockWork, g: GBuffer) -> GBuffer:
    """Every G-buffer channel's active blocks -> a flat worklist."""
    return GBuffer(*(block_gather(wk, a) for a in g))


def _clip_alpha_ok_tiles(scene: Scene, ch: dict) -> torch.Tensor:
    """Alpha test of the clip race's current winners (the fragment kill of
    depth_pre_pass_alpha_clip, shader/src/lib.rs:270-295) on a tiled
    channel dict: the diffuse alpha at implicit LOD from the analytic uv
    derivatives against the material's cutoff. True where the winner
    passes (or there is no winner)."""
    with pass_scope("clip_alpha_test"):
        m = scene.materials
        mat = torch.clamp(ch["material"], min=0).long()
        tid = m.tex_diffuse[mat]
        packed = torch.clamp(tid, min=0)
        rows = scene.atlas_meta[(packed & IMAGE_MASK).long()][..., :META_COLS]
        uv = torch.stack([ch["uv_u"], ch["uv_v"]], -1)
        duvdx = torch.stack([ch["duvdx_u"], ch["duvdx_v"]], -1)
        duvdy = torch.stack([ch["duvdy_u"], ch["duvdy_v"]], -1)
        lod = _mip_lod(duvdx, duvdy, rows[..., 2], rows[..., 3])
        classes = atlas_classes(scene.atlas_meta)
        s = sample_texture_rows(
            scene.atlas_texels, rows, uv, lod, WRAP_REPEAT, classes,
            layer=(packed >> LAYER_SHIFT) if max(classes) > 1 else None,
        )
        alpha = m.diffuse_factor[mat, 3] * torch.where(tid >= 0, s[..., 3], 1.0)
        return (ch["tri"] < 0) | (alpha >= m.alpha_clipping_cutoff[mat])


# the tiled channels the peel's alpha test reads, in the kernel's order
CLIP_ALPHA_CHANNELS = ("tri", "material", "uv_u", "uv_v", "duvdx_u", "duvdx_v", "duvdy_u",
                       "duvdy_v")


def _clip_alpha_plain(scene: Scene, ch: dict, ids: torch.Tensor, n_tiles: int,
                      ok_p: torch.Tensor) -> torch.Tensor:
    """The peel's alpha test in plain PyTorch: _clip_alpha_ok_tiles of the
    slots' channels written over ``ok_p`` ([n_tiles + 1, 8, 128]) at the
    slots' tile ``ids``; the empty slots' row n_tiles keeps what it held,
    as in the kernel. -> ok_p."""
    pad = ok_p[n_tiles].clone()
    ok_p[ids.long()] = _clip_alpha_ok_tiles(scene, ch)
    ok_p[n_tiles] = pad
    return ok_p


def _clip_alpha_cuda(scene: Scene, ch: dict, ids: torch.Tensor, n_tiles: int,
                     ok_p: torch.Tensor) -> torch.Tensor:
    """Launch csrc/clip_alpha.cu: the test of every winner of the slots
    whose id is below n_tiles, written into ``ok_p`` at that id. -> ok_p."""
    with pass_scope("clip_alpha_test"):
        dev = ok_p.device
        k = ids.shape[0]
        chans = [ch[n].contiguous() for n in CLIP_ALPHA_CHANNELS]
        for name, t in zip(CLIP_ALPHA_CHANNELS, chans):
            kernels.check(t, name, torch.int32 if name in ("tri", "material") else torch.float32,
                          (k, TILE_H, TILE_W), device=dev)
        kernels.check(ids, "ids", torch.int32, (k,), device=dev)
        kernels.check(ok_p, "ok", torch.bool, (n_tiles + 1, TILE_H, TILE_W), device=dev)
        types, operands = _clip_alpha_operands(scene, dev)
        p, i = kernels.VOIDP, kernels.INT
        fn = kernels.entry("trt_clip_alpha",
                           [ctypes.POINTER(ctypes.c_void_p), p, i, i, *types, p])
        kernels.launch(
            CLIP_ALPHA_KERNEL, fn, (ctypes.c_void_p * 8)(*(t.data_ptr() for t in chans)),
            kernels.ptr(ids), k, n_tiles, *operands, kernels.ptr(ok_p))
    return ok_p


def _clip_alpha_operands(scene: Scene, dev) -> tuple:
    """The alpha test's material and atlas operands, checked, as
    csrc/clip_alpha.cu's entries take them: (ctypes types, values)."""
    m = scene.materials
    n_mat = m.tex_diffuse.shape[0]
    kernels.check(m.tex_diffuse, "diffuse refs", torch.int32, (n_mat,), device=dev)
    kernels.check(m.diffuse_factor, "diffuse factors", torch.float32, (n_mat, 4), device=dev)
    kernels.check(m.alpha_clipping_cutoff, "alpha cutoffs", torch.float32, (n_mat,),
                  device=dev)
    kernels.check(scene.atlas_texels, "atlas texels", torch.bfloat16, device=dev)
    kernels.check(scene.atlas_meta, "atlas meta", torch.int32, device=dev)
    classes = atlas_classes(scene.atlas_meta)
    p, i = kernels.VOIDP, kernels.INT
    return ((p, p, i, p, p, i, p, i, i, i, i),
            (kernels.ptr(m.tex_diffuse), kernels.ptr(m.diffuse_factor), 4,
             kernels.ptr(m.alpha_clipping_cutoff), kernels.ptr(scene.atlas_texels),
             scene.atlas_texels.shape[-1], kernels.ptr(scene.atlas_meta),
             scene.atlas_meta.shape[0], scene.atlas_meta.shape[1], class_mask(classes),
             max(classes)))


CLIP_ALPHA_KERNEL = kernels.KernelHandle(
    "clip_alpha", "transmission_renderer_tpu_torch/csrc/clip_alpha.cu",
    "none: the peel's alpha test is XLA code, "
    "transmission_renderer_tpu/render/frame.py:536 (_clip_alpha_ok_tiles)",
    cuda=_clip_alpha_cuda, plain=_clip_alpha_plain,
)


def _clip_alpha_test(scene: Scene, ch: dict, ids: torch.Tensor, n_tiles: int,
                     ok_p: torch.Tensor) -> torch.Tensor:
    """The peel's alpha test of a worklist's winners (``ch``: tiled
    channels [slots, 8, 128]; ``ids``: [slots] int32 tile ids, n_tiles for
    an empty slot) into the peel's state ``ok_p`` [n_tiles + 1, 8, 128]:
    the kernel for CUDA tensors, _clip_alpha_plain otherwise. -> ok_p."""
    return CLIP_ALPHA_KERNEL(ok_p.is_cuda, scene, ch, ids, n_tiles, ok_p)


# the peel's stacked state [C, n_tiles, 8, 128] float32 holds kernel 1's
# channels in its output order: tri and material (int32 bits), then the
# float channels, depth first (csrc/clip_peel.cu reads tri at plane 0 and
# depth at plane PEEL_DEPTH)
PEEL_DEPTH = len(INT_CHANNELS)


def _peel_channels(ch: dict) -> tuple:
    """The state's channel names for kernel 1's channel dict ``ch``: the
    one place that lays the state out."""
    names = INT_CHANNELS + tuple(n for n in ch if n not in INT_CHANNELS)
    if names[PEEL_DEPTH] != "depth":
        raise ValueError(f"the peel state's plane {PEEL_DEPTH} is {names[PEEL_DEPTH]!r}, "
                         "not depth")
    return names


def _clip_worklist_plain(state: torch.Tensor, ok_p: torch.Tensor, init_tiles: torch.Tensor,
                         pad_tile: torch.Tensor, t0: int, cap: int) -> tuple:
    """A re-race round's worklist in plain PyTorch: the tiles holding a
    failing winner (tri >= 0 where ``ok_p`` is false), compacted in
    ascending order into ``cap`` slots (the rest wait for a later round;
    an empty slot's id is n_tiles and it races ``pad_tile``), and kernel
    1's inputs gathered per slot. -> (ids, race ids = the raced local
    tiles + t0, demand = the failing tiles [] int32, seed depths, peel
    bounds = the state's depth where the winner failed, +inf elsewhere)."""
    n_tiles = state.shape[1]
    dev = state.device
    failed = (state[0].view(torch.int32) >= 0) & ~ok_p[:n_tiles]
    ft = failed.reshape(n_tiles, -1).any(dim=1)
    pos = torch.cumsum(ft.to(torch.int32), 0) - 1
    tgt = torch.where(ft & (pos < cap), pos, cap).long()
    ids = torch.full((cap + 1,), n_tiles, dtype=torch.int32, device=dev)
    ids[tgt] = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    ids = ids[:cap]
    safe = torch.where(ids >= n_tiles, pad_tile, ids).long()
    maxd = torch.where(failed[safe], state[PEEL_DEPTH][safe], torch.inf)
    return (ids, (safe + t0).to(torch.int32), ft.sum(dtype=torch.int32), init_tiles[safe],
            maxd)


def _clip_worklist_cuda(state: torch.Tensor, ok_p: torch.Tensor, init_tiles: torch.Tensor,
                        pad_tile: torch.Tensor, t0: int, cap: int) -> tuple:
    """Launch csrc/clip_peel.cu's worklist (flag, compact, gather): what
    _clip_worklist_plain computes, with no host sync."""
    dev = state.device
    n_tiles = state.shape[1]
    tile = (n_tiles, TILE_H, TILE_W)
    kernels.check(state, "peel state", torch.float32, (state.shape[0],) + tile, device=dev)
    kernels.check(ok_p, "ok", torch.bool, (n_tiles + 1, TILE_H, TILE_W), device=dev)
    kernels.check(init_tiles, "init tiles", torch.float32, tile, device=dev)
    kernels.check(pad_tile, "pad tile", torch.int32, (), device=dev)
    # ids, race ids, the flags' scratch, the demand
    ints = torch.empty(2 * cap + n_tiles + 1, dtype=torch.int32, device=dev)
    depths = torch.empty((2, cap, TILE_H, TILE_W), dtype=torch.float32, device=dev)
    ids, race_ids, flags = ints[:cap], ints[cap : 2 * cap], ints[2 * cap : -1]
    demand = ints[-1]
    p, i = kernels.VOIDP, kernels.INT
    fn = kernels.entry("trt_clip_worklist", [p, p, p, p, p, i, i, i, p, p, p, p, p, p])
    kernels.launch(
        CLIP_WORKLIST_KERNEL, fn, kernels.ptr(state[0]), kernels.ptr(state[PEEL_DEPTH]),
        kernels.ptr(ok_p), kernels.ptr(init_tiles), kernels.ptr(pad_tile), n_tiles, t0, cap,
        kernels.ptr(flags), kernels.ptr(ids), kernels.ptr(race_ids), kernels.ptr(demand),
        kernels.ptr(depths[0]), kernels.ptr(depths[1]))
    return ids, race_ids, demand, depths[0], depths[1]


CLIP_WORKLIST_KERNEL = kernels.KernelHandle(
    "clip_worklist", "transmission_renderer_tpu_torch/csrc/clip_peel.cu",
    "none: the peel's worklist is XLA code, "
    "transmission_renderer_tpu/render/frame.py:835-854 (_rasterize_clip_peeled)",
    cuda=_clip_worklist_cuda, plain=_clip_worklist_plain,
)


def _clip_worklist(state: torch.Tensor, ok_p: torch.Tensor, init_tiles: torch.Tensor,
                   pad_tile: torch.Tensor, t0: int, cap: int) -> tuple:
    """A re-race round's worklist from the peel's state and ok: the kernel
    for CUDA tensors, _clip_worklist_plain otherwise."""
    return CLIP_WORKLIST_KERNEL(state.is_cuda, state, ok_p, init_tiles, pad_tile, t0, cap)


def _clip_merge_plain(state: torch.Tensor, ok_p: torch.Tensor, ids: torch.Tensor,
                      raced: dict) -> None:
    """A round's merge in plain PyTorch, as 32-bit words: at each slot
    whose id is below n_tiles, kernel 1's ``raced`` channels ([slots, 8,
    128] each) replace the state where the winner failed, and the state's
    winner replaces them elsewhere, so both hold the merged winner. An
    empty slot touches nothing."""
    n_tiles = state.shape[1]
    words = state.view(torch.int32)
    live = ids < n_tiles
    rows = ids[live].long()
    failed = (words[0, rows] >= 0) & ~ok_p[rows]
    names = _peel_channels(raced)
    new = torch.stack([raced[n].view(torch.int32)[live] for n in names])
    merged = torch.where(failed, new, words[:, rows])
    words[:, rows] = merged
    for n, m in zip(names, merged):
        raced[n].view(torch.int32)[live] = m


def _clip_merge_cuda(state: torch.Tensor, ok_p: torch.Tensor, ids: torch.Tensor,
                     raced: dict) -> None:
    """Launch csrc/clip_peel.cu's merge: what _clip_merge_plain does."""
    dev = state.device
    n_tiles, k = state.shape[1], ids.shape[0]
    names = _peel_channels(raced)
    kernels.check(state, "peel state", torch.float32, (len(names), n_tiles, TILE_H, TILE_W),
                  device=dev)
    kernels.check(ok_p, "ok", torch.bool, (n_tiles + 1, TILE_H, TILE_W), device=dev)
    kernels.check(ids, "ids", torch.int32, (k,), device=dev)
    for n in names:
        kernels.check(raced[n], n, torch.int32 if n in INT_CHANNELS else torch.float32,
                      (k, TILE_H, TILE_W), device=dev, align=16)
    p, i = kernels.VOIDP, kernels.INT
    fn = kernels.entry("trt_clip_merge", [p, i, i, p, p, i, ctypes.POINTER(ctypes.c_void_p)])
    kernels.launch(
        CLIP_MERGE_KERNEL, fn, kernels.ptr(state), len(names), n_tiles, kernels.ptr(ok_p),
        kernels.ptr(ids), k,
        (ctypes.c_void_p * len(names))(*(raced[n].data_ptr() for n in names)))


CLIP_MERGE_KERNEL = kernels.KernelHandle(
    "clip_merge", "transmission_renderer_tpu_torch/csrc/clip_peel.cu",
    "none: the peel's merge is XLA code, "
    "transmission_renderer_tpu/render/frame.py:861-866 (_rasterize_clip_peeled)",
    cuda=_clip_merge_cuda, plain=_clip_merge_plain,
)


def _clip_merge(state: torch.Tensor, ok_p: torch.Tensor, ids: torch.Tensor,
                raced: dict) -> None:
    """Merge a round's raced channels into the peel's state and back into
    ``raced`` in place: the kernel for CUDA tensors, _clip_merge_plain
    otherwise."""
    CLIP_MERGE_KERNEL(state.is_cuda, state, ok_p, ids, raced)


def _clip_rounds_plain(scene: Scene, state: torch.Tensor, ok_p: torch.Tensor,
                       init_tiles: torch.Tensor, pad_tile: torch.Tensor, t0: int, caps: tuple,
                       payload, tile_start: torch.Tensor, big_count, w: int, h: int,
                       pass_class: int, pos_derivs: bool, n_tiles_global) -> torch.Tensor:
    """A peel's re-race rounds as a Python loop, one round per cap: the
    worklist (_clip_worklist), kernel 1 over its slots seeded and bounded
    by it, the merge (_clip_merge) and the alpha test of the merged
    winners, each through its handle (their plain versions for CPU
    tensors, their kernels round by round for CUDA ones). Updates
    ``state`` and ``ok_p`` in place -> each round's failing tiles
    [rounds] int32."""
    n_tiles = state.shape[1]
    demand = []
    for cap in caps:
        ids, race_ids, d, seed, maxd = _clip_worklist(state, ok_p, init_tiles, pad_tile, t0,
                                                      cap)
        demand.append(d)
        new = rasterize_gbuffer_tiles(
            payload, race_ids, tile_start, big_count, w, h, init_depth_tiles=seed,
            max_depth_tiles=maxd, pass_class=pass_class, pos_derivs=pos_derivs,
            n_tiles_global=n_tiles_global)
        _clip_merge(state, ok_p, ids, new)
        _clip_alpha_test(scene, new, ids, n_tiles, ok_p)
    return torch.stack(demand)


def _clip_rounds_cuda(scene: Scene, state: torch.Tensor, ok_p: torch.Tensor,
                      init_tiles: torch.Tensor, pad_tile: torch.Tensor, t0: int, caps: tuple,
                      payload, tile_start: torch.Tensor, big_count, w: int, h: int,
                      pass_class: int, pos_derivs: bool, n_tiles_global) -> torch.Tensor:
    """Call csrc/clip_peel.cu's trt_clip_peel_rounds: what _clip_rounds_plain
    does, every round from one C call, with no host sync. Each round has
    its own slice of the ids, raced tile ids, seed depths and peel bounds;
    kernel 1's output planes and keys are one set that every round reuses.
    The worklist's, kernel 1's, the merge's and the alpha test's handles
    count a launch a round, and kernel 1's recorder keeps each round's
    call as the loop would make it."""
    dev = state.device
    n_tiles = state.shape[1]
    names = _peel_channels(dict.fromkeys(active_channels(pos_derivs)))
    tile = (n_tiles, TILE_H, TILE_W)
    kernels.check(state, "peel state", torch.float32, (len(names),) + tile, device=dev)
    kernels.check(ok_p, "ok", torch.bool, (n_tiles + 1, TILE_H, TILE_W), device=dev)
    kernels.check(init_tiles, "init tiles", torch.float32, tile, device=dev)
    kernels.check(pad_tile, "pad tile", torch.int32, (), device=dev)
    rows, big_rows, big = raster_gbuf.payload_operands(payload, tile_start, big_count)
    alpha_types, alpha_operands = _clip_alpha_operands(scene, dev)
    rounds, slots, widest = len(caps), sum(caps), max(caps)
    px = TILE_H * TILE_W
    ints = torch.empty(n_tiles + 2 * slots + rounds, dtype=torch.int32, device=dev)
    flags, ids, race_ids, demand = ints.split((n_tiles, slots, slots, rounds))
    depths = torch.empty((2, slots, TILE_H, TILE_W), dtype=torch.float32, device=dev)
    raced = torch.empty(len(names) * widest * px, dtype=torch.float32, device=dev)
    keys = torch.empty(widest * (px + 1) + 1, dtype=torch.int64, device=dev)
    p, i, f = kernels.VOIDP, kernels.INT, kernels.FLOAT
    host_ints = ctypes.POINTER(ctypes.c_int)
    fn = kernels.entry("trt_clip_peel_rounds", [
        p, i, i, i, p, p, p, i, i, host_ints, p, p, p, p, p, p, p, p,
        p, p, p, p, i, i, i, i, f, f, i, host_ints, *alpha_types])
    kernels.launch(
        CLIP_ROUNDS_KERNEL, fn, kernels.ptr(state), len(names), PEEL_DEPTH, n_tiles,
        kernels.ptr(ok_p), kernels.ptr(init_tiles), kernels.ptr(pad_tile), t0, rounds,
        (ctypes.c_int * rounds)(*caps), kernels.ptr(flags), kernels.ptr(ids),
        kernels.ptr(race_ids), kernels.ptr(demand), kernels.ptr(depths[0]),
        kernels.ptr(depths[1]), kernels.ptr(keys), kernels.ptr(raced), kernels.ptr(rows),
        kernels.ptr(big_rows), kernels.ptr(big), kernels.ptr(tile_start), -(-w // TILE_W),
        raster_gbuf._num_classes(tile_start, w, h, n_tiles_global), pass_class,
        raster_gbuf.SEG, 2.0 / w, 2.0 / h, int(pos_derivs),
        (ctypes.c_int * 8)(*(names.index(n) for n in CLIP_ALPHA_CHANNELS)), *alpha_operands)
    for handle in (raster_gbuf.KERNEL, CLIP_WORKLIST_KERNEL, CLIP_MERGE_KERNEL,
                   CLIP_ALPHA_KERNEL):
        handle.launches += rounds
    recorder = raster_gbuf.KERNEL.recorder
    if recorder is not None:
        at = 0
        for cap in caps:
            recorder.append(raster_gbuf.kernel_call(
                payload, race_ids[at : at + cap], tile_start, big_count, w, h,
                depths[0, at : at + cap], depths[1, at : at + cap], pass_class, pos_derivs,
                n_tiles_global=n_tiles_global))
            at += cap
    return demand


CLIP_ROUNDS_KERNEL = kernels.KernelHandle(
    "clip_rounds", "transmission_renderer_tpu_torch/csrc/clip_peel.cu",
    "none: the peel's re-race rounds are an XLA loop, "
    "transmission_renderer_tpu/render/frame.py:835-866 (_rasterize_clip_peeled)",
    cuda=_clip_rounds_cuda, plain=_clip_rounds_plain,
)


def _clip_rounds(scene: Scene, state: torch.Tensor, ok_p: torch.Tensor,
                 init_tiles: torch.Tensor, pad_tile: torch.Tensor, t0: int, caps: tuple,
                 payload, tile_start: torch.Tensor, big_count, w: int, h: int,
                 pass_class: int, pos_derivs: bool, n_tiles_global) -> torch.Tensor:
    """A peel's re-race rounds (one per cap of ``caps``) over its state and
    ok, in place: the C entry for CUDA tensors, _clip_rounds_plain
    otherwise -> each round's failing tiles [rounds] int32."""
    return CLIP_ROUNDS_KERNEL(state.is_cuda, scene, state, ok_p, init_tiles, pad_tile, t0,
                              caps, payload, tile_start, big_count, w, h, pass_class,
                              pos_derivs, n_tiles_global)


def vis_alpha(scene: Scene, dl: DrawList, uvs: torch.Tensor) -> VisAlpha:
    """The visibility raster's alpha test inputs (the reference's
    _make_alpha_fn, frame.py:886-954) from the scene, the draw list and
    the expanded uvs: per triangle whether it is in a clip bucket, its
    material and its three vertex uvs; per material the diffuse ref, alpha
    factor and cutoff; the atlas. The test itself is
    ops/raster_vis.py::alpha_keep, which computes what
    _clip_alpha_ok_tiles does on the kernel branch (the uv derivatives of
    the same closed forms, _mip_lod, the trilinear REPEAT tap, alpha >=
    cutoff), at each fragment of the race instead of at the winners."""
    m = scene.materials
    clip = (dl.tri_bucket == BUCKET_ALPHA_CLIP) | (dl.tri_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP)
    return VisAlpha(
        tri_clip=clip.to(torch.int32).contiguous(),
        tri_material=dl.tri_material.to(torch.int32).contiguous(),
        tri_uv=uvs[dl.tri_vtx.long()].reshape(-1, 6).contiguous(),
        tex_diffuse=m.tex_diffuse.to(torch.int32).contiguous(),
        alpha_factor=m.diffuse_factor[:, 3].contiguous(),
        cutoff=m.alpha_clipping_cutoff.contiguous(),
        atlas_texels=scene.atlas_texels.contiguous(),
        atlas_meta=scene.atlas_meta.contiguous(),
    )


def _merge_gbuffers(base: GBuffer, top: GBuffer) -> GBuffer:
    """Depth-pass merge: where the (base-depth-seeded) top layer won a
    pixel take its G-buffer, else keep base."""
    pick = top.valid
    fields = {
        name: torch.where(pick[..., None] if a.dim() == 3 else pick, a, getattr(base, name))
        for name, a in zip(GBuffer._fields, top)
    }
    fields["valid"] = base.valid | top.valid
    return GBuffer(**fields)


def _default_gbuf_channels(n_tiles: int, init_tiles: torch.Tensor, pos_derivs: bool,
                           uv_channels: bool = True) -> dict:
    """Tiled channels equal to kernel 1's output on a tile no record
    wins, so a sparse pass scattered over them equals the dense one."""
    zero = torch.zeros((n_tiles, TILE_H, TILE_W), dtype=torch.float32,
                       device=init_tiles.device)
    ch = {name: zero for name in active_channels(pos_derivs, uv_channels)}
    ch["tri"] = torch.full_like(zero, -1, dtype=torch.int32)
    ch["material"] = torch.zeros_like(zero, dtype=torch.int32)
    ch["depth"] = init_tiles
    ch["nrm_z"] = zero + 1.0
    ch["scale"] = zero + 1.0
    return ch


def _scatter_tile_channels(ch: dict, ids: torch.Tensor, sub: dict, n_tiles: int) -> dict:
    """Write a tile worklist's channels over the dense tiled ones (empty
    slots, id n_tiles, land on a pad row that is dropped)."""
    out = {}
    for name, dense in ch.items():
        padded = torch.cat([dense, torch.zeros_like(dense[:1])])
        padded[ids.long()] = sub[name]
        out[name] = padded[:n_tiles]
    return out


def _rasterize_class_sparse(payload, tile_start, big_count, pass_class: int, cap: int,
                            init_tiles: torch.Tensor, w: int, h: int,
                            pos_derivs: bool = True, uv_channels: bool = True):
    """Raster one draw class over only the tiles holding its records
    (exact while they fit ``cap``; the others keep the cleared output,
    counted in the diagnostics) -> (dense tiled channels, active tile
    count, (ids, safe ids, the worklist's channels))."""
    n_tiles = -(-w // TILE_W) * -(-h // TILE_H)
    num_classes = (tile_start.shape[0] - 1) // n_tiles
    ids, count, pad_tile = _class_tile_worklist(tile_start, n_tiles, num_classes,
                                                pass_class, cap)
    safe_ids = torch.where(ids >= n_tiles, pad_tile, ids).contiguous()
    sub = rasterize_gbuffer_tiles(
        payload, safe_ids, tile_start, big_count, w, h,
        init_depth_tiles=init_tiles[safe_ids.long()].contiguous(), pass_class=pass_class,
        pos_derivs=pos_derivs, uv_channels=uv_channels,
    )
    ch = _scatter_tile_channels(
        _default_gbuf_channels(n_tiles, init_tiles, pos_derivs, uv_channels), ids, sub,
        n_tiles)
    return ch, count, (ids, safe_ids, sub)


def _rasterize_clip_peeled(scene: Scene, payload, bins, big_count, pass_class: int,
                           base: GBuffer, config: RenderConfig, w: int, h: int,
                           pos_derivs: bool = True, band: tuple | None = None):
    """Rasterise an alpha-clip draw class by depth peeling: race ignoring
    alpha (seeded with the base pass's depth), alpha-test the winners,
    then re-race only the tiles holding a failing winner with
    ``max_depth`` = that winner's depth where it failed. Exact once the
    rejected layers above the true winner number fewer than
    ``config.alpha_clip_rounds``; leftovers are invalidated (base shows
    through) and counted. -> (merged GBuffer, unresolved pixels, active
    tiles of a sparse first round (0 when dense), (per-round failing-tile
    demand, per-round caps), the unresolved pixels' [H, W] mask).

    ``band`` = (first tile, tile rows, tiles of the binned grid) peels
    only a row band's tiles (parallel/sharded.py): ``base`` is the band's
    G-buffer, the first round races the band densely (the reference's
    sharded peel) and the re-race caps are fractions of the band's tiles.
    A tile's winner depends on its own records only, so the band's
    result is the whole grid's on its tiles.

    The channel state is one stacked [C, n_tiles, 8, 128] float32 buffer
    (tri and material as int32 bits, then kernel 1's float channels). A
    round is its worklist (_clip_worklist), kernel 1, the merge
    (_clip_merge) and the alpha test, with no host sync: pure data
    movement, so every bit of a channel survives the rounds. The re-race
    rounds run from one call (_clip_rounds: on the card one C call
    launches every round)."""
    tiles_x = -(-w // TILE_W)
    t0, tiles_y, n_tiles_global = band or (0, -(-h // TILE_H), None)
    n_tiles = tiles_x * tiles_y  # the tiles peeled; state rows are local
    dev = base.depth.device
    local_ids = torch.arange(n_tiles, dtype=torch.int32, device=dev)
    all_ids = local_ids + t0
    init_tiles = tile_image(base.depth, TILE_W, TILE_H).contiguous()
    cap_c = 0 if band else _tile_cap(config.clip_tile_cap_frac, n_tiles,
                                     config.sparse_raster_tile_floor)
    clip_tiles = torch.zeros((), dtype=torch.int32, device=dev)
    # whether each pixel's winner passes (row n_tiles takes no write)
    ok_p = torch.ones((n_tiles + 1, TILE_H, TILE_W), dtype=torch.bool, device=dev)
    if cap_c:
        # sparse first round: only the tiles holding records of the class
        # (inactive tiles keep the cleared output, so base wins there)
        ch, clip_tiles, (ids0, _, sub0) = _rasterize_class_sparse(
            payload, bins.tile_start, big_count, pass_class, cap_c, init_tiles, w, h,
            pos_derivs=pos_derivs)
        _clip_alpha_test(scene, sub0, ids0, n_tiles, ok_p)
    else:
        ch = rasterize_gbuffer_tiles(payload, all_ids, bins.tile_start, big_count, w, h,
                                     init_depth_tiles=init_tiles, pass_class=pass_class,
                                     pos_derivs=pos_derivs, n_tiles_global=n_tiles_global)
        _clip_alpha_test(scene, ch, local_ids, n_tiles, ok_p)
    # per-round re-race caps: a scalar fraction for every round, or a
    # tuple of shrinking ones (round r takes entry min(r - 1, last))
    fracs = config.clip_retile_cap_frac
    if not isinstance(fracs, (tuple, list)):
        fracs = (fracs,)
    caps = [max(int(np.ceil(n_tiles * f)), 1) for f in fracs]
    # empty slots race the class's emptiest tile, not the last one (whose
    # record run every empty slot would re-walk)
    nc = (bins.tile_start.shape[0] - 1) // (n_tiles_global or n_tiles)
    peel_base = all_ids.long() * nc + pass_class
    peel_pad_tile = torch.argmin(bins.tile_start[peel_base + 1]
                                 - bins.tile_start[peel_base]).to(torch.int32)
    names = _peel_channels(ch)
    state = torch.stack([ch[n].view(torch.float32) for n in names])
    round_caps = tuple(caps[min(rnd - 1, len(caps) - 1)]
                       for rnd in range(1, max(config.alpha_clip_rounds, 1)))
    round_demand = ()
    if round_caps:
        with pass_scope("clip_rounds"):
            round_demand = _clip_rounds(
                scene, state, ok_p, init_tiles, peel_pad_tile, t0, round_caps, payload,
                bins.tile_start, big_count, w, h, pass_class, pos_derivs,
                n_tiles_global).unbind(0)
    ch = {n: state[c].view(torch.int32) if n in INT_CHANNELS else state[c]
          for c, n in enumerate(names)}
    failed = (ch["tri"] >= 0) & ~ok_p[:n_tiles]
    unresolved = failed.to(torch.int32).sum()
    ch["tri"] = torch.where(failed, -1, ch["tri"])
    out_h = base.depth.shape[0]  # h, or a band's rows
    g_clip = gbuffer_from_channels({
        n: untile_image(a, tiles_x, tiles_y, TILE_W, TILE_H, w, out_h) for n, a in ch.items()})
    return (_merge_gbuffers(base, g_clip), unresolved, clip_tiles,
            (round_demand, round_caps),
            untile_image(failed, tiles_x, tiles_y, TILE_W, TILE_H, w, out_h))


def _merge_blocks(wk: BlockWork, valid: torch.Tensor, hdr: torch.Tensor,
                  planes: tuple) -> tuple:
    """Write a worklist's shaded pixels [M, 3] over the HDR planes where
    valid (the reference's blend-disabled transmission pipeline)."""
    return tuple(
        block_scatter(wk, torch.where(valid, hdr[:, c], block_gather(wk, hp)), hp)
        for c, hp in enumerate(planes)
    )


def _block_coords(wk: BlockWork, w: int):
    """The shade kernel's block origins of a worklist's blocks."""
    return block_origins(torch.clamp(wk.block_ids, max=wk.n_blocks - 1), w)


def _visibility_pass(clip, dl: DrawList, mask, tri_scale, world_pos, world_nrm, uvs,
                     config: RenderConfig, raster_pass: str, init_depth=None, alpha=None):
    """One raster pass of the visibility-buffer branch (frame.py:1055-1064
    with interpolate_gbuffer): setup over the pass's triangles,
    materialised binning, kernel 6 in XLA-raster order seeded with
    ``init_depth`` (its alpha form with ``alpha``), then the G-buffer ->
    (GBuffer [H, W], TileBins)."""
    w, h, tw, th = config.width, config.height, config.tile_w, config.tile_h
    with pass_scope("binning"):
        setup = setup_triangles(clip, dl.tri_vtx, mask, w, h, tw, th)
        bins = bin_triangles_materialized(
            setup, config.tiles_x, config.tiles_y, config.max_tiles_per_tri,
            config.max_tris_per_tile, config.max_big_tris)
    with pass_scope("payload"):
        payload = gather_bin_payload(setup, bins)
    with pass_scope(raster_pass):
        vis = rasterize(setup, bins, w, h, tw, th, init_depth=init_depth, payload=payload,
                        alpha=alpha)
        g = interpolate_gbuffer(vis, setup, dl.tri_vtx, dl.tri_material, tri_scale,
                                world_pos, world_nrm, uvs, w, h)
    return g, bins


def render_frame(
    scene: Scene,
    dl: DrawList,
    params: FrameParams,
    lights: Lights,
    config: RenderConfig,
    ggx_lut: torch.Tensor | None = None,
    flags: SceneFlags | None = None,
    return_hdr: bool = False,
    bvh: BVH | None = None,
    return_diagnostics: bool = False,
):
    """Render one frame -> tonemapped linear [H, W, 3] in [0, 1] on the
    scene's device; with ``return_diagnostics`` also FrameDiagnostics
    (check ``overflowed()``). Ray-traced shadows are on when
    ``config.ray_traced_shadows`` and a ``bvh``
    (SceneBuilder.build_rt_bvh) is given. The parameters are the
    reference's, in its order: ``flags`` None means a scene with alpha
    clip and transmission (every pass runs), and ``ggx_lut`` None the
    default LUT (utils/ggx_lut.py::default_ggx_lut).

    ``config.use_pallas_raster`` None takes the G-buffer kernel branch on
    the card with 8x128 tiles and the visibility-buffer branch otherwise
    (the reference's choice, with the tensors' device in place of its
    backend); ``config.pallas_shade`` None shades through the kernels on
    the kernel branch and through tensors on the other.

    The frame is one ``render_frame`` range (utils/profiling.py::
    FRAME_SPAN) around its passes' ranges; under an installed FrameTracer
    its span also carries the frame's diagnostics (``demands()``), read
    after the caller's sync."""
    with pass_scope(FRAME_SPAN):
        tracer = current_tracer()
        out = _render_frame(scene, dl, params, lights, config, ggx_lut, flags, return_hdr, bvh,
                            return_diagnostics or tracer is not None)
        if tracer is None:
            return out
        tracer.attach(out[-1].demands)
    if return_diagnostics:
        return out
    return out[0] if len(out) == 2 else out[:-1]


def _render_frame(scene: Scene, dl: DrawList, params: FrameParams, lights: Lights,
                  config: RenderConfig, ggx_lut, flags, return_hdr: bool, bvh,
                  return_diagnostics: bool):
    """render_frame's passes."""
    f32_matmuls()
    dev = scene.positions.device
    w, h = config.width, config.height
    tiles_x, tiles_y = config.tiles_x, config.tiles_y
    n_tiles = tiles_x * tiles_y
    use_pallas = config.use_pallas_raster
    if use_pallas is None:
        use_pallas = dev.type != "cpu" and (config.tile_w, config.tile_h) == (TILE_W, TILE_H)
    use_rt = config.ray_traced_shadows and bvh is not None
    if flags is None:
        flags = SceneFlags(has_alpha_clip=True, has_transmission=True)
    _check_branch(config, flags, use_pallas)
    if ggx_lut is None:
        ggx_lut = _default_lut(config.ggx_lut_size, dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    # ---- 1. vertex transform + frustum culling ---------------------------
    with pass_scope("geometry"):
        world_pos, world_nrm, uvs, clip, tri_scale = transform_vertices(
            scene, dl, params.proj_view)
        visible = cull_instances(scene, params.view, params.frustum_x_xz,
                                 params.frustum_y_yz, config.z_near)
        if use_rt:
            # per-frame refit, the TLAS UPDATE analogue
            # (src/acceleration_structures.rs:192-267)
            bvh = refit_bvh(bvh, dl.tri_vtx, world_pos)

    # ---- 2. opaque raster -------------------------------------------------
    clip_unresolved = clip_tiles = zero
    clip_rounds = None  # (per-round failing-tile demand, per-round caps)
    if use_pallas:
        # setup + class-split binning over every drawn bucket, one payload
        # (frame.py:1073-1158); draw classes 0 opaque, 1 transmission, 2
        # alpha-clip, 3 transmission + alpha-clip
        mask = bucket_triangle_masks(
            dl.tri_inst, dl.tri_bucket, visible,
            (BUCKET_OPAQUE, BUCKET_ALPHA_CLIP, BUCKET_TRANSMISSION,
             BUCKET_TRANSMISSION_ALPHA_CLIP) if flags.has_transmission
            else (BUCKET_OPAQUE, BUCKET_ALPHA_CLIP),
        )
        is_clip = (dl.tri_bucket == BUCKET_ALPHA_CLIP) | (
            dl.tri_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP)
        tri_class = ((dl.tri_bucket == BUCKET_TRANSMISSION)
                     | (dl.tri_bucket == BUCKET_TRANSMISSION_ALPHA_CLIP)).to(torch.int32)
        tri_class = tri_class + 2 * is_clip.to(torch.int32)
        num_classes = 4 if flags.has_alpha_clip else 2
        # the clip peel's alpha test reads the uv channels
        uv_o = _sampled(flags.tex_slots) or flags.has_alpha_clip
        uv_t = _sampled(flags.tex_slots_transmission) or flags.has_alpha_clip
        with pass_scope("binning"):
            setup = setup_triangles(clip, dl.tri_vtx, mask, w, h, config.tile_w,
                                    config.tile_h)
            bins = bin_triangles(
                setup, tiles_x, tiles_y, config.pallas_tiles_per_tri, tri_class,
                num_classes, config.pallas_tiers, config.pallas_pair_cap_frac,
            )
            tier_overflow = zero
            for demand, slots in zip(bins.tier_demands, bins.tier_slots):
                tier_overflow = torch.maximum(tier_overflow, demand - slots)
        with pass_scope("payload"):
            records = pack_gbuf_payload(setup, dl.tri_vtx, dl.tri_material,
                                        tri_scale, world_pos, world_nrm, uvs,
                                        tri_class)
            gpayload = gather_gbuf_payload(records, bins)
        with pass_scope("raster_opaque"):
            g_o = rasterize_gbuffer_pallas(
                records, bins, w, h, pass_class=0, payload=gpayload,
                pos_derivs=flags.tex_slots[2], uv_channels=uv_o,
            )
        if flags.has_alpha_clip:
            with pass_scope("raster_clip_peel"):
                g_o, clip_unresolved, clip_tiles, clip_rounds, _ = _rasterize_clip_peeled(
                    scene, gpayload, bins, 0, 2, g_o, config, w, h,
                    pos_derivs=flags.tex_slots[2])
    else:
        # the visibility-buffer branch (frame.py:1159-1166): a setup and
        # materialised bins per pass, kernel 6 (with alpha clip its alpha
        # form in both passes, frame.py:1004-1006), interpolate_gbuffer
        alpha = vis_alpha(scene, dl, uvs) if flags.has_alpha_clip else None
        mask_o = bucket_triangle_masks(dl.tri_inst, dl.tri_bucket, visible,
                                       (BUCKET_OPAQUE, BUCKET_ALPHA_CLIP))
        g_o, bins_o = _visibility_pass(clip, dl, mask_o, tri_scale, world_pos,
                                       world_nrm, uvs, config, "raster_opaque", alpha=alpha)

    # ---- 3. clustered lighting --------------------------------------------
    coeffs, counts, indices = _cluster_lights(config, params, lights, dev)
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
        debug_clusters=config.debug_clusters,
        quad_taps=config.quad_material_taps,
        bf16_lights=config.bf16_light_math,
        half_res_refraction=config.half_res_refraction,
        pallas_shade=use_pallas if config.pallas_shade is None else config.pallas_shade,
    )

    # ---- 4. opaque shadow rays + shade (dense) ------------------------------
    if use_rt:
        half = config.half_res_shadow_rays
        if half and (h % 2 or w % 2):
            warnings.warn(f"half_res_shadow_rays requires even framebuffer dims; "
                          f"{w}x{h} traces FULL-res shadow rays", stacklevel=3)
        with pass_scope("shadow_rays_opaque"):
            if half and h % 2 == 0 and w % 2 == 0:
                # trace the half-res grid and upsample the factors; no
                # cluster or N.L gating, since the upsample reads each
                # factor at its neighbours too
                g_half = GBuffer(*(a[::2, ::2] for a in g_o))
                sun_h, light_h = shadow_factors(bvh, dl.tri_vtx, world_pos, g_half,
                                                params.sun_dir, lights)
                sun_f = _up2(_up2(sun_h, 0), 1)
                light_f = _up2(_up2(light_h, 0), 1)
            else:
                sun_f, light_f = shadow_factors(
                    bvh, dl.tri_vtx, world_pos, g_o, params.sun_dir, lights,
                    # pairs outside a pixel's cluster list are never read
                    light_active=cluster_light_mask(ctx, g_o.depth, *_pixel_grid(h, w, dev)),
                    # N.L gating needs the unperturbed normal (no normal map)
                    nol_gate=config.nol_shadow_gate and not flags.tex_slots[2],
                    packet_swizzle="2d",
                )
        ctx = ctx._replace(sun_shadow_factor=sun_f, light_shadow_factors=light_f)
    nb = num_blocks(h, w)
    cap_o = (min(int(np.ceil(nb * config.opaque_block_cap_frac)), nb)
             if config.opaque_block_cap_frac is not None else 0)
    opaque_blocks = zero
    with pass_scope("shade_opaque"):
        if cap_o:
            # block-sparse opaque shade: only blocks with coverage are
            # gathered and shaded (frame.py:1278-1322)
            wk_o = compact_blocks(g_o.valid, cap_o)
            opaque_blocks = wk_o.count
            ctx_f = ctx
            if ctx.sun_shadow_factor is not None:
                ctx_f = ctx_f._replace(
                    sun_shadow_factor=block_gather(wk_o, ctx.sun_shadow_factor))
            if ctx.light_shadow_factors is not None:
                ctx_f = ctx_f._replace(
                    light_shadow_factors=block_gather(wk_o, ctx.light_shadow_factors))
            planes = shade_opaque_flat(scene, _gather_gbuffer(wk_o, g_o), ctx_f,
                                       *pixel_coords(wk_o), *_block_coords(wk_o, w))
            blank = torch.zeros((h, w), dtype=torch.float32, device=dev)
            hdr_planes = tuple(block_scatter(wk_o, p, blank) for p in planes)
        else:
            hdr_planes = shade_opaque(scene, g_o, ctx)

    transmission_blocks = transmission_tiles = zero
    cap_t = cap_rt = 0
    if flags.has_transmission:
        # ---- 5. opaque mip pyramid over the static level set -------------
        level_set = refraction_level_set(flags, w, mip_levels_for_size(w, h))
        with pass_scope("mip_pyramid"):
            pyramid = build_pyramid(hdr_planes, level_set=level_set)
        ctx_t = ctx._replace(
            sun_shadow_factor=None, light_shadow_factors=None,
            tex_slots=flags.tex_slots_transmission,
            mat_matrix=build_material_matrix(
                scene, flags.tex_slots_transmission, flags.slot_bundles),
        )

        def transmission_shadows(g, px, py, swizzle):
            """ctx_t with the transmission pass's shadow factors over g's
            pixels, traced in the ``swizzle`` order (ctx_t without RT)."""
            if not use_rt:
                return ctx_t
            with pass_scope("shadow_rays_transmission"):
                sun_f_t, light_f_t = shadow_factors(
                    bvh, dl.tri_vtx, world_pos, g, params.sun_dir, lights,
                    light_active=cluster_light_mask(ctx_t, g.depth, px, py),
                    packet_swizzle=swizzle)
            return ctx_t._replace(sun_shadow_factor=sun_f_t, light_shadow_factors=light_f_t)

    fused = use_pallas and flags.has_transmission and _fused_transmission(config, flags)
    if use_pallas and flags.has_transmission:
        cap_rt = _tile_cap(config.transmission_tile_cap_frac, n_tiles,
                           config.sparse_raster_tile_floor)
    if fused:
        # ---- 6-7. fused sparse transmissive raster -> sparse shade ---------
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
                uv_channels=uv_t,
            )
        g_tf = gbuffer_from_channels({
            n: a.reshape((cap_rt * TILE_H * TILE_W,) + a.shape[3:])
            for n, a in sub_t.items()
        })
        # every 8-px tile row is one flat 128-px block (the fused path
        # needs w % 128 == 0); the pad block nb stands in for empty slots
        # and rows past the bottom
        bpr = w // BLOCK
        r8 = torch.arange(TILE_H, dtype=torch.int32, device=dev)
        prow = (ids_t // tiles_x)[:, None] * TILE_H + r8[None, :]
        ok_b = (ids_t[:, None] < n_tiles) & (prow < h)
        bids = torch.where(ok_b, prow * bpr + (ids_t % tiles_x)[:, None], nb).reshape(-1)
        wk_t = BlockWork(block_ids=bids, count=t_count * TILE_H, n_blocks=nb,
                         cap_b=cap_rt * TILE_H, shape=(h, w))
        with pass_scope("shade_transmission"):
            transmission_blocks = wk_t.count
            cap_t = wk_t.cap_b
            px_t, py_t = pixel_coords(wk_t)
            # every 1024 worklist lanes are one 8x128 raster tile
            ctx_tf = transmission_shadows(g_tf, px_t, py_t, "tiles")
            hdr_t = shade_transmission_flat(scene, g_tf, ctx_tf, pyramid, level_set,
                                            px_t, py_t, *_block_coords(wk_t, w))
            hdr_planes = _merge_blocks(wk_t, g_tf.valid, hdr_t, hdr_planes)
    elif flags.has_transmission:
        # ---- 6-7. transmissive raster seeded with the opaque depth, then
        # the compacted (or dense) shade (frame.py:1417-1463, 1470-1600) ----
        if use_pallas:
            pos_derivs_t = flags.tex_slots_transmission[2]
            with pass_scope("raster_transmission"):
                if cap_rt:
                    # sparse-tile raster: only tiles holding class-1 records
                    ch_t, transmission_tiles, _ = _rasterize_class_sparse(
                        gpayload, bins.tile_start, 0, 1, cap_rt,
                        tile_image(g_o.depth, TILE_W, TILE_H).contiguous(), w, h,
                        pos_derivs=pos_derivs_t, uv_channels=uv_t)
                    g_t = gbuffer_from_channels({
                        n: untile_image(a, tiles_x, tiles_y, TILE_W, TILE_H, w, h)
                        for n, a in ch_t.items()})
                else:
                    g_t = rasterize_gbuffer_pallas(
                        records, bins, w, h, pass_class=1, payload=gpayload,
                        init_depth=g_o.depth, pos_derivs=pos_derivs_t, uv_channels=uv_t)
            if flags.has_alpha_clip:
                # the reference peels class 3 whenever the scene has alpha
                # clip (frame.py:1439), with or without class-3 triangles
                with pass_scope("raster_clip_peel"):
                    g_t, miss, ct, rounds_t, _ = _rasterize_clip_peeled(
                        scene, gpayload, bins, 0, 3, g_t, config, w, h,
                        pos_derivs=pos_derivs_t)
                clip_unresolved = clip_unresolved + miss
                clip_tiles = torch.maximum(clip_tiles, ct)
                clip_rounds = (tuple(torch.maximum(a, b)
                                     for a, b in zip(clip_rounds[0], rounds_t[0])),
                               clip_rounds[1])
        else:
            mask_t = bucket_triangle_masks(
                dl.tri_inst, dl.tri_bucket, visible,
                (BUCKET_TRANSMISSION, BUCKET_TRANSMISSION_ALPHA_CLIP))
            g_t, bins_t = _visibility_pass(clip, dl, mask_t, tri_scale, world_pos,
                                           world_nrm, uvs, config, "raster_transmission",
                                           init_depth=g_o.depth, alpha=alpha)
        # a fraction of the blocks with a 256-block floor: at small frames
        # one 128-px block spans several rows, so coverage quantises up;
        # half-res refraction needs the dense shade's 2-D grid
        if config.transmission_block_cap_frac is not None and not config.half_res_refraction:
            cap_t = min(max(int(np.ceil(nb * config.transmission_block_cap_frac)), 256), nb)
        with pass_scope("shade_transmission"):
            if cap_t:
                wk_t = compact_blocks(g_t.valid, cap_t)
                transmission_blocks = wk_t.count
                g_tf = _gather_gbuffer(wk_t, g_t)
                px_t, py_t = pixel_coords(wk_t)
                # the worklist's pixels only, in its own order (frame.py:1529-1551)
                ctx_tf = transmission_shadows(g_tf, px_t, py_t, None)
                hdr_t = shade_transmission_flat(scene, g_tf, ctx_tf, pyramid, level_set,
                                                px_t, py_t, *_block_coords(wk_t, w))
                hdr_planes = _merge_blocks(wk_t, g_tf.valid, hdr_t, hdr_planes)
            else:
                # every pixel, in 8x16 groups (frame.py:1574-1590)
                ctx_td = transmission_shadows(g_t, *_pixel_grid(h, w, dev), "2d")
                hdr_t = shade_transmission(scene, g_t, ctx_td, pyramid, level_set)
                hdr_planes = tuple(torch.where(g_t.valid, hdr_t[..., c], hp)
                                   for c, hp in enumerate(hdr_planes))

    # ---- 8. tonemap ----------------------------------------------------------
    with pass_scope("tonemap"):
        ldr = torch.stack(lottes_tonemap_planes(hdr_planes, bake_lottes_params()), -1)
    out = (ldr,)
    if return_hdr:
        out += (torch.stack(hdr_planes, -1),)
    if return_diagnostics:
        if use_pallas:
            diag = dict(max_bin_count=zero, big_tri_count=bins.big_tri_count,
                        big_tri_capacity=config.pallas_tiers[-1][1],
                        mid_tri_count=bins.mid_tri_count,
                        mid_tri_capacity=config.pallas_max_mid_tris,
                        tier_overflow=tier_overflow, pair_demand=bins.pair_demand,
                        pair_capacity=bins.pair_capacity)
        else:
            passes = (bins_o, bins_t) if flags.has_transmission else (bins_o,)
            diag = dict(
                max_bin_count=torch.stack([b.max_bin_count for b in passes]).max(),
                big_tri_count=torch.stack([b.big_tri_count for b in passes]).max(),
                big_tri_capacity=config.max_big_tris, mid_tri_count=zero,
                mid_tri_capacity=0, tier_overflow=zero, pair_demand=zero,
                pair_capacity=0)
        clip_on = use_pallas and flags.has_alpha_clip
        out += (FrameDiagnostics(
            bin_capacity=config.max_tris_per_tile,
            opaque_blocks=opaque_blocks,
            opaque_block_capacity=cap_o,
            transmission_blocks=transmission_blocks,
            transmission_block_capacity=cap_t,
            clip_unresolved=clip_unresolved,
            transmission_tiles=transmission_tiles,
            transmission_tile_capacity=cap_rt,
            clip_tiles=clip_tiles,
            clip_tile_capacity=_tile_cap(config.clip_tile_cap_frac, n_tiles,
                                         config.sparse_raster_tile_floor) if clip_on else 0,
            clip_round_demand=clip_rounds[0] if clip_rounds else (),
            clip_round_caps=clip_rounds[1] if clip_rounds else (),
            **diag,
        ),)
    return out[0] if len(out) == 1 else out
