"""Deferred shading passes — the fragment-shader equivalents.

Counterpart of ``transmission_renderer_tpu/render/shading.py``:
ShadeContext, build_material_matrix, _meta_rows_from, used_meta_cols,
bundle_tap_samples, the ray-traced shadows' cluster gate (_cluster_index,
_cluster_rows, cluster_light_mask), and both bodies of shade_opaque_flat,
shade_opaque, shade_transmission_flat and shade_transmission:

- the kernel path (``ctx.pallas_shade``): the material taps (kernel 2),
  the fused shade (kernel 3), the pyramid + GGX-LUT fetch (kernel 4) and
  the combine tail (shading.py:840-893, 952-1043);
- the tensor path (the reference's XLA formulation, shading.py:894-919,
  1067-1118): _evaluate_pixel_material with _normal_mapped,
  _light_matrix and _evaluate_lights_common over pbr/brdf.py, and the
  cluster false colour of ``debug_clusters`` (shading.py:909-914), with
  the quality flags: ``quad_taps`` (one material tap per 2x2 quad, dense
  opaque shade, shading.py:333-360), ``bf16_lights`` (the BRDF/BTDF cores
  in bfloat16, shading.py:606-650) and ``half_res_refraction`` (the dense
  transmission shade's half-res framebuffer fetch, shading.py:1140-1147).

With per-pixel (textured) transmissive roughness there is no static
pyramid level set: both paths then fetch the whole pyramid (kernel 4's
launch over every level on the kernel path, sample_pyramid_lod over every
level on the tensor path).

A pass takes the kernel path where the reference does
(``_kernel_path_taps``): with ``ctx.pallas_shade`` (frame.py:1215-1217),
single-row 128-px blocks, and a configuration that the reference's static
gate ``pallas_shade_supported`` takes; every other pass, on either
branch, shades through the tensor path over the same worklist. The
reference's one-hot matmul row fetch (onehot_rows) is its TPU form of a
row gather; here it is the gather.

Cluster x/y divide by the cluster size as the reference's compiled frame
does (a multiply by the float32 reciprocal), on both paths.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from transmission_renderer_tpu_torch.ops.mipchain import MipPyramid, sample_pyramid_lod
from transmission_renderer_tpu_torch.ops.tap_finish import (
    sample_bundle_planes,
    transmission_fetch_planes,
)
from transmission_renderer_tpu_torch.ops.texture import (
    WRAP_REPEAT,
    atlas_classes,
    sample_bundle_rows,
    sample_lut_2ch,
    select_layer,
)
from transmission_renderer_tpu_torch.pbr.brdf import (
    MaterialParams,
    _sum3,
    apply_volume_attenuation,
    basic_brdf,
    ibl_volume_refraction,
    light_direction_and_attenuation,
    material_invariants,
    transmission_btdf,
)
from transmission_renderer_tpu_torch.pbr.clustering import ClusterCoefficients
from transmission_renderer_tpu_torch.pbr.lights import Lights, spotlight_factor
from transmission_renderer_tpu_torch.render import checks
from transmission_renderer_tpu_torch.render.gbuffer import GBuffer
from transmission_renderer_tpu_torch.render.shade_kernel import (
    _light_matrix,
    pallas_shade_supported,
    pixel_clusters,
    shade_opaque_pallas_planes,
    shade_spec,
    shade_transmission_pallas_pre,
)
from transmission_renderer_tpu_torch.render.sparse import block_origins
from transmission_renderer_tpu_torch.scene.textures import IMAGE_MASK, LAYER_SHIFT, MAX_MIPS
from transmission_renderer_tpu_torch.scene.types import Scene
from transmission_renderer_tpu_torch.utils.profiling import pass_scope


class ShadeContext(NamedTuple):
    """Per-frame shading uniforms (PushConstants + Uniforms,
    shared-structs/src/lib.rs:11-29)."""

    view_position: torch.Tensor  # [3]
    proj_view: torch.Tensor  # [4, 4]
    sun_dir: torch.Tensor  # [3]
    sun_intensity: torch.Tensor  # [3]
    framebuffer_size: tuple  # static (W, H)
    cluster_size_in_pixels: tuple
    num_clusters_xy: tuple
    cluster_coeffs: ClusterCoefficients
    cluster_light_counts: torch.Tensor  # [C] int32
    cluster_light_indices: torch.Tensor  # [C, K] int32
    lights: Lights
    ggx_lut: torch.Tensor  # [S, S, 2]
    tex_slots: tuple = (True,) * 9
    mat_matrix: "MaterialMatrix | None" = None
    debug_clusters: bool = False
    # the quality flags (RenderConfig.quad_material_taps, bf16_light_math,
    # half_res_refraction)
    quad_taps: bool = False
    bf16_lights: bool = False
    half_res_refraction: bool = False
    # ray-traced shadows (render/raytrace.py::shadow_factors): 1 lit, 0
    # shadowed; the sun's [...] and each light's [..., L]
    sun_shadow_factor: torch.Tensor | None = None
    light_shadow_factors: torch.Tensor | None = None
    # the kernel path (kernels 2-4); False: the tensor path
    pallas_shade: bool = False


def _cluster_index(ctx: ShadeContext, depth, px, py) -> torch.Tensor:
    """Fragment -> cluster id (shader/src/lib.rs:205-215) from integer
    pixel coordinates, computed exactly as the shade kernel computes it
    (render/shade_kernel.py::pixel_clusters), so the gate below and the
    light loop agree on every pixel's cluster."""
    return pixel_clusters(shade_spec(ctx), depth, px.to(torch.float32),
                          py.to(torch.float32))


def _cluster_rows(ctx: ShadeContext, depth, px, py):
    """(cluster ids, [..., S] light ids of each pixel's cluster list,
    counts, S) with S = min(L, list width): the layout the light loop
    reads."""
    cluster = _cluster_index(ctx, depth, px, py).long()
    max_slots = min(ctx.lights.num, ctx.cluster_light_indices.shape[1])
    rows = ctx.cluster_light_indices[:, :max_slots].to(torch.int32)[cluster]
    counts = ctx.cluster_light_counts.to(torch.int32)[cluster]
    return cluster, rows, counts, max_slots


def cluster_light_mask(ctx: ShadeContext, depth, px, py) -> torch.Tensor:
    """[..., L] bool: light l is in the pixel's cluster light list.

    The light loop multiplies a light outside the list by 0, so its
    shadow factor is never read and its shadow ray need not be traced:
    render_frame zeroes t_max on those (pixel, light) pairs, and the
    image is the same bit for bit."""
    _, rows, counts, max_slots = _cluster_rows(ctx, depth, px, py)
    lids = torch.arange(ctx.lights.num, dtype=torch.int32, device=rows.device)
    mask = torch.zeros((*counts.shape, ctx.lights.num), dtype=torch.bool,
                       device=rows.device)
    for s in range(max_slots):
        mask |= (rows[..., s : s + 1] == lids) & (s < counts)[..., None]
    return mask


def _mip_lod(duv_dx, duv_dy, tex_w, tex_h):
    """Implicit LOD: log2 of the max screen-space texel footprint."""
    size = torch.stack([tex_w, tex_h], dim=-1).to(torch.float32)
    fx = duv_dx * size
    fy = duv_dy * size
    rho = torch.maximum(
        fx[..., 0] * fx[..., 0] + fx[..., 1] * fx[..., 1],
        fy[..., 0] * fy[..., 0] + fy[..., 1] * fy[..., 1],
    )
    return 0.5 * torch.log2(torch.clamp(rho, min=1e-12))


# texture slots of the material matrix, in column order (occlusion is
# loaded but never applied, as in the reference)
_MAT_SLOTS = (
    "tex_diffuse", "tex_metallic_roughness", "tex_normal_map",
    "tex_emissive", "tex_transmission", "tex_thickness",
    "tex_specular", "tex_specular_colour",
)
_SLOT_FLAG_POS = (0, 1, 2, 3, 5, 6, 7, 8)
_META_BLOCK = 5 + 2 * MAX_MIPS
_META_W = 5 + MAX_MIPS


MATERIAL_META_SITE = ("render/shading.py::build_material_matrix: a material texture's "
                      "atlas image past the atlas meta")


class MaterialMatrix(NamedTuple):
    table: torch.Tensor  # [n_mat, C] float32, inf-free
    meta_col: dict  # slot name -> column of its meta block (or None)


def build_material_matrix(scene: Scene, tex_slots: tuple,
                          slot_bundles: tuple = ()) -> MaterialMatrix:
    """Material factors, texture ids and per-used-slot-group texture
    metadata in one float32 matrix: [0:21] factors (col 20 flags an
    infinite attenuation distance), [21:29] texture refs, then one
    31-column meta block per used slot group (offsets split into 12-bit
    halves)."""
    m = scene.materials

    def col(x):
        return x[:, None].to(torch.float32)

    att = m.attenuation_distance
    att_isinf = torch.isinf(att)
    cols = [
        col(m.metallic_factor), col(m.roughness_factor), m.diffuse_factor,
        m.emissive_factor, col(m.index_of_refraction),
        col(m.transmission_factor), col(m.thickness_factor),
        col(torch.where(att_isinf, 0.0, att)), m.attenuation_colour,
        col(m.specular_factor), m.specular_colour_factor, col(att_isinf),
        torch.stack([getattr(m, n) for n in _MAT_SLOTS], dim=1).to(torch.float32),
    ]
    group_of = {name: (name,) for name in _MAT_SLOTS}
    for group in slot_bundles:
        for name in group:
            group_of[name] = tuple(group)
    meta_col = {}
    c = 29
    for name, flag_pos in zip(_MAT_SLOTS, _SLOT_FLAG_POS):
        if not tex_slots[flag_pos]:
            meta_col[name] = None
            continue
        if name in meta_col:
            continue
        group = group_of[name]
        tid = getattr(m, name)
        for other in group:
            tid = torch.maximum(tid, getattr(m, other))
        img = checks.index((torch.clamp(tid, min=0) & IMAGE_MASK).long(),
                           scene.atlas_meta.shape[0], MATERIAL_META_SITE, used=tid >= 0)
        rows = scene.atlas_meta[img][:, :_META_W].to(torch.int32)
        offs = rows[:, 4 : 4 + MAX_MIPS]
        cols.append(torch.cat([
            rows[:, :4].to(torch.float32),
            (offs >> 12).to(torch.float32),
            (offs & 0xFFF).to(torch.float32),
            rows[:, 4 + MAX_MIPS :].to(torch.float32),
        ], dim=1))
        for member in group:
            if member in _MAT_SLOTS:
                meta_col[member] = c
        c += _META_BLOCK
    return MaterialMatrix(table=torch.cat(cols, dim=1), meta_col=meta_col)


def _meta_rows_from(mrow: torch.Tensor, col: int) -> torch.Tensor:
    """Decode a meta block back to int32 [..., META_COLS] atlas rows."""
    head = mrow[..., col : col + 4].to(torch.int32)
    hi = mrow[..., col + 4 : col + 4 + MAX_MIPS].to(torch.int32)
    lo = mrow[..., col + 4 + MAX_MIPS : col + 4 + 2 * MAX_MIPS].to(torch.int32)
    layers = mrow[..., col + 4 + 2 * MAX_MIPS : col + _META_BLOCK].to(torch.int32)
    return torch.cat([head, (hi << 12) | lo, layers], dim=-1)


def used_meta_cols(mat_matrix: MaterialMatrix, tex_slots: tuple) -> list:
    """Distinct meta columns the active slots read, in _MAT_SLOTS order."""
    used = []
    for name, flag_pos in zip(_MAT_SLOTS, _SLOT_FLAG_POS):
        if not tex_slots[flag_pos]:
            continue
        c = mat_matrix.meta_col[name]
        if c is not None and c not in used:
            used.append(c)
    return used


def bundle_tap_samples(scene: Scene, g: GBuffer, tex_slots: tuple,
                       mat_matrix: MaterialMatrix) -> list:
    """The material texture taps (kernel 2) for the fused shade: one list
    of 4 * Lmax [M] planes per used meta block."""
    used = used_meta_cols(mat_matrix, tex_slots)
    if not used:
        return []
    classes = atlas_classes(scene.atlas_meta)
    mrow = mat_matrix.table[g.material_id.long()]
    out = []
    for c in used:
        rows = _meta_rows_from(mrow, c).contiguous()
        lod = _mip_lod(g.duv_dx, g.duv_dy, rows[..., 2], rows[..., 3])
        out.append(sample_bundle_planes(
            scene.atlas_texels, rows, g.uv.contiguous(), lod.contiguous(),
            WRAP_REPEAT, classes,
        ))
    return out


def _kernel_path_taps(scene: Scene, g: GBuffer, ctx: ShadeContext, block_py):
    """The reference's choice of the fused shade kernel for a pass
    (shading.py:850-861 opaque, :966-977 transmission): with
    ``pallas_shade``, single-row 128-px block coordinates and a
    configuration the static gate ``pallas_shade_supported`` takes, the
    material taps (kernel 2) for the kernel; else None, and the pass
    shades through the tensor path over the same worklist. The
    reference's taps also return an ``ok`` that is always True
    (shading.py:773-839), so the gate alone decides. A static choice on
    the configuration, never on a launch's outcome."""
    if not ctx.pallas_shade or block_py is None or ctx.mat_matrix is None:
        return None
    if not pallas_shade_supported(ctx, int(ctx.mat_matrix.table.shape[0]),
                                  ctx.framebuffer_size[0]):
        return None
    with pass_scope("material_taps"):
        return bundle_tap_samples(scene, g, ctx.tex_slots, ctx.mat_matrix)


# the cluster false colours (shader/src/lib.rs:647-664)
_DEBUG_COLOURS = (
    (0.0, 0.0, 0.0), (0.0, 0.0, 0.1647), (0.0, 0.0, 0.3647), (0.0, 0.0, 0.6647),
    (0.0, 0.0, 0.9647), (0.0, 0.9255, 0.9255), (0.0, 0.5647, 0.0), (0.0, 0.7843, 0.0),
    (1.0, 1.0, 0.0), (0.90588, 0.75294, 0.0), (1.0, 0.5647, 0.0), (1.0, 0.0, 0.0),
    (0.8392, 0.0, 0.0), (1.0, 0.0, 1.0), (0.6, 0.3333, 0.7882),
)


# ---------------------------------------------------------------------------
# the tensor path (the reference's XLA shading)
# ---------------------------------------------------------------------------

def _normalize_safe(v: torch.Tensor) -> torch.Tensor:
    """v / max(|v|, 1e-12)."""
    return v / torch.clamp(torch.sqrt(_sum3(v * v)), min=1e-12)[..., None]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


class PixelMaterial(NamedTuple):
    params: MaterialParams
    diffuse_alpha: torch.Tensor
    emission: torch.Tensor
    transmission_factor: torch.Tensor
    thickness: torch.Tensor
    attenuation_distance: torch.Tensor
    attenuation_colour: torch.Tensor
    normal: torch.Tensor  # shading normal after normal mapping


def _quad_representative(valid: torch.Tensor, h: int, w: int):
    """rep(x): each 2x2 quad's first valid pixel (argmax of its valid
    flags, the quad's first pixel when none is) of a flat row-major
    [h * w, ...] array -> [h/2 * w/2, ...] (shading.py:333-351)."""
    vq = valid.reshape(h // 2, 2, w // 2, 2).transpose(1, 2).reshape(h // 2, w // 2, 4)
    choice = torch.argmax(vq.to(torch.int32), dim=-1)

    def rep(x):
        rest = x.shape[1:]
        x4 = x.reshape(h // 2, 2, w // 2, 2, *rest).transpose(1, 2)
        x4 = x4.reshape(h // 2, w // 2, 4, *rest)
        idx = choice.reshape(h // 2, w // 2, 1, *(1,) * len(rest)).expand(
            h // 2, w // 2, 1, *rest)
        return torch.gather(x4, 2, idx)[:, :, 0].reshape(-1, *rest)

    return rep


def _evaluate_pixel_material(scene: Scene, g: GBuffer, tex_slots: tuple = (True,) * 9,
                             mat_matrix: MaterialMatrix | None = None,
                             quad_shape: tuple | None = None) -> PixelMaterial:
    """Per-pixel material on a flat [M] G-buffer: the factor and texture
    fetches and the normal map of get_material_params / get_emission /
    calculate_normal (shader/src/lighting.rs:222-313) and the transmission
    and thickness taps of fragment_transmission (shader/src/lib.rs:120-124).
    ``tex_slots`` skips the taps of slots no material uses; slots sharing
    a meta block (one bundle image) share one tap. ``quad_shape`` (h, w),
    for a dense row-major frame: one tap per 2x2 quad at its
    representative pixel's uv, lod and meta row, shared by its 4 pixels
    (``quad_material_taps``)."""
    mm = mat_matrix if mat_matrix is not None else build_material_matrix(scene, tex_slots)
    (use_diffuse, use_mr, use_normal, use_emissive, _use_occlusion,
     use_transmission, use_thickness, use_specular, use_specular_colour) = tex_slots
    mrow = mm.table[g.material_id.long()]
    classes = atlas_classes(scene.atlas_meta)
    taps: dict = {}
    rep = None if quad_shape is None else _quad_representative(g.valid, *quad_shape)

    def tex4(slot_idx):
        tid = mrow[..., 21 + slot_idx].to(torch.int32)
        col = mm.meta_col[_MAT_SLOTS[slot_idx]]
        if col not in taps:
            rows = _meta_rows_from(mrow, col)
            lod = _mip_lod(g.duv_dx, g.duv_dy, rows[..., 2], rows[..., 3])
            if quad_shape is None:
                taps[col] = sample_bundle_rows(scene.atlas_texels, rows, g.uv, lod,
                                               WRAP_REPEAT, classes)
            else:
                h, w = quad_shape
                s_q = sample_bundle_rows(scene.atlas_texels, rep(rows), rep(g.uv), rep(lod),
                                         WRAP_REPEAT, classes)  # [M/4, L, 4]
                n_layers = s_q.shape[1]
                taps[col] = s_q.reshape(h // 2, 1, w // 2, 1, n_layers, 4).expand(
                    h // 2, 2, w // 2, 2, n_layers, 4).reshape(-1, n_layers, 4)
        bundle = taps[col]
        if max(classes) == 1:
            return tid, bundle[..., 0, :]
        return tid, select_layer(bundle, torch.clamp(tid, min=0) >> LAYER_SHIFT)

    def hit(tid, new, old):
        return torch.where((tid >= 0)[..., None] if old.dim() > tid.dim() else tid >= 0,
                           new, old)

    diffuse = mrow[..., 2:6]
    if use_diffuse:
        tid, smp = tex4(0)
        diffuse = hit(tid, diffuse * smp, diffuse)
    # metallic / roughness read B / G (shader/src/lighting.rs:269-277)
    metallic, roughness = mrow[..., 0], mrow[..., 1]
    if use_mr:
        tid, smp = tex4(1)
        metallic = hit(tid, metallic * smp[..., 2], metallic)
        roughness = hit(tid, roughness * smp[..., 1], roughness)
    specular_colour = mrow[..., 17:20]
    if use_specular_colour:
        tid, smp = tex4(7)
        specular_colour = hit(tid, specular_colour * smp[..., :3], specular_colour)
    specular_factor = mrow[..., 16]
    if use_specular:
        tid, smp = tex4(6)
        specular_factor = hit(tid, specular_factor * smp[..., 3], specular_factor)
    emission = mrow[..., 6:9]
    if use_emissive:
        tid, smp = tex4(3)
        emission = hit(tid, emission * smp[..., :3], emission)
    transmission_factor = mrow[..., 10]
    if use_transmission:
        tid, smp = tex4(4)
        transmission_factor = hit(tid, transmission_factor * smp[..., 0], transmission_factor)
    thickness = mrow[..., 11]
    if use_thickness:
        tid, smp = tex4(5)
        thickness = hit(tid, thickness * smp[..., 1], thickness)
    normal = _normalize_safe(g.normal)
    if use_normal:
        normal = _normal_mapped(g, normal, tex4)
    params = MaterialParams(
        diffuse_colour=diffuse[..., :3], metallic=metallic, perceptual_roughness=roughness,
        index_of_refraction=mrow[..., 9], specular_colour=specular_colour,
        specular_factor=specular_factor,
    )
    return PixelMaterial(
        params=params, diffuse_alpha=diffuse[..., 3], emission=emission,
        transmission_factor=transmission_factor, thickness=thickness,
        attenuation_distance=torch.where(mrow[..., 20] > 0.5, torch.inf, mrow[..., 12]),
        attenuation_colour=mrow[..., 13:16], normal=normal,
    )


def _normal_mapped(g: GBuffer, normal: torch.Tensor, tex4) -> torch.Tensor:
    """Normal mapping through the screen-space cotangent frame
    (shader/src/lighting.rs:243-259) from the analytic derivatives."""
    tid, smp = tex4(2)
    map_normal = smp[..., :3] * (255.0 / 127.0) - (128.0 / 127.0)
    dp2perp = _cross(g.dpos_dy, normal)
    dp1perp = _cross(normal, g.dpos_dx)
    t = dp2perp * g.duv_dx[..., 0:1] + dp1perp * g.duv_dy[..., 0:1]
    bt = dp2perp * g.duv_dx[..., 1:2] + dp1perp * g.duv_dy[..., 1:2]
    invmax = 1.0 / torch.sqrt(torch.clamp(torch.maximum(_sum3(t * t), _sum3(bt * bt)),
                                          min=1e-20))
    mapped = (t * invmax[..., None] * map_normal[..., 0:1]
              + bt * invmax[..., None] * map_normal[..., 1:2]
              + normal * map_normal[..., 2:3])
    return torch.where((tid >= 0)[..., None], _normalize_safe(mapped), normal)


def _evaluate_lights_common(ctx: ShadeContext, material: MaterialParams, view, position,
                            normal, depth, px, py, with_transmission: bool):
    """The clustered light loop of both fragment shaders (evaluate_lights
    / evaluate_lights_transmission, shader/src/lighting.rs:13-95,
    145-220) on flat [M] pixels -> (BrdfResult, transmission [M, 3] or
    None, cluster ids, light counts). Slot s reads the cluster's s-th
    light; slots past the count add exact zeros. With ``ctx.bf16_lights``
    the BRDF/BTDF cores run in bfloat16 on bfloat16 casts of the
    material, normal, view, light direction and radiance; the per-light
    radiance and the accumulation stay float32 (shading.py:606-650)."""
    cluster, rows, counts, max_slots = _cluster_rows(ctx, depth, px, py)
    sun_factor = (ctx.sun_shadow_factor if ctx.sun_shadow_factor is not None
                  else torch.ones_like(depth))
    if not with_transmission and ctx.sun_shadow_factor is not None:
        sun_factor = torch.clamp(sun_factor, min=0.1)  # lighting.rs:166
    cdt = torch.bfloat16 if ctx.bf16_lights else torch.float32
    material_c = MaterialParams(*(f.to(cdt) for f in material))
    normal_c, view_c = normal.to(cdt), view.to(cdt)
    inv = material_invariants(material_c)
    sun_intensity = ctx.sun_intensity * sun_factor[..., None]
    sun_dir = ctx.sun_dir.expand(position.shape).to(cdt)
    result = basic_brdf(normal_c, sun_dir, sun_intensity.to(cdt), view_c, material_c, inv=inv)
    transmission = None
    if with_transmission:
        transmission = sun_intensity * transmission_btdf(material_c, normal_c, view_c, sun_dir,
                                                         inv=inv)
    lmat = _light_matrix(ctx.lights)
    for slot in range(max_slots):
        light_idx = rows[..., slot].long()
        lrow = lmat[light_idx]  # [M, 12]
        direction, _, attenuation = light_direction_and_attenuation(position, lrow[..., 0:3])
        factor = torch.where(slot < counts, 1.0, 0.0)
        if ctx.light_shadow_factors is not None:
            factor = factor * torch.gather(ctx.light_shadow_factors, -1,
                                           light_idx[..., None])[..., 0]
        if not with_transmission:
            # only evaluate_lights applies the spot factor (lighting.rs:201-203)
            eps = torch.where(lrow[..., 10] == 0.0, 1.0, lrow[..., 10])
            spot = spotlight_factor(direction, lrow[..., 6:9], lrow[..., 9], eps)
            factor = factor * torch.where(lrow[..., 11] > 0.5, spot, 1.0)
        radiance = lrow[..., 3:6] * factor[..., None] * attenuation[..., None]
        direction_c = direction.to(cdt)
        result = result + basic_brdf(normal_c, direction_c, radiance.to(cdt), view_c,
                                     material_c, inv=inv)
        if with_transmission:
            transmission = transmission + radiance * transmission_btdf(
                material_c, normal_c, view_c, direction_c, inv=inv)
    return result, transmission, cluster, counts


def _dense_coords(h: int, w: int, device) -> tuple:
    """Flat int32 (px, py) of a dense [H, W] frame."""
    px = torch.arange(w, dtype=torch.int32, device=device)[None, :].expand(h, w).reshape(-1)
    py = torch.arange(h, dtype=torch.int32, device=device)[:, None].expand(h, w).reshape(-1)
    return px, py


def _flatten_ctx_factors(ctx: ShadeContext) -> ShadeContext:
    """Flatten [H, W]-shaped shadow factors for the flat shaders."""
    rep = {}
    if ctx.sun_shadow_factor is not None and ctx.sun_shadow_factor.dim() == 2:
        rep["sun_shadow_factor"] = ctx.sun_shadow_factor.reshape(-1)
    if ctx.light_shadow_factors is not None and ctx.light_shadow_factors.dim() == 3:
        f = ctx.light_shadow_factors
        rep["light_shadow_factors"] = f.reshape(-1, f.shape[-1])
    return ctx._replace(**rep) if rep else ctx


def _view_dir(ctx: ShadeContext, g: GBuffer) -> torch.Tensor:
    return _normalize_safe(ctx.view_position - g.position)


# ---------------------------------------------------------------------------
# the shaders
# ---------------------------------------------------------------------------

def shade_opaque_flat(scene: Scene, g: GBuffer, ctx: ShadeContext, px, py,
                      block_py: torch.Tensor | None = None,
                      block_px0: torch.Tensor | None = None,
                      quad_shape: tuple | None = None) -> tuple:
    """The opaque PBR fragment shader (shader/src/lib.rs:164-249) over a
    flat [M] worklist -> (r, g, b) [M] planes, 0 on invalid pixels. The
    kernel path needs ``block_py`` / ``block_px0`` (the framebuffer row
    and first x of each single-row 128-px block); ``quad_shape`` (a
    dense frame's (h, w)) shares one material tap per 2x2 quad."""
    samples = None if quad_shape is not None else _kernel_path_taps(scene, g, ctx, block_py)
    if samples is not None:
        return shade_opaque_pallas_planes(
            scene, g, ctx, block_py, block_px0, samples, ctx.tex_slots
        )
    view = _view_dir(ctx, g)
    pm = _evaluate_pixel_material(scene, g, ctx.tex_slots, ctx.mat_matrix, quad_shape)
    result, _, cluster, counts = _evaluate_lights_common(
        ctx, pm.params, view, g.position, pm.normal, g.depth, px, py, False)
    out = result.diffuse + result.specular + pm.emission
    if ctx.debug_clusters:
        # the cluster false colour (shader/src/lib.rs:241-245)
        colours = torch.tensor(_DEBUG_COLOURS, dtype=torch.float32, device=out.device)
        c1 = colours[(counts.to(torch.int32) % 15).long()]
        c2 = colours[(cluster % 15).long()]
        out = c1 + (c2 - 0.5) * 0.025
    out = torch.where(g.valid[..., None], out, 0.0)
    return tuple(out[:, c] for c in range(3))


def flatten_gbuffer(g: GBuffer) -> GBuffer:
    h, w = g.depth.shape
    return GBuffer(*[a.reshape((h * w,) + a.shape[2:]) for a in g])


def shade_opaque(scene: Scene, g: GBuffer, ctx: ShadeContext) -> tuple:
    """Dense [H, W] opaque shade -> (r, g, b) [H, W] planes; the only
    pass that shares quad taps (``ctx.quad_taps``, even frames)."""
    h, w = g.depth.shape
    dev = g.depth.device
    px, py = _dense_coords(h, w, dev)
    block_py, block_px0 = block_origins(
        torch.arange((h * w) // 128, dtype=torch.int32, device=dev), w)
    quad = (h, w) if ctx.quad_taps and h % 2 == 0 and w % 2 == 0 else None
    planes = shade_opaque_flat(scene, flatten_gbuffer(g), _flatten_ctx_factors(ctx), px, py,
                               block_py, block_px0, quad)
    return tuple(p.reshape(h, w) for p in planes)


def _transmission_kernel_path(scene, g, ctx, pyramid, level_set, block_py, block_px0,
                              samples):
    """The fused pre-shade (kernel 3) over the material taps, the pyramid
    + GGX-LUT fetch (kernel 4), then the combine tail
    (shading.py:952-1043)."""
    p = shade_transmission_pallas_pre(
        scene, g, ctx, block_py, block_px0, samples, ctx.tex_slots
    )

    def v3(a, b, c):
        return torch.stack([p[a], p[b], p[c]], dim=-1)

    t_r, t_g, t_b, b_a, b_b = transmission_fetch_planes(
        pyramid, level_set, p["uv_x"], p["uv_y"], p["lod"], p["nov"],
        p["rough"], ctx.ggx_lut,
    )
    transmitted = torch.stack([t_r, t_g, t_b], dim=-1)
    brdf = torch.stack([b_a, b_b], dim=-1)
    attenuated = apply_volume_attenuation(
        transmitted, p["ray_len"], p["att_dist"], v3("att_r", "att_g", "att_b")
    )
    specular_colour = (
        v3("f0_r", "f0_g", "f0_b") * brdf[..., 0:1]
        + v3("f90_r", "f90_g", "f90_b") * brdf[..., 1:2]
    )
    ibl = (1.0 - specular_colour) * attenuated * v3("dc_r", "dc_g", "dc_b")
    transmission = v3("t_r", "t_g", "t_b") + ibl
    tf = p["tf"][..., None]
    real_transmission = tf * transmission
    d = v3("d_r", "d_g", "d_b")
    diffuse = d + (real_transmission - d) * tf
    out = diffuse + v3("s_r", "s_g", "s_b") + v3("em_r", "em_g", "em_b")
    return torch.where(g.valid[..., None], out, 0.0)


def shade_transmission_flat(scene: Scene, g: GBuffer, ctx: ShadeContext,
                            pyramid: MipPyramid, level_set: tuple | None, px, py,
                            block_py: torch.Tensor | None = None,
                            block_px0: torch.Tensor | None = None,
                            fb_sampler=None) -> torch.Tensor:
    """The transmission fragment shader (shader/src/lib.rs:37-162) over a
    flat [M] worklist -> [M, 3] HDR (0 on invalid pixels); the opaque
    pyramid is fetched over its static ``level_set``, or over every level
    when it is None (per-pixel roughness). ``fb_sampler`` (uv [M, 2], lod
    [M]) -> [M, 3] replaces the pyramid fetch on the tensor path."""
    samples = _kernel_path_taps(scene, g, ctx, block_py)
    if samples is not None:
        return _transmission_kernel_path(scene, g, ctx, pyramid, level_set, block_py,
                                         block_px0, samples)
    view = _view_dir(ctx, g)
    pm = _evaluate_pixel_material(scene, g, ctx.tex_slots, ctx.mat_matrix)
    result, transmission, _, _ = _evaluate_lights_common(
        ctx, pm.params, view, g.position, pm.normal, g.depth, px, py, True)
    transmission = transmission + ibl_volume_refraction(
        pm.params, ctx.framebuffer_size[0], pm.normal, view, ctx.proj_view, g.position,
        pm.thickness, g.model_scale, pm.attenuation_distance, pm.attenuation_colour,
        fb_sampler or (lambda uv, lod: sample_pyramid_lod(pyramid, uv, lod, level_set)),
        lambda nov, rough: sample_lut_2ch(ctx.ggx_lut, nov, rough),
    )
    tf = pm.transmission_factor[..., None]
    diffuse = result.diffuse + (tf * transmission - result.diffuse) * tf
    out = diffuse + result.specular + pm.emission
    return torch.where(g.valid[..., None], out, 0.0)


@functools.lru_cache(maxsize=8)
def _linear_resize_taps(n_in: int, n_out: int) -> tuple:
    """The two taps per output sample of ``jax.image.resize(..., "linear")``
    along one axis upsampled from n_in to n_out (half-pixel centres, the
    triangle kernel, weights renormalised where a tap falls outside),
    computed in float32 as jax's compiled weight matrix is (the sample
    position's multiply-subtract contracted to one rounding) -> (index 0,
    index 1, weight 0, weight 1), each [n_out]."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    centre = (np.arange(n_out, dtype=f32) + f32(0.5)).astype(np.float64)
    sample = (centre * np.float64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    wts = np.maximum(f32(0.0), f32(1.0) - x)
    total = wts.sum(axis=0, keepdims=True, dtype=f32)
    wts = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                   wts / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    wts = np.where(inside[None, :], wts, f32(0.0)).astype(f32)
    # at most two inputs lie within one texel of a sample when upsampling
    i0 = np.clip(np.floor(sample), 0, n_in - 1).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    cols = np.arange(n_out)
    w0 = wts[i0, cols]
    w1 = np.where(i1 != i0, wts[i1, cols], f32(0.0))
    assert np.count_nonzero(wts) == np.count_nonzero(w0) + np.count_nonzero(w1)
    return i0, i1, w0, w1


def upsample_linear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[h2, w2, C] -> [h, w, C]: ``jax.image.resize(img, (h, w, C),
    "linear")`` for an upsample, axis by axis."""
    def along(a, axis, n_out):
        i0, i1, w0, w1 = (torch.from_numpy(t).to(a.device)
                          for t in _linear_resize_taps(a.shape[axis], n_out))
        shape = [1] * a.dim()
        shape[axis] = n_out
        return (a.index_select(axis, i0) * w0.reshape(shape)
                + a.index_select(axis, i1) * w1.reshape(shape))

    return along(along(img, 0, h), 1, w)


def shade_transmission(scene: Scene, g: GBuffer, ctx: ShadeContext,
                       pyramid: MipPyramid, level_set: tuple | None) -> torch.Tensor:
    """Dense [H, W] transmission shade -> [H, W, 3]. With
    ``ctx.half_res_refraction`` the pyramid is fetched at every second
    pixel of every second row and upsampled (shading.py:1140-1147),
    through the tensor path."""
    h, w = g.depth.shape
    dev = g.depth.device
    px, py = _dense_coords(h, w, dev)
    block_py = block_px0 = fb_sampler = None
    if ctx.half_res_refraction:
        def fb_sampler(uv, lod):
            uv2 = uv.reshape(h, w, 2)[::2, ::2]
            lod2 = lod.reshape(h, w)[::2, ::2]
            c = sample_pyramid_lod(pyramid, uv2, lod2, level_set)
            return upsample_linear(c, h, w).reshape(-1, 3)
    else:
        block_py, block_px0 = block_origins(
            torch.arange((h * w) // 128, dtype=torch.int32, device=dev), w)
    out = shade_transmission_flat(scene, flatten_gbuffer(g), _flatten_ctx_factors(ctx),
                                  pyramid, level_set, px, py, block_py, block_px0,
                                  fb_sampler)
    return out.reshape(h, w, 3)
