"""Deferred shading passes on the fused-kernel path.

Counterpart of ``transmission_renderer_tpu/render/shading.py``, the main
path's subset: ShadeContext, _mip_lod, build_material_matrix,
_meta_rows_from, used_meta_cols, bundle_tap_samples, shade_opaque /
shade_opaque_flat down the kernel path (shading.py:840-893) and
_shade_transmission_kernel_path with its combine tail
(shading.py:952-1043).

The reference's XLA shading path (evaluate_pixel_material,
evaluate_lights_common) is not ported: the fused shade kernel's plain
version (render/shade_kernel.py::fused_shade_plain) stands in for it.
A configuration the reference would send down that path raises
NotImplementedError here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from transmission_renderer_tpu_torch.ops.mipchain import MipPyramid
from transmission_renderer_tpu_torch.ops.tap_finish import (
    sample_bundle_planes,
    transmission_fetch_planes,
)
from transmission_renderer_tpu_torch.ops.texture import WRAP_REPEAT, atlas_classes
from transmission_renderer_tpu_torch.pbr.brdf import apply_volume_attenuation
from transmission_renderer_tpu_torch.pbr.clustering import ClusterCoefficients
from transmission_renderer_tpu_torch.pbr.lights import Lights
from transmission_renderer_tpu_torch.render.gbuffer import GBuffer
from transmission_renderer_tpu_torch.render.shade_kernel import (
    pallas_shade_supported,
    shade_opaque_pallas_planes,
    shade_transmission_pallas_pre,
)
from transmission_renderer_tpu_torch.scene.textures import IMAGE_MASK, MAX_MIPS
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
    quad_taps: bool = False
    bf16_lights: bool = False


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
        img = torch.clamp(tid, min=0) & IMAGE_MASK
        rows = scene.atlas_meta[img.long()][:, :_META_W].to(torch.int32)
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


def _require_kernel_path(ctx: ShadeContext) -> None:
    if ctx.mat_matrix is None or not pallas_shade_supported(
        ctx, int(ctx.mat_matrix.table.shape[0]), ctx.framebuffer_size[0]
    ):
        raise NotImplementedError(
            "this configuration takes the reference's XLA shading path "
            "(evaluate_pixel_material / evaluate_lights_common): ROADMAP "
            "queue 1, other frame variants"
        )


def shade_opaque_flat(scene: Scene, g: GBuffer, ctx: ShadeContext,
                      block_py: torch.Tensor, block_px0: torch.Tensor) -> tuple:
    """The opaque PBR fragment shader (shader/src/lib.rs:164-249) over a
    flat [M] worklist of single-row 128-px blocks -> (r, g, b) planes."""
    _require_kernel_path(ctx)
    with pass_scope("material_taps"):
        samples = bundle_tap_samples(scene, g, ctx.tex_slots, ctx.mat_matrix)
    return shade_opaque_pallas_planes(
        scene, g, ctx, block_py, block_px0, samples, ctx.tex_slots
    )


def flatten_gbuffer(g: GBuffer) -> GBuffer:
    h, w = g.depth.shape
    return GBuffer(*[a.reshape((h * w,) + a.shape[2:]) for a in g])


def shade_opaque(scene: Scene, g: GBuffer, ctx: ShadeContext) -> tuple:
    """Dense [H, W] opaque shade -> (r, g, b) [H, W] planes."""
    h, w = g.depth.shape
    if w % 128:
        raise NotImplementedError(
            "width not a multiple of 128 takes the reference's XLA shading "
            "path: ROADMAP queue 1, other frame variants"
        )
    bpr = w // 128
    bid = torch.arange((h * w) // 128, dtype=torch.int32, device=g.depth.device)
    planes = shade_opaque_flat(
        scene, flatten_gbuffer(g), ctx, bid // bpr, (bid % bpr) * 128
    )
    return tuple(p.reshape(h, w) for p in planes)


def shade_transmission_flat(scene: Scene, g: GBuffer, ctx: ShadeContext,
                            pyramid: MipPyramid, level_set: tuple,
                            block_py: torch.Tensor,
                            block_px0: torch.Tensor) -> torch.Tensor:
    """The transmission fragment shader (shader/src/lib.rs:37-162) over a
    flat [M] worklist -> [M, 3] HDR (0 on invalid pixels): the fused
    pre-shade (kernel 3), the pyramid + GGX-LUT fetch (kernel 4), then
    the combine tail."""
    _require_kernel_path(ctx)
    if level_set is None:
        raise NotImplementedError(
            "per-pixel (textured) transmissive roughness needs the full "
            "pyramid's dynamic-level fetch: ROADMAP queue 1, other frame variants"
        )
    with pass_scope("material_taps"):
        samples = bundle_tap_samples(scene, g, ctx.tex_slots, ctx.mat_matrix)
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
