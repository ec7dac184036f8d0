"""Ray-traced shadows (the --ray-tracing variant) and the AS-debug caster.

Counterpart of ``transmission_renderer_tpu/render/raytrace.py``:
``_packet_swizzle_fns`` and ``shadow_factors`` (shadow rays scale the sun
and point-light intensities, shader/src/lighting.rs:97-125, applied at
:22-37 and :158-166), and ``render_as_debug_frame`` / ``as_debug_view``
(the T-key ray caster, shader/src/lib.rs:699-798: closest alpha-tested
hit of per-pixel camera rays, unlit LOD-0 diffuse), whose walk is
ops/bvh_closest.py's kernel.
"""

from __future__ import annotations

import torch

from transmission_renderer_tpu_torch.ops.bvh import BVH, refit_bvh
from transmission_renderer_tpu_torch.ops.bvh_closest import alpha_clip_inputs, trace_closest
from transmission_renderer_tpu_torch.ops.bvh_packet import (
    kernel_walk_table,
    ray_planes,
    trace_occlusion_packets,
)
from transmission_renderer_tpu_torch.ops.texture import WRAP_REPEAT, sample_texture
from transmission_renderer_tpu_torch.pbr.lights import Lights
from transmission_renderer_tpu_torch.render.gbuffer import GBuffer
from transmission_renderer_tpu_torch.scene.types import Scene, Similarity, similarity_apply
from transmission_renderer_tpu_torch.utils.platform import f32_matmuls


def _packet_swizzle_fns(shape: tuple, mode: str | None):
    """(swz, unswz) pixel regrouping before the walk, or identities when
    the layout does not support the mode.

    ``"2d"`` for [H, W(, C)] arrays (H % 8 == W % 16 == 0): rays in 8x16
    pixel groups; ``"tiles"`` for flat [M(, C)] arrays whose every 1024
    lanes are one 8x128 raster tile: each tile regrouped into 8 groups of
    8x16 pixels; None disables. On the TPU a group was one packet, whose
    walk paid the union of its rays' paths; on the card 32 consecutive
    rays are one warp, whose walk pays the union of its rays' paths in
    the same way. Any-hit is a per-ray predicate, so the order changes no
    result. chip_smoke.py times the occlusion kernel on the frame's rays
    in this order and in row-major pixel order (PERF.md has the
    numbers)."""
    if mode == "2d" and len(shape) >= 2 and shape[0] % 8 == 0 and shape[1] % 16 == 0:
        h, w = shape[0], shape[1]

        def swz(a):
            a4 = a.reshape(h // 8, 8, w // 16, 16, *a.shape[2:])
            return torch.movedim(a4, 1, 2).reshape(-1, *a.shape[2:])

        def unswz(a):  # flat [H * W(, C)] -> [H, W(, C)]
            a4 = a.reshape(h // 8, w // 16, 8, 16, *a.shape[1:])
            return torch.movedim(a4, 2, 1).reshape(h, w, *a.shape[1:])

        return swz, unswz
    if mode == "tiles" and shape[0] % 1024 == 0:
        m = shape[0]

        def swz(a):
            a4 = a.reshape(m // 1024, 8, 8, 16, *a.shape[1:])
            return torch.movedim(a4, 1, 2).reshape(m, *a.shape[1:])

        return swz, swz  # swapping the two middle axes is its own inverse
    return (lambda a: a), (lambda a: a)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Left-to-right three-term dot product over the last axis."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def shadow_factors(
    bvh: BVH,
    tri_vertices: torch.Tensor,  # [TT, 3] into world positions
    world_positions: torch.Tensor,  # [VV, 3]
    g: GBuffer,
    sun_dir: torch.Tensor,  # [3]
    lights: Lights,
    light_active: torch.Tensor | None = None,  # [*g.valid.shape, L] bool
    nol_gate: bool = False,
    packet_swizzle: str | None = None,
):
    """(sun_factor [...], light_factors [..., L]) over g's pixels: 1.0 lit,
    0.0 shadowed.

    Any-hit in (0.001, t_max): the sun's t_max is 10 000
    (shader/src/lighting.rs:26-32), a light's is its distance (:64-71),
    and every candidate is confirmed (alpha clip is ignored, as in the
    reference). All 1 + L ray kinds go through one batched walk. Invalid
    pixels get t_max = 0 and never pop. ``light_active``
    (shading.cluster_light_mask) zeroes t_max for lights outside the
    pixel's cluster list, whose factor the light loop never reads.
    ``nol_gate`` also kills rays whose G-buffer normal faces away from
    the light (not exact; opaque pass of normal-map-free scenes only,
    see RenderConfig.nol_shadow_gate)."""
    swz, unswz = _packet_swizzle_fns(g.valid.shape, packet_swizzle)
    origins = swz(g.position).reshape(-1, 3)
    n = origins.shape[0]
    valid = swz(g.valid).reshape(-1)
    nrm = swz(g.normal).reshape(-1, 3) if nol_gate else None
    if light_active is not None:
        light_active = swz(light_active).reshape(-1, lights.num)
    sun_live = valid
    if nol_gate:
        sun_live = sun_live & (_dot3(nrm, sun_dir) > 0.0)
    dirs = [sun_dir.expand(n, 3)]
    tmaxs = [torch.where(sun_live, 10_000.0, 0.0)]
    for li in range(lights.num):
        to_light = lights.position[li] - origins
        dist = torch.sqrt(_dot3(to_light, to_light))
        ldir = to_light / torch.clamp(dist[:, None], min=1e-12)
        dirs.append(ldir)
        live = valid
        if light_active is not None:
            live = live & light_active[:, li]
        if nol_gate:
            live = live & (_dot3(nrm, ldir) > 0.0)
        tmaxs.append(torch.where(live, dist, 0.0))
    k = 1 + lights.num
    hit = trace_occlusion_packets(
        bvh, tri_vertices, world_positions, origins.expand(k, n, 3),
        torch.stack(dirs), t_max=torch.stack(tmaxs),
    )
    shape = g.valid.shape
    hit_k = torch.stack([unswz(hit[i]).reshape(shape) for i in range(k)])
    factors = torch.where(g.valid[None] & hit_k, 0.0, 1.0)
    return factors[0], torch.movedim(factors[1:], 0, -1)


def render_as_debug_frame(scene: Scene, dl, params, lights: Lights, config, bvh: BVH):
    """The AS-debug view's frame (the reference's T-key toggle): the
    vertices transformed to world space, the BVH refit to them, the full
    frame ray-cast -> linear [H, W, 3]. ``lights`` is accepted for
    signature parity with render_frame (the view is unlit)."""
    del lights
    f32_matmuls()
    vi = dl.vtx_inst.long()
    inst_t = Similarity(
        translation=scene.inst_transform.translation[vi],
        scale=scene.inst_transform.scale[vi],
        rotation=scene.inst_transform.rotation[vi],
    )
    vs = dl.vtx_src.long()
    world_pos = similarity_apply(inst_t, scene.positions[vs])
    uvs = scene.uvs[vs]
    bvh = refit_bvh(bvh, dl.tri_vtx, world_pos)
    # the host-computed inverse projection, as the raster path unprojects
    return as_debug_view(scene, bvh, dl.tri_vtx, dl.tri_material, world_pos, uvs,
                         torch.linalg.inv(params.view), params.inverse_perspective,
                         config.width, config.height)


def as_debug_view(
    scene: Scene,
    bvh: BVH,
    tri_vertices: torch.Tensor,  # [TT, 3] int32
    tri_material: torch.Tensor,  # [TT] int32
    world_positions: torch.Tensor,  # [VV, 3]
    uvs: torch.Tensor,  # [VV, 2]
    view_inverse: torch.Tensor,  # [4, 4]
    proj_inverse: torch.Tensor,  # [4, 4]
    width: int,
    height: int,
) -> torch.Tensor:
    """Full-screen ray-cast view (shader/src/lib.rs:699-798): camera rays
    from the inverse view and projection, the closest hit in (0.01, 1000)
    whose candidate passes the alpha test (LOD-0 diffuse alpha times the
    factor >= the cutoff, every bucket), barycentric uv, LOD-0 diffuse
    -> linear [H, W, 3], black where nothing is hit."""
    dev = world_positions.device
    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :] + 0.5
    py = torch.arange(height, dtype=torch.float32, device=dev)[:, None] + 0.5
    rc_x = (px / width).expand(height, width) * 2.0 - 1.0
    rc_y = (py / height).expand(height, width) * 2.0 - 1.0
    one = torch.ones_like(rc_x)
    target = torch.stack([rc_x, rc_y, one, one], dim=-1) @ proj_inverse.T
    local_dir = target[..., :3] / torch.linalg.vector_norm(target[..., :3], dim=-1,
                                                           keepdim=True)
    direction = local_dir @ view_inverse[:3, :3].T
    origins = view_inverse[:3, 3].expand(direction.shape)

    table = kernel_walk_table(bvh, tri_vertices, world_positions)
    rays = ray_planes(origins, direction, 1000.0)
    alpha = alpha_clip_inputs(scene, tri_vertices, uvs, tri_material)
    hit, _, tri_id, u, v = trace_closest(bvh, table, rays, 0.01, alpha)
    hit = hit.reshape(height, width)
    u = u.reshape(height, width)
    v = v.reshape(height, width)

    safe_tri = torch.clamp(tri_id, min=0).long().reshape(height, width)
    vidx = tri_vertices[safe_tri].long()
    w0 = (1.0 - u - v)[..., None]
    uv = (uvs[vidx[..., 0]] * w0 + uvs[vidx[..., 1]] * u[..., None]
          + uvs[vidx[..., 2]] * v[..., None])
    m = scene.materials
    mid = tri_material[safe_tri].long()
    diffuse = m.diffuse_factor[mid][..., :3]
    tid = m.tex_diffuse[mid]
    sample = sample_texture(scene.atlas_texels, scene.atlas_meta, tid, uv,
                            torch.zeros_like(u), WRAP_REPEAT)
    diffuse = torch.where((tid >= 0)[..., None], diffuse * sample[..., :3], diffuse)
    return torch.where(hit[..., None], diffuse, 0.0)
