"""The G-buffer record, and its interpolation from a visibility buffer.

Counterpart of ``transmission_renderer_tpu/render/gbuffer.py``: the
GBuffer field set, and ``interpolate_gbuffer``, which the
visibility-buffer frame uses to recover each pixel's vertex attributes
(world position, normal, uv, material id, instance scale) from the
winning triangle's corners and the stored perspective-correct
barycentrics, with the analytic screen-space uv and position derivatives
dA/dnx = (sum(a_i A_i) D - N sum(a_i)) / D^2 * 2/W. (The G-buffer
kernel path interpolates inside the raster, ops/raster_gbuf.py.)

The reference fused its per-pixel fetches into two wide gathers (one
[VV, 8] vertex table at the three corners and one [T, 11] triangle
table) because TPU gathers cost by index count; the port keeps the two
tables, which also keeps the sums in the reference's order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GBuffer(NamedTuple):
    valid: torch.Tensor  # [..] bool
    depth: torch.Tensor  # [..] f32 (reversed-Z)
    position: torch.Tensor  # [.., 3] world space
    normal: torch.Tensor  # [.., 3] interpolated, unnormalised
    uv: torch.Tensor  # [.., 2]
    duv_dx: torch.Tensor  # [.., 2]
    duv_dy: torch.Tensor  # [.., 2]
    dpos_dx: torch.Tensor  # [.., 3]
    dpos_dy: torch.Tensor  # [.., 3]
    material_id: torch.Tensor  # [..] int32
    model_scale: torch.Tensor  # [..] f32
    tri_id: torch.Tensor  # [..] int32


def _sum3(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over a size-3 axis in index order."""
    return (v.select(dim, 0) + v.select(dim, 1)) + v.select(dim, 2)


def interpolate_gbuffer(
    vis,  # ops.raster.VisibilityBuffer
    setup,  # ops.raster.TriangleSetup
    tri_vertices: torch.Tensor,  # [T, 3] int32 into the expanded vertex pool
    tri_material: torch.Tensor,  # [T] int32
    tri_scale: torch.Tensor,  # [T] f32 (instance scale)
    world_positions: torch.Tensor,  # [VV, 3]
    world_normals: torch.Tensor,  # [VV, 3]
    uvs: torch.Tensor,  # [VV, 2]
    width: int,
    height: int,
) -> GBuffer:
    """Visibility buffer [H, W] -> GBuffer [H, W]; background pixels get
    zeros, normal (0, 0, 1), material 0 and scale 1."""
    valid = vis.tri_id >= 0
    tri = torch.clamp(vis.tri_id, min=0).long()
    t = setup.adj.shape[0]
    tri_table = torch.cat([setup.adj.reshape(t, 9), tri_material.to(torch.float32)[:, None],
                           tri_scale[:, None]], dim=1)
    tri_vals = tri_table[tri]  # [H, W, 11]
    adj = tri_vals[..., :9].reshape(tri.shape + (3, 3))
    material_id = tri_vals[..., 9].to(torch.int32)
    model_scale = tri_vals[..., 10]

    attr8 = torch.cat([world_positions, world_normals, uvs], dim=1)
    vals = attr8[tri_vertices.long()[tri]]  # [H, W, 3 corners, 8]

    b1 = vis.bary[..., 0]
    b2 = vis.bary[..., 1]
    b0 = 1.0 - b1 - b2
    b = torch.stack([b0, b1, b2], dim=-1)
    blended = _sum3(vals * b[..., None], -2)  # [H, W, 8]

    h_px, w_px = vis.tri_id.shape
    dev = vis.depth.device
    px = torch.arange(w_px, dtype=torch.float32, device=dev)[None, :] + 0.5
    py = torch.arange(h_px, dtype=torch.float32, device=dev)[:, None] + 0.5
    nx = (px * (2.0 / width) - 1.0).expand(h_px, w_px)
    ny = (py * (2.0 / height) - 1.0).expand(h_px, w_px)
    e = adj[..., 0] * nx[..., None] + adj[..., 1] * ny[..., None] + adj[..., 2]  # [H, W, 3]
    d_sum = _sum3(e, -1)
    a_sum = _sum3(adj[..., 0], -1)
    b_sum = _sum3(adj[..., 1], -1)
    n8 = _sum3(e[..., None] * vals, -2)
    na8 = _sum3(adj[..., 0][..., None] * vals, -2)
    nb8 = _sum3(adj[..., 1][..., None] * vals, -2)
    inv_d2 = (1.0 / (d_sum * d_sum))[..., None]
    ddnx8 = (na8 * d_sum[..., None] - n8 * a_sum[..., None]) * inv_d2 * (2.0 / width)
    ddny8 = (nb8 * d_sum[..., None] - n8 * b_sum[..., None]) * inv_d2 * (2.0 / height)

    vm = valid[..., None]
    normal_bg = torch.tensor([0.0, 0.0, 1.0], device=dev)
    return GBuffer(
        valid=valid,
        depth=vis.depth,
        position=torch.where(vm, blended[..., 0:3], 0.0),
        normal=torch.where(vm, blended[..., 3:6], normal_bg),
        uv=torch.where(vm, blended[..., 6:8], 0.0),
        duv_dx=torch.where(vm, ddnx8[..., 6:8], 0.0),
        duv_dy=torch.where(vm, ddny8[..., 6:8], 0.0),
        dpos_dx=torch.where(vm, ddnx8[..., 0:3], 0.0),
        dpos_dy=torch.where(vm, ddny8[..., 0:3], 0.0),
        material_id=torch.where(valid, material_id, 0),
        model_scale=torch.where(valid, model_scale, 1.0),
        tri_id=vis.tri_id,
    )
