"""Any-hit occlusion of shadow rays (kernel 5).

Counterpart of ``transmission_renderer_tpu/ops/bvh_packet.py``
(packet_walk_table, trace_occlusion_packets). The TPU kernel walked
128-ray packets against a VMEM-resident table; on Hopper
``csrc/bvh_occlusion.cu`` walks one ray per lane of persistent warps
against ``kernel_walk_table``, the same boxes and triangles laid out in
16-byte vectors (triangles as v0 and the edges e1, e2, subtracted once
here as the walk would), which stays resident in the 50 MB L2. Any-hit
occlusion is an existence predicate, so the hit set does not depend on
the order in which rays or nodes are visited: the kernel, its plain
version (ops/bvh.py::trace_occlusion_plain, which reads either table)
and the reference's walks return the same hits.

``trace_occlusion_packets`` launches the kernel for CUDA tensors and runs
the plain walk for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from transmission_renderer_tpu_torch import kernels
from transmission_renderer_tpu_torch.ops.bvh import (
    BVH,
    LEAF_TRIS,
    MAX_LEVELS,
    WIDE,
    WalkTable,
    inverse_directions,
    trace_occlusion_plain,
)

TABLE_COLS = LEAF_TRIS * 9


def packet_walk_table(bvh: BVH, tri_vertices: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    """Unified [R + L, LEAF_TRIS * 9] float32 table: the node rows (WIDE *
    6 columns used, the rest 0), then each leaf row's triangles as 9
    floats (v0 xyz, v1 xyz, v2 xyz) each."""
    tri_xyz = positions[tri_vertices.long()]  # [T, 3, 3]
    leaf_xyz = tri_xyz[bvh.leaf_tri.reshape(-1).long()].reshape(bvh.num_leaves, TABLE_COLS)
    nodes = torch.nn.functional.pad(bvh.node_boxes, (0, TABLE_COLS - bvh.node_boxes.shape[1]))
    return torch.cat([nodes, leaf_xyz]).contiguous()


def kernel_walk_table(bvh: BVH, tri_vertices: torch.Tensor,
                      positions: torch.Tensor) -> WalkTable:
    """The kernel's table from the same BVH and positions: node rows
    [R, 48] as 6 planes x 8 children (12 float4 a row), and leaf
    triangles [L * LEAF_TRIS, 12] as v0, e1 = v1 - v0, e2 = v2 - v0 with
    a zero w each (3 float4 a triangle)."""
    nodes = bvh.node_boxes.reshape(-1, WIDE, 6).transpose(1, 2).reshape(-1, 6 * WIDE)
    v = positions[tri_vertices[bvh.leaf_tri.reshape(-1).long()].long()]  # [L*16, 3, 3]
    edges = torch.stack([v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], dim=1)
    tris = torch.nn.functional.pad(edges, (0, 1)).reshape(-1, 12)
    return WalkTable(nodes.contiguous(), tris.contiguous())


def walk_layout(bvh: BVH, table: WalkTable, rays: torch.Tensor):
    """Check a walk kernel's table and ray planes [10, N] (kernel 5 and
    the closest-hit walk take the same) -> the layout words they take
    (num_rows, num_leaves, num_tris, num_levels, then MAX_LEVELS level
    offsets and MAX_LEVELS child counts)."""
    dev = table.nodes.device
    num_rows = bvh.node_boxes.shape[0]
    kernels.check(table.nodes, "walk table nodes", torch.float32, (num_rows, 6 * WIDE),
                  align=16)
    kernels.check(table.tris, "walk table triangles", torch.float32,
                  (bvh.num_leaves * LEAF_TRIS, 12), device=dev, align=16)
    kernels.check(rays, "ray planes", torch.float32, (10, rays.shape[1]), device=dev)
    if bvh.num_levels > MAX_LEVELS:
        raise ValueError(f"{bvh.num_levels} BVH levels: the bitstack holds {MAX_LEVELS}")
    pad = [0] * (MAX_LEVELS - bvh.num_levels)
    return (ctypes.c_int * (4 + 2 * MAX_LEVELS))(
        num_rows, bvh.num_leaves, bvh.num_tris, bvh.num_levels,
        *(list(bvh.level_offsets) + pad),
        *([bvh.children_below(k) for k in range(bvh.num_levels)] + pad),
    )


def _bvh_occlusion_cuda(bvh: BVH, table: WalkTable, rays: torch.Tensor,
                        t_min: float) -> torch.Tensor:
    dev = table.nodes.device
    n = rays.shape[1]
    layout = walk_layout(bvh, table, rays)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    next_ray = torch.zeros(1, dtype=torch.int32, device=dev)
    fn = kernels.entry("trt_bvh_occlusion", [
        ctypes.POINTER(ctypes.c_int), kernels.VOIDP, kernels.VOIDP, kernels.VOIDP,
        kernels.INT, kernels.FLOAT, kernels.VOIDP, kernels.VOIDP,
    ])
    kernels.launch(KERNEL, fn, layout, kernels.ptr(table.nodes), kernels.ptr(table.tris),
                   kernels.ptr(rays), n, ctypes.c_float(t_min), kernels.ptr(next_ray),
                   kernels.ptr(hit))
    return hit


KERNEL = kernels.KernelHandle(
    "bvh_occlusion", "transmission_renderer_tpu_torch/csrc/bvh_occlusion.cu",
    "transmission_renderer_tpu/ops/bvh_packet.py:74",
    cuda=_bvh_occlusion_cuda, plain=trace_occlusion_plain,
)


def ray_planes(origins: torch.Tensor, directions: torch.Tensor, t_max) -> torch.Tensor:
    """[10, N] float32 planes (origin xyz, inverse direction xyz,
    direction xyz, t_max) of rays [..., 3]; ``t_max`` is a scalar or per
    ray."""
    shape = origins.shape[:-1]
    o = origins.reshape(-1, 3)
    d = directions.reshape(-1, 3)
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    tm = torch.broadcast_to(tm, shape).reshape(1, -1)
    return torch.cat([o.T, inverse_directions(d).T, d.T, tm]).contiguous()


def trace_occlusion_packets(
    bvh: BVH,
    tri_vertices: torch.Tensor,  # [T, 3] int32 into world positions
    positions: torch.Tensor,  # [V, 3] world-space
    origins: torch.Tensor,  # [..., 3]
    directions: torch.Tensor,  # [..., 3]
    t_min: float = 0.001,
    t_max=10_000.0,  # scalar or [...]
) -> torch.Tensor:
    """Any-hit occlusion in (t_min, t_max) -> hit bool [...]; the same hit
    set as the reference's trace_rays(any_hit=True, alpha_test_fn=None)."""
    shape = origins.shape[:-1]
    table = kernel_walk_table(bvh, tri_vertices, positions)
    rays = ray_planes(origins, directions, t_max)
    hit = KERNEL(rays.is_cuda, bvh, table, rays, float(t_min))
    return hit.reshape(shape)

