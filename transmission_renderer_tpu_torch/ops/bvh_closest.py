"""Closest-hit, alpha-tested ray walk of the AS-debug caster.

Counterpart of ``transmission_renderer_tpu/ops/bvh.py::trace_rays`` with
``any_hit=False`` and an ``alpha_test_fn`` (the caster's call,
render/raytrace.py::as_debug_view). On the TPU that walk is one fused XLA
while_loop program and no Pallas kernel; on the card
``csrc/bvh_closest.cu`` walks one ray per lane of persistent warps over
kernel 5's table (ops/bvh_packet.py::kernel_walk_table), with the alpha
test's LOD-0 atlas tap inside the kernel (csrc/atlas_tap.cuh, kernel 2's
tap code).

``trace_closest`` launches the kernel for CUDA tensors and runs the plain
walk (ops/bvh.py::trace_closest_plain, with ``AlphaClip.test`` as its
alpha test) for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from transmission_renderer_tpu_torch import kernels
from transmission_renderer_tpu_torch.ops.bvh import BVH, LEAF_TRIS, WalkTable, trace_closest_plain
from transmission_renderer_tpu_torch.ops.bvh_packet import walk_layout
from transmission_renderer_tpu_torch.ops.texture import (
    WRAP_REPEAT,
    atlas_classes,
    class_mask,
    sample_texture,
)


class AlphaClip(NamedTuple):
    """What the caster's alpha test reads: a candidate triangle's
    material, its packed diffuse ref, its vertices' uvs, and the atlas."""

    tri_vertices: torch.Tensor  # [T, 3] int32 into uvs
    uvs: torch.Tensor  # [V, 2] float32
    tri_material: torch.Tensor  # [T] int32
    tex_diffuse: torch.Tensor  # [M] int32 packed refs, -1: none
    alpha_factor: torch.Tensor  # [M] float32 diffuse_factor.a
    cutoff: torch.Tensor  # [M] float32 alpha_clipping_cutoff
    atlas_texels: torch.Tensor  # [R, row_elems] bfloat16
    atlas_meta: torch.Tensor  # [images, META_COLS + class tag] int32

    def test(self, tri_id: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Candidates [...] -> bool: LOD-0 diffuse alpha (times the factor)
        reaches the material's cutoff (shader/src/lib.rs:777-784). Every
        candidate is tested, whatever its bucket: the BLAS carries no
        OPAQUE flag (acceleration_structures.rs:31)."""
        tri_id = tri_id.long()
        mid = self.tri_material[tri_id].long()
        tid = self.tex_diffuse[mid]
        vidx = self.tri_vertices[tri_id].long()
        uv = (self.uvs[vidx[..., 0]] * (1.0 - u - v)[..., None]
              + self.uvs[vidx[..., 1]] * u[..., None]
              + self.uvs[vidx[..., 2]] * v[..., None])
        tap = sample_texture(self.atlas_texels, self.atlas_meta, tid, uv,
                             torch.zeros_like(u), WRAP_REPEAT)
        alpha = self.alpha_factor[mid] * torch.where(tid >= 0, tap[..., 3], 1.0)
        return alpha >= self.cutoff[mid]


def alpha_clip_inputs(scene, tri_vertices: torch.Tensor, uvs: torch.Tensor,
                      tri_material: torch.Tensor) -> AlphaClip:
    """The alpha test's inputs from a Scene and the expanded draw list's
    triangles and uvs."""
    m = scene.materials
    return AlphaClip(
        tri_vertices=tri_vertices.to(torch.int32).contiguous(),
        uvs=uvs.contiguous(),
        tri_material=tri_material.to(torch.int32).contiguous(),
        tex_diffuse=m.tex_diffuse.to(torch.int32).contiguous(),
        alpha_factor=m.diffuse_factor[:, 3].contiguous(),
        cutoff=m.alpha_clipping_cutoff.contiguous(),
        atlas_texels=scene.atlas_texels.contiguous(),
        atlas_meta=scene.atlas_meta.contiguous(),
    )


def _closest_plain(bvh: BVH, table: WalkTable, rays: torch.Tensor, t_min: float,
                   alpha: AlphaClip) -> tuple:
    return trace_closest_plain(bvh, table, rays, t_min, alpha.test)


def _closest_cuda(bvh: BVH, table: WalkTable, rays: torch.Tensor, t_min: float,
                  alpha: AlphaClip) -> tuple:
    dev = table.nodes.device
    n = rays.shape[1]
    layout = walk_layout(bvh, table, rays)
    leaf_ids = bvh.leaf_tri.reshape(-1)
    kernels.check(leaf_ids, "leaf triangle ids", torch.int32,
                  (bvh.num_leaves * LEAF_TRIS,), device=dev)
    n_tri = alpha.tri_material.shape[0]
    n_mat = alpha.tex_diffuse.shape[0]
    kernels.check(alpha.tri_vertices, "triangle vertices", torch.int32, (n_tri, 3), device=dev)
    kernels.check(alpha.uvs, "uvs", torch.float32, (alpha.uvs.shape[0], 2), device=dev)
    kernels.check(alpha.tri_material, "triangle materials", torch.int32, device=dev)
    kernels.check(alpha.tex_diffuse, "diffuse refs", torch.int32, device=dev)
    kernels.check(alpha.alpha_factor, "alpha factors", torch.float32, (n_mat,), device=dev)
    kernels.check(alpha.cutoff, "alpha cutoffs", torch.float32, (n_mat,), device=dev)
    kernels.check(alpha.atlas_texels, "atlas texels", torch.bfloat16, device=dev)
    kernels.check(alpha.atlas_meta, "atlas meta", torch.int32, device=dev)
    if n_tri != bvh.num_tris:
        raise ValueError(f"{n_tri} triangle materials for a BVH over {bvh.num_tris}")
    classes = atlas_classes(alpha.atlas_meta)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    next_ray = torch.zeros(1, dtype=torch.int32, device=dev)
    dims = (ctypes.c_int * 4)(alpha.atlas_texels.shape[-1], alpha.atlas_meta.shape[1],
                              class_mask(classes), max(classes))
    p = kernels.VOIDP
    fn = kernels.entry("trt_bvh_closest", [
        ctypes.POINTER(ctypes.c_int), p, p, p, p, p, p, p, p, p, p, p,
        ctypes.POINTER(ctypes.c_int), p, kernels.INT, kernels.FLOAT, p, p, p, p, p, p, p,
    ])
    kernels.launch(
        KERNEL, fn, layout, kernels.ptr(table.nodes), kernels.ptr(table.tris),
        kernels.ptr(leaf_ids), kernels.ptr(alpha.tri_vertices), kernels.ptr(alpha.uvs),
        kernels.ptr(alpha.tri_material), kernels.ptr(alpha.tex_diffuse),
        kernels.ptr(alpha.alpha_factor), kernels.ptr(alpha.cutoff),
        kernels.ptr(alpha.atlas_texels), kernels.ptr(alpha.atlas_meta), dims,
        kernels.ptr(rays), n, ctypes.c_float(t_min), kernels.ptr(next_ray), kernels.ptr(hit),
        kernels.ptr(t), kernels.ptr(tri), kernels.ptr(u), kernels.ptr(v),
    )
    return hit, t, tri, u, v


KERNEL = kernels.KernelHandle(
    "bvh_closest", "transmission_renderer_tpu_torch/csrc/bvh_closest.cu",
    "none: card-only counterpart of the XLA walk transmission_renderer_tpu/ops/bvh.py:331",
    cuda=_closest_cuda, plain=_closest_plain,
)


def trace_closest(bvh: BVH, table: WalkTable, rays: torch.Tensor, t_min: float,
                  alpha: AlphaClip) -> tuple:
    """Closest alpha-tested hit in (t_min, t_max) of ray planes [10, N]
    (ops/bvh_packet.py::ray_planes) -> (hit bool, t, tri id int32 (-1 on
    a miss), u, v) [N]; a miss keeps t = t_max and u = v = 0."""
    return KERNEL(rays.is_cuda, bvh, table, rays, float(t_min), alpha)
