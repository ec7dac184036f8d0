"""Frustum culling and per-bucket triangle masks, atomics-free.

Counterpart of ``transmission_renderer_tpu/ops/cull.py``
(frustum_planes_from_projection, cull_instances, bucket_triangle_masks),
plus the frame's vertex transform (``render/frame.py:984-1003``).
"""

from __future__ import annotations

import numpy as np
import torch

from transmission_renderer_tpu_torch.scene.types import (
    Scene,
    Similarity,
    quat_rotate,
    similarity_apply,
)


def frustum_planes_from_projection(perspective: np.ndarray):
    """Symmetric frustum plane magnitudes (src/main.rs:1729-1733): the
    xz pair of normalize(row3 + row0) and the yz pair of
    normalize(row3 + row1)."""
    r0 = perspective[0, :3]
    r1 = perspective[1, :3]
    r3 = perspective[3, :3]
    fx = r3 + r0
    fx = np.abs(fx) / np.linalg.norm(fx)
    fy = r3 + r1
    fy = np.abs(fy) / np.linalg.norm(fy)
    return np.array([fx[0], fx[2]], np.float32), np.array([fy[1], fy[2]], np.float32)


def _mat_rows(points: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """[N, 4] homogeneous points -> [N, 4] = points @ mat.T (full f32)."""
    return points @ mat.T


def cull_instances(
    scene: Scene,
    view_matrix: torch.Tensor,  # [4, 4]
    frustum_x_xz: torch.Tensor,  # [2]
    frustum_y_yz: torch.Tensor,  # [2]
    z_near: float,
) -> torch.Tensor:
    """[I] bool visibility (shader/src/lib.rs:442-469), sphere vs the
    symmetric planes."""
    spheres = scene.prim_bounding_sphere[scene.inst_primitive_id.long()]
    center = similarity_apply(scene.inst_transform, spheres[:, :3])
    center_h = torch.cat([center, torch.ones_like(center[:, :1])], dim=-1)
    center_view = _mat_rows(center_h, view_matrix)[:, :3]
    cz = -center_view[:, 2]
    cx = center_view[:, 0]
    cy = center_view[:, 1]
    radius = spheres[:, 3] * scene.inst_transform.scale
    visible = cz + radius > z_near
    visible &= cz * frustum_x_xz[1] - torch.abs(cx) * frustum_x_xz[0] > -radius
    visible &= cz * frustum_y_yz[1] - torch.abs(cy) * frustum_y_yz[0] > -radius
    return visible


def bucket_triangle_masks(
    tri_instance: torch.Tensor,  # [TT] int32
    tri_bucket: torch.Tensor,  # [TT] int32
    instance_visible: torch.Tensor,  # [I] bool
    buckets: tuple[int, ...],
) -> torch.Tensor:
    """[TT] bool: the triangle's instance survived culling and its
    primitive's bucket is in ``buckets`` (shader/src/lib.rs:473-517)."""
    vis = instance_visible[tri_instance.long()]
    in_bucket = torch.zeros_like(vis)
    for b in buckets:
        in_bucket |= tri_bucket == b
    return vis & in_bucket


def transform_vertices(scene: Scene, dl, proj_view: torch.Tensor):
    """The frame's vertex transform (vertex_instanced, shader
    lib.rs:336-361): expanded world positions, rotated normals, uvs, clip
    positions and per-triangle instance scale."""
    vi = dl.vtx_inst.long()
    vs = dl.vtx_src.long()
    inst_t = Similarity(
        translation=scene.inst_transform.translation[vi],
        scale=scene.inst_transform.scale[vi],
        rotation=scene.inst_transform.rotation[vi],
    )
    world_pos = similarity_apply(inst_t, scene.positions[vs])
    world_nrm = quat_rotate(inst_t.rotation, scene.normals[vs])
    uvs = scene.uvs[vs]
    pos_h = torch.cat([world_pos, torch.ones_like(world_pos[:, :1])], dim=-1)
    clip = _mat_rows(pos_h, proj_view)
    tri_scale = scene.inst_transform.scale[dl.tri_inst.long()]
    return world_pos, world_nrm, uvs, clip, tri_scale
