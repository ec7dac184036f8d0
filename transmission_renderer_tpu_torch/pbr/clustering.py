"""Clustered forward lighting: cluster AABBs and light assignment.

Counterpart of ``transmission_renderer_tpu/pbr/clustering.py``
(cluster_coefficients, write_cluster_data, assign_lights_to_clusters).
The assignment keeps the reference's order-preserving compaction with
the 128-light clamp: each cluster lists its accepted lights in ascending
id order, and that order is the sum order of the shade's light loop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ClusterCoefficients(NamedTuple):
    """Mirror of shared-structs/src/lib.rs:35-41."""

    z_near: float
    z_far: float
    scale: float
    bias: float
    num_depth_slices: int


def cluster_coefficients(z_near: float, z_far: float,
                         num_depth_slices: int) -> ClusterCoefficients:
    """shared-structs/src/lib.rs:44-52."""
    log_ratio = np.log2(z_far / z_near)
    return ClusterCoefficients(
        z_near=z_near,
        z_far=z_far,
        scale=num_depth_slices / log_ratio,
        bias=-(num_depth_slices * np.log2(z_near) / log_ratio),
        num_depth_slices=num_depth_slices,
    )


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.float32(x), device=device)


def slice_to_depth(coeffs: ClusterCoefficients, slice_idx: torch.Tensor):
    """Slice index -> (negative) view-space z plane
    (shared-structs/src/lib.rs:65-67)."""
    t = slice_idx / _f32(coeffs.num_depth_slices, slice_idx.device)
    base = _f32(coeffs.z_far / coeffs.z_near, slice_idx.device)
    return np.float32(-coeffs.z_near) * torch.pow(base, t)


def _line_intersection_to_z_plane(a, b, z_distance):
    a_to_b = b - a
    t = (z_distance - a[..., 2]) / a_to_b[..., 2]
    return a + t[..., None] * a_to_b


def write_cluster_data(
    inverse_perspective: torch.Tensor,  # [4, 4]
    screen_dimensions: tuple[int, int],
    num_clusters_xy: tuple[int, int],
    coeffs: ClusterCoefficients,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All view-space cluster AABBs (shader/src/lib.rs:519-580) ->
    (min [N,3], max [N,3]), indexed slice * cy * cx + y * cx + x."""
    dev = inverse_perspective.device
    cx, cy = num_clusters_xy
    slices = coeffs.num_depth_slices
    width, height = screen_dimensions
    cluster_size = torch.tensor(
        np.array([width / cx, height / cy], np.float32), device=dev
    )
    ix = torch.arange(cx, dtype=torch.float32, device=dev)
    iy = torch.arange(cy, dtype=torch.float32, device=dev)
    iz = torch.arange(slices, dtype=torch.float32, device=dev)
    gz, gy, gx = torch.meshgrid(iz, iy, ix, indexing="ij")
    xy = torch.stack([gx, gy], dim=-1)
    screen_min = xy * cluster_size
    screen_max = (xy + 1.0) * cluster_size
    dims = torch.tensor(np.array([width, height], np.float32), device=dev)

    def screen_to_view(pos):  # shader/src/lib.rs:540-550
        clip = pos / dims * 2.0 - 1.0
        clip4 = torch.cat(
            [clip, torch.zeros_like(clip[..., :1]), torch.ones_like(clip[..., :1])],
            dim=-1,
        )
        view = clip4 @ inverse_perspective.T
        return view[..., :3] / view[..., 3:4]

    view_min = screen_to_view(screen_min)
    view_max = screen_to_view(screen_max)
    z_near_plane = slice_to_depth(coeffs, gz)
    z_far_plane = slice_to_depth(coeffs, gz + 1.0)
    eye = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=dev)
    pts = torch.stack([
        _line_intersection_to_z_plane(eye, view_min, z_near_plane),
        _line_intersection_to_z_plane(eye, view_min, z_far_plane),
        _line_intersection_to_z_plane(eye, view_max, z_near_plane),
        _line_intersection_to_z_plane(eye, view_max, z_far_plane),
    ])
    return (
        pts.amin(dim=0).reshape(-1, 3),
        pts.amax(dim=0).reshape(-1, 3),
    )


def _sum3(v: torch.Tensor) -> torch.Tensor:
    """Sum over a trailing axis of 3 in the reference's order."""
    return (v[..., 0] + v[..., 1]) + v[..., 2]


def cluster_aabb_distance_sq(aabb_min, aabb_max, point):
    """Squared point-AABB distance (shared-structs/src/lib.rs:291-298)."""
    d = torch.clamp(torch.maximum(aabb_min - point, point - aabb_max), min=0.0)
    return _sum3(d * d)


def cull_spotlight(aabb_min, aabb_max, origin, direction, angle, range_):
    """Cone-vs-AABB-sphere cull (shared-structs/src/lib.rs:301-319);
    True where the spotlight can be culled from the cluster."""
    center = (aabb_min + aabb_max) / 2.0
    radius = torch.sqrt(_sum3((aabb_max - center) ** 2))
    vector = center - origin
    vector_len_sq = _sum3(vector * vector)
    vector_1_len = _sum3(vector * direction)
    vector_1_len_sq = vector_1_len * vector_1_len
    distance_closest_point = torch.cos(angle) * torch.sqrt(
        torch.clamp(vector_len_sq - vector_1_len_sq, min=0.0)
    ) - vector_1_len * torch.sin(angle)
    return (
        (distance_closest_point > radius)
        | (vector_1_len > radius + range_)
        | (vector_1_len < -radius)
    )


def assign_lights_to_clusters(
    aabb_min: torch.Tensor,  # [C, 3]
    aabb_max: torch.Tensor,  # [C, 3]
    light_positions_view: torch.Tensor,  # [L, 3]
    light_falloff_sq: torch.Tensor,  # [L]
    is_spotlight: torch.Tensor,  # [L] bool
    spot_direction_view: torch.Tensor,  # [L, 3]
    spot_outer_angle: torch.Tensor,  # [L]
    max_lights_per_cluster: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster light lists (shader/src/lib.rs:596-645) ->
    (counts [C] int32, indices [C, K] int32): accepted light ids first,
    ascending, clamped to K = max_lights_per_cluster."""
    d_sq = cluster_aabb_distance_sq(
        aabb_min[:, None, :], aabb_max[:, None, :], light_positions_view[None]
    )
    accept = d_sq <= light_falloff_sq[None, :]
    spot_culled = cull_spotlight(
        aabb_min[:, None, :], aabb_max[:, None, :],
        light_positions_view[None], spot_direction_view[None],
        spot_outer_angle[None, :], light_falloff_sq[None, :],
    )
    accept = accept & ~(is_spotlight[None, :] & spot_culled)
    num_lights = light_positions_view.shape[0]
    k = max_lights_per_cluster
    counts = torch.clamp(accept.sum(dim=-1), max=k).to(torch.int32)
    # order-preserving compaction: a stable sort on "not accepted" keeps
    # the accepted ids ascending at the front
    order = torch.argsort((~accept).to(torch.uint8), dim=-1, stable=True)
    gathered = order.to(torch.int32)
    if num_lights < k:
        pad = torch.zeros(
            (accept.shape[0], k - num_lights), dtype=torch.int32,
            device=accept.device,
        )
        return counts, torch.cat([gathered, pad], dim=-1)
    return counts, gathered[:, :k]
