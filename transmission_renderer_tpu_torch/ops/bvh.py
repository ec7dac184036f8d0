"""Wide (8-ary) LBVH: host build, refit, and the plain any-hit walk.

Counterpart of ``transmission_renderer_tpu/ops/bvh.py``, the occlusion
subset: ``BVH``, ``LEAF_TRIS`` / ``WIDE`` / ``MAX_LEVELS``,
``wide_layout``, ``_morton3``, ``_fold_wide``, ``build_bvh`` (NumPy, no
native fold), ``refit_bvh`` (torch), ``_ray_aabb``, ``_ray_tri`` and the
any-hit, no-alpha-test walk of ``trace_rays(any_hit=True)`` as
``occlusion_walk`` / ``trace_occlusion_plain``, and the AS-debug
caster's closest-hit, alpha-tested walk of ``trace_rays(any_hit=False,
alpha_test_fn=...)`` as ``closest_walk`` / ``trace_closest_plain`` (the
plain version of ops/bvh_closest.py's kernel).

Topology is implicit: triangles are Morton-sorted by centroid and packed
``LEAF_TRIS`` per leaf row; level-k node i's children are the level-(k-1)
nodes (or leaf rows, k == 0) 8i..8i+7. Unused child slots hold inverted
boxes (+inf/-inf); the walk masks them by count arithmetic.

The walk is the reference's stackless bitstack traversal: two 32-bit
trail words hold one 8-bit mask of untested children per level, and a
node's ancestors follow from its index (ancestor k levels up is
idx >> 3k). The arithmetic keeps the reference's order (explicit
left-to-right three-term sums, the +-1e20 inverse-direction fallback, the
1e-12 determinant guard, the ragged-tail guard), so a ray hits here
exactly when it hits in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from transmission_renderer_tpu_torch.utils.platform import CARD, resolve_device

# Triangles per leaf row, children per inner node, and the bitstack's
# depth limit (8 level codes in two 32-bit words, one of them the root):
# LEAF_TRIS * WIDE^MAX_LEVELS = 33.5M triangles.
LEAF_TRIS = 16
WIDE = 8
MAX_LEVELS = 7
# rays per chunk of the plain walk (bounds its temporaries: 6.2M rays of
# a 1080p frame's three ray kinds go through in 24 chunks)
RAY_CHUNK = 1 << 18


@dataclasses.dataclass(frozen=True)
class BVH:
    """Implicit-topology 8-wide BVH over world-space triangles; the layout
    fields are static Python values."""

    node_boxes: torch.Tensor  # [N_rows, WIDE * 6] float32, coarsest level last
    leaf_tri: torch.Tensor  # [L, LEAF_TRIS] int32 (original ids; tail repeats)
    level_offsets: tuple  # row offset of level k in node_boxes
    level_counts: tuple  # number of level-k nodes
    num_tris: int
    num_leaves: int

    @property
    def num_levels(self) -> int:
        return len(self.level_counts)

    def children_below(self, k: int) -> int:
        """Number of child ids one level below internal level k."""
        return self.num_leaves if k == 0 else self.level_counts[k - 1]


def _morton3(x: np.ndarray) -> np.ndarray:
    """[N, 3] floats in [0,1] -> 30-bit Morton codes (uint32)."""
    q = np.clip(x * 1024.0, 0, 1023).astype(np.uint32)

    def expand(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (expand(q[:, 0]) << 2) | (expand(q[:, 1]) << 1) | expand(q[:, 2])


def wide_layout(num_tris: int) -> tuple[int, tuple, tuple]:
    """(num_leaves, level_counts, level_offsets) for a T-triangle build."""
    if num_tris <= 0:
        raise ValueError("wide_layout: BVH build requires at least 1 triangle")
    leaves = -(-num_tris // LEAF_TRIS)
    counts = []
    n = leaves
    while True:
        n = -(-n // WIDE)
        counts.append(n)
        if n == 1:
            break
    if len(counts) > MAX_LEVELS:
        raise ValueError(
            f"{num_tris} triangles need {len(counts)} internal levels; the "
            f"bitstack traversal supports {MAX_LEVELS} "
            f"(LEAF_TRIS * WIDE^{MAX_LEVELS} = {LEAF_TRIS * WIDE**MAX_LEVELS} tris)"
        )
    offsets, off = [], 0
    for c in counts:
        offsets.append(off)
        off += c
    return leaves, tuple(counts), tuple(offsets)


def _fold_wide(child_min: np.ndarray, child_max: np.ndarray):
    """One 8-ary fold: ([n,3],[n,3]) -> (boxes [m, 48], min/max [m,3])."""
    n = child_min.shape[0]
    m = -(-n // WIDE)
    pad = m * WIDE - n
    cmin = np.concatenate(
        [child_min, np.full((pad, 3), np.inf, np.float32)], axis=0
    ).reshape(m, WIDE, 3)
    cmax = np.concatenate(
        [child_max, np.full((pad, 3), -np.inf, np.float32)], axis=0
    ).reshape(m, WIDE, 3)
    boxes = np.concatenate([cmin, cmax], axis=-1).reshape(m, WIDE * 6)
    return boxes, cmin.min(axis=1), cmax.max(axis=1)


def build_bvh(tri_vertices: np.ndarray, positions: np.ndarray, device=CARD) -> BVH:
    """Host-side wide-LBVH build over [T, 3] triangles of [V, 3] positions,
    returned on ``device``."""
    device = resolve_device(device)
    tri = np.asarray(tri_vertices, np.int64)
    pos = np.asarray(positions, np.float32)
    v = pos[tri]  # [T, 3, 3]
    t = len(tri)
    assert t >= 2, "BVH needs at least 2 triangles"

    tri_min = v.min(1)
    tri_max = v.max(1)
    centroid = (tri_min + tri_max) * 0.5
    scene_min = tri_min.min(0)
    scene_max = tri_max.max(0)
    extent = np.maximum(scene_max - scene_min, 1e-9)
    codes = _morton3((centroid - scene_min) / extent)
    order = np.lexsort((np.arange(t), codes)).astype(np.int64)

    leaves, counts, offsets = wide_layout(t)
    padded = np.concatenate(
        [order, np.full(leaves * LEAF_TRIS - t, order[-1], np.int64)]
    )
    leaf_tri = padded.reshape(leaves, LEAF_TRIS)
    # leaf-row AABBs (tail slots repeat the last triangle, which cannot
    # widen a min/max fold)
    lm = tri_min[leaf_tri.reshape(-1)].reshape(leaves, LEAF_TRIS, 3)
    lx = tri_max[leaf_tri.reshape(-1)].reshape(leaves, LEAF_TRIS, 3)
    cmin, cmax = lm.min(axis=1), lx.max(axis=1)
    rows = []
    for _ in counts:
        b, cmin, cmax = _fold_wide(cmin, cmax)
        rows.append(b)
    return BVH(
        node_boxes=torch.from_numpy(np.concatenate(rows, axis=0)).to(device),
        leaf_tri=torch.from_numpy(leaf_tri.astype(np.int32)).to(device),
        level_offsets=offsets,
        level_counts=counts,
        num_tris=t,
        num_leaves=leaves,
    )


def refit_bvh(bvh: BVH, tri_vertices: torch.Tensor, positions: torch.Tensor) -> BVH:
    """Refresh the node boxes for moved vertices, keeping the topology
    (the TLAS UPDATE analogue, src/acceleration_structures.rs:192-267):
    ``num_levels`` dense min/max folds."""
    v = positions[tri_vertices[bvh.leaf_tri.reshape(-1).long()].long()]
    v = v.reshape(bvh.num_leaves, LEAF_TRIS * 3, 3)
    cmin = torch.amin(v, dim=1)
    cmax = torch.amax(v, dim=1)
    rows = []
    for k in range(bvh.num_levels):
        m = bvh.level_counts[k]
        pad = m * WIDE - cmin.shape[0]
        pmin = torch.cat([cmin, cmin.new_full((pad, 3), torch.inf)]).reshape(m, WIDE, 3)
        pmax = torch.cat([cmax, cmax.new_full((pad, 3), -torch.inf)]).reshape(m, WIDE, 3)
        rows.append(torch.cat([pmin, pmax], dim=-1).reshape(m, WIDE * 6))
        cmin = torch.amin(pmin, dim=1)
        cmax = torch.amax(pmax, dim=1)
    return dataclasses.replace(bvh, node_boxes=torch.cat(rows))


def inverse_directions(d: torch.Tensor) -> torch.Tensor:
    """1/d with the reference's sign-matched 1e20 fallback for |d| <= 1e-20."""
    big = torch.where(d < 0, -1e20, 1e20).to(d.dtype)
    return torch.where(torch.abs(d) > 1e-20, 1.0 / d, big)


def _ray_aabb(origin, inv_dir, t_max, bmin, bmax):
    """Slab test -> bool over the last axis (xyz); broadcasts over leading
    axes."""
    t0 = (bmin - origin) * inv_dir
    t1 = (bmax - origin) * inv_dir
    tmin = torch.minimum(t0, t1)
    tmax = torch.maximum(t0, t1)
    enter = torch.maximum(torch.maximum(tmin[..., 0], tmin[..., 1]), tmin[..., 2])
    exit_ = torch.minimum(torch.minimum(tmax[..., 0], tmax[..., 1]), tmax[..., 2])
    return (enter <= exit_) & (exit_ >= 0.0) & (enter <= t_max)


def _ray_tri(origin, direction, t_min, t_max, v0, e1, e2):
    """Moller-Trumbore with the edges e1 = v1 - v0, e2 = v2 - v0 -> (hit
    bool, exit stage int64) over the last axis (xyz); broadcasts over
    leading axes. The stage is the first test that fails, where a test
    that leaves early (the kernel's) stops: 0 the determinant, 1 u
    outside [0, 1], 2 v < 0 or u + v > 1, 3 none (the whole test ran)."""
    return _ray_tri_tuv(origin, direction, t_min, t_max, v0, e1, e2)[:2]


def _ray_tri_tuv(origin, direction, t_min, t_max, v0, e1, e2):
    """``_ray_tri`` -> (hit, exit stage, t, u, v)."""
    def dot(a, b):
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]

    def cross(a, b):
        return torch.stack([
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ], dim=-1)

    pvec = cross(direction, e2)
    det = dot(e1, pvec)
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    tvec = origin - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(direction, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)
    u_out = ~((u >= 0.0) & (u <= 1.0))
    v_out = ~((v >= 0.0) & (u + v <= 1.0))
    stage = torch.where(~ok, 0, torch.where(u_out, 1, torch.where(v_out, 2, 3)))
    return hit, stage, t, u, v


class WalkTable(NamedTuple):
    """The occlusion kernel's table (ops/bvh_packet.py::kernel_walk_table),
    in 16-byte vectors: per node row its 6 planes (min x, y, z, max x, y,
    z) of 8 children each, and per leaf triangle v0, e1 = v1 - v0 and
    e2 = v2 - v0, each xyz and a zero."""

    nodes: torch.Tensor  # [N_rows, 6 * WIDE] float32
    tris: torch.Tensor  # [L * LEAF_TRIS, 12] float32


def _table_readers(bvh: BVH, table):
    """(node boxes of rows [n] -> [n, WIDE, 6], leaf triangles of leaves [n]
    -> (v0, e1, e2) [n, LEAF_TRIS, 3]) of the packet table
    (ops/bvh_packet.py::packet_walk_table) or of a WalkTable."""
    if isinstance(table, WalkTable):
        tris = table.tris.reshape(bvh.num_leaves, LEAF_TRIS, 3, 4)

        def leaf(li):
            tv = tris[li]
            return tv[..., 0, :3], tv[..., 1, :3], tv[..., 2, :3]

        return lambda r: table.nodes[r].reshape(-1, 6, WIDE).transpose(1, 2), leaf
    num_rows = bvh.node_boxes.shape[0]

    def leaf(li):
        tv = table[num_rows + li].reshape(-1, LEAF_TRIS, 3, 3)
        return tv[:, :, 0], tv[:, :, 1] - tv[:, :, 0], tv[:, :, 2] - tv[:, :, 0]

    return lambda r: table[r, : WIDE * 6].reshape(-1, WIDE, 6), leaf


def _walk_start(bvh: BVH, live: torch.Tensor):
    """(ray ids, lvl, idx, tlo, thi) of the live rays at the virtual
    super-root: the real root (idx 0, code D) is the sole set bit of the
    trail, and the first pop descends into it. Dead rays never pop."""
    dev = live.device
    d_levels = bvh.num_levels
    root_mask = 1 << ((d_levels & 3) * 8)
    act = torch.nonzero(live).reshape(-1)
    m = act.shape[0]
    lvl = torch.full((m,), d_levels + 1, dtype=torch.int64, device=dev)
    idx = torch.zeros(m, dtype=torch.int64, device=dev)
    tlo = torch.full((m,), root_mask if d_levels < 4 else 0, dtype=torch.int64, device=dev)
    thi = torch.full((m,), root_mask if d_levels >= 4 else 0, dtype=torch.int64, device=dev)
    return act, lvl, idx, tlo, thi


def _advance(lvl, idx, tlo, thi):
    """One pop of non-empty trails: the lowest set bit of the lowest
    non-empty word (the lowest untested child of the deepest level)."""
    have_lo = tlo != 0
    w = torch.where(have_lo, tlo, thi)
    low = w & -w
    # its position, read exactly from the exponent of 2^pos as a float32
    # (a log2 may round below the integer on some devices)
    pos = ((low.to(torch.float32).view(torch.int32) >> 23) - 127).to(torch.int64)
    tlo = torch.where(have_lo, tlo ^ low, tlo)
    thi = torch.where(have_lo, thi, thi ^ low)
    code = (pos >> 3) + torch.where(have_lo, 0, 4)
    anc = idx >> torch.clamp(3 * (code + 1 - lvl), min=0)
    return code, anc * WIDE + (pos & 7), tlo, thi


def _level_tables(bvh: BVH, dev) -> tuple:
    """(row offset, child count) of each internal level, as tensors."""
    return (torch.tensor(bvh.level_offsets, dtype=torch.int64, device=dev),
            torch.tensor([bvh.children_below(k) for k in range(bvh.num_levels)],
                         dtype=torch.int64, device=dev))


def _push_children(levels, node_boxes, inner, lvl, idx, tlo, thi, o, inv, t_max):
    """Inner pops (mask ``inner``): WIDE slab tests against ``t_max``,
    the mask of hit children pushed onto the trail words in place."""
    lvl_off, below = levels
    lanes_w = torch.arange(WIDE, dtype=torch.int64, device=idx.device)
    ii = idx[inner]
    clvl = lvl[inner] - 1
    boxes = node_boxes(lvl_off[clvl] + ii)
    h8 = _ray_aabb(o[:, None], inv[:, None], t_max[:, None], boxes[..., :3], boxes[..., 3:])
    h8 = h8 & (lanes_w[None] < below[clvl][:, None] - ii[:, None] * WIDE)
    add = (h8.to(torch.int64) * (1 << lanes_w)).sum(dim=1) << ((clvl & 3) * 8)
    in_lo = clvl < 4
    tlo_i, thi_i = tlo[inner], thi[inner]
    tlo[inner] = torch.where(in_lo, tlo_i | add, tlo_i)
    thi[inner] = torch.where(in_lo, thi_i, thi_i | add)


def _walk_chunk(bvh: BVH, table, rays: torch.Tensor, t_min: float):
    """Bitstack any-hit walk of one chunk of rays [10, n] -> (hit, inner
    pops, leaf pops, triangle tests [n, 4]) per ray. Each step advances
    every unfinished ray by one pop; finished rays leave the working set.
    The tests are those a walk that stops at a leaf's first hit runs,
    counted by exit stage (``_ray_tri``)."""
    dev = rays.device
    n = rays.shape[1]
    node_boxes, leaf_tris = _table_readers(bvh, table)
    o_all, inv_all, d_all, tm_all = rays[0:3].T, rays[3:6].T, rays[6:9].T, rays[9]
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    inner_pops = torch.zeros(n, dtype=torch.int64, device=dev)
    leaf_pops = torch.zeros(n, dtype=torch.int64, device=dev)
    tri_tests = torch.zeros((n, 4), dtype=torch.int64, device=dev)
    act, lvl, idx, tlo, thi = _walk_start(bvh, tm_all > t_min)
    levels = _level_tables(bvh, dev)
    lanes_t = torch.arange(LEAF_TRIS, dtype=torch.int64, device=dev)
    while act.numel():
        # ---- advance: pop the deepest non-empty mask's lowest child
        keep = (tlo != 0) | (thi != 0)
        act, lvl, idx, tlo, thi = act[keep], lvl[keep], idx[keep], tlo[keep], thi[keep]
        if not act.numel():
            break
        lvl, idx, tlo, thi = _advance(lvl, idx, tlo, thi)
        is_leaf = lvl == 0

        # ---- leaf pops: LEAF_TRIS Moller-Trumbore tests
        li = idx[is_leaf]
        ray = act[is_leaf]
        leaf_pops.index_add_(0, ray, torch.ones_like(ray))
        h16, stage = _ray_tri(o_all[ray][:, None], d_all[ray][:, None], t_min,
                              tm_all[ray][:, None], *leaf_tris(li))
        real = lanes_t[None] < bvh.num_tris - li[:, None] * LEAF_TRIS
        h16 = h16 & real
        found = h16.any(dim=1)
        hit[ray[found]] = True
        first = torch.where(found, h16.to(torch.int32).argmax(dim=1), LEAF_TRIS)
        ran = real & (lanes_t[None] <= first[:, None])
        tri_tests.index_add_(0, ray, (torch.nn.functional.one_hot(stage, 4)
                                      * ran[..., None]).sum(dim=1))

        # ---- inner pops: WIDE slab tests push a child mask
        inner = ~is_leaf
        ray = act[inner]
        inner_pops.index_add_(0, ray, torch.ones_like(ray))
        _push_children(levels, node_boxes, inner, lvl, idx, tlo, thi, o_all[ray],
                       inv_all[ray], tm_all[ray])

        # rays that hit are finished
        keep = torch.ones_like(is_leaf)
        keep[torch.nonzero(is_leaf).reshape(-1)[found]] = False
        act, lvl, idx, tlo, thi = act[keep], lvl[keep], idx[keep], tlo[keep], thi[keep]
    return hit, inner_pops, leaf_pops, tri_tests


def occlusion_walk(bvh: BVH, table, rays: torch.Tensor, t_min: float = 0.001):
    """The plain any-hit walk over ray planes [10, N] (origin xyz, inverse
    direction xyz, direction xyz, t_max) and the unified node + leaf
    table (ops/bvh_packet.py::packet_walk_table) or the kernel's
    WalkTable -> (hit bool [N], inner pops [N], leaf pops [N], triangle
    tests up to each leaf's first hit by exit stage [N, 4]), in chunks of
    RAY_CHUNK rays. Both tables give the same results: the kernel's
    table holds the same boxes and e1, e2 rounded as here."""
    n = rays.shape[1]
    outs = [_walk_chunk(bvh, table, rays[:, s : s + RAY_CHUNK], float(t_min))
            for s in range(0, n, RAY_CHUNK)]
    if not outs:
        z = torch.zeros(0, dtype=torch.int64, device=rays.device)
        return z.bool(), z, z, z.reshape(0, 4)
    return tuple(torch.cat(parts) for parts in zip(*outs))


def trace_occlusion_plain(bvh: BVH, table, rays: torch.Tensor,
                          t_min: float = 0.001) -> torch.Tensor:
    """Hit bool [N] of the plain walk (kernel 5's plain version)."""
    return occlusion_walk(bvh, table, rays, t_min)[0]


def _closest_chunk(bvh: BVH, table, rays: torch.Tensor, t_min: float, alpha_test_fn):
    """Bitstack closest-hit walk of one chunk of rays [10, n] -> (hit, t,
    tri id, u, v, inner pops, leaf pops, triangle tests [n, 4] by exit
    stage, alpha tests) per ray: the reference's walk with
    ``any_hit=False`` (ops/bvh.py::trace_rays). Boxes and triangles are
    tested against the ray's shrinking best t; a leaf's 16 candidates
    are tested against the best t at the leaf's pop (``t < best_t``,
    strict), those that hit are alpha-tested, and the first of the
    nearest that pass is taken (``argmin``), so ties resolve in visit
    order as in the reference."""
    dev = rays.device
    n = rays.shape[1]
    node_boxes, leaf_tris = _table_readers(bvh, table)
    o_all, inv_all, d_all, tm_all = rays[0:3].T, rays[3:6].T, rays[6:9].T, rays[9]
    best_t = tm_all.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    inner_pops = torch.zeros(n, dtype=torch.int64, device=dev)
    leaf_pops = torch.zeros(n, dtype=torch.int64, device=dev)
    tri_tests = torch.zeros((n, 4), dtype=torch.int64, device=dev)
    alpha_tests = torch.zeros(n, dtype=torch.int64, device=dev)
    act, lvl, idx, tlo, thi = _walk_start(bvh, tm_all > t_min)
    levels = _level_tables(bvh, dev)
    lanes_t = torch.arange(LEAF_TRIS, dtype=torch.int64, device=dev)
    leaf_ids = bvh.leaf_tri.long()
    while act.numel():
        keep = (tlo != 0) | (thi != 0)
        act, lvl, idx, tlo, thi = act[keep], lvl[keep], idx[keep], tlo[keep], thi[keep]
        if not act.numel():
            break
        lvl, idx, tlo, thi = _advance(lvl, idx, tlo, thi)
        is_leaf = lvl == 0

        # ---- leaf pops: LEAF_TRIS tests against the best t so far
        li = torch.clamp(idx[is_leaf], max=bvh.num_leaves - 1)
        ray = act[is_leaf]
        leaf_pops.index_add_(0, ray, torch.ones_like(ray))
        h16, stage, t16, u16, v16 = _ray_tri_tuv(
            o_all[ray][:, None], d_all[ray][:, None], t_min, best_t[ray][:, None],
            *leaf_tris(li))
        real = lanes_t[None] < bvh.num_tris - li[:, None] * LEAF_TRIS
        h16 = h16 & real
        tri_tests.index_add_(0, ray, (torch.nn.functional.one_hot(stage, 4)
                                      * real[..., None]).sum(dim=1))
        ids = leaf_ids[li]
        cand = torch.nonzero(h16, as_tuple=True)
        alpha_tests.index_add_(0, ray, h16.sum(dim=1))
        if cand[0].numel():
            h16[cand] = alpha_test_fn(ids[cand], u16[cand], v16[cand])
        jt = torch.where(h16, t16, torch.inf).argmin(dim=1, keepdim=True)
        take = h16.gather(1, jt)[:, 0]
        tk, jt = ray[take], jt[take]
        best_t[tk] = t16[take].gather(1, jt)[:, 0]
        best_tri[tk] = ids[take].gather(1, jt)[:, 0]
        best_u[tk] = u16[take].gather(1, jt)[:, 0]
        best_v[tk] = v16[take].gather(1, jt)[:, 0]

        # ---- inner pops: WIDE slab tests against the best t so far
        inner = ~is_leaf
        ray = act[inner]
        inner_pops.index_add_(0, ray, torch.ones_like(ray))
        _push_children(levels, node_boxes, inner, lvl, idx, tlo, thi, o_all[ray],
                       inv_all[ray], best_t[ray])
    return (best_tri >= 0, best_t, best_tri.to(torch.int32), best_u, best_v,
            inner_pops, leaf_pops, tri_tests, alpha_tests)


def closest_walk(bvh: BVH, table, rays: torch.Tensor, t_min: float, alpha_test_fn):
    """The plain closest-hit, alpha-tested walk over ray planes [10, N]
    (as ``occlusion_walk``) -> (hit bool, t, tri id int32 (-1 on a miss),
    u, v, inner pops, leaf pops, triangle tests by exit stage [N, 4],
    alpha tests) per ray, in chunks of RAY_CHUNK rays. A miss keeps t =
    t_max and u = v = 0. ``alpha_test_fn(tri_ids, u, v) -> bool``
    confirms the candidates that hit (the caster's alpha re-test)."""
    outs = [_closest_chunk(bvh, table, rays[:, s : s + RAY_CHUNK], float(t_min),
                           alpha_test_fn)
            for s in range(0, rays.shape[1], RAY_CHUNK)]
    if not outs:
        return _closest_chunk(bvh, table, rays, float(t_min), alpha_test_fn)
    return tuple(torch.cat(parts) for parts in zip(*outs))


def trace_closest_plain(bvh: BVH, table, rays: torch.Tensor, t_min: float,
                        alpha_test_fn) -> tuple:
    """(hit, t, tri id, u, v) of the plain closest-hit walk: the plain
    version of the closest-hit kernel (ops/bvh_closest.py)."""
    return closest_walk(bvh, table, rays, t_min, alpha_test_fn)[:5]
