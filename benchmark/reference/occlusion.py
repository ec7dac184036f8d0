"""The plain reference's ray-traced shadows: any-hit occlusion of shadow
rays against every triangle of the frame, through a wide bounding-volume
hierarchy the reference builds itself.

The hierarchy is built once, as a renderer builds its acceleration
structure at load: from the scene's pose at set-up, triangles are sorted
by the 30-bit Morton code of their box centres (ties by id), 16 to a
leaf, eight children to a node, level by level up to one root. Each
frame refits the boxes to the frame's world positions, keeping the
topology. The walk is level-synchronous: every (ray, node) pair whose
box the ray enters (slab test) goes on to the node's children, and every
(ray, leaf) pair tests the leaf's triangles (Moller-Trumbore, t in
(t_min, t_max)). A ray is occluded where any test hits. With ``counts``
the walk also returns the least work an any-hit walk of this tree needs
for these rays (benchmark/work/walk.py reads it for kernel 5's
roofline), by the stage at which each triangle test leaves: a ray that
misses pops every node whose box it enters and tests every triangle of
every leaf it enters, as any walk must; a ray that hits pops only the
nodes on the path to one leaf that holds a hit, and tests that leaf's
triangles up to its first hit, taking the leaf with the fewest such
tests (all leaves lie at one depth), as a walk that chose each child
right would.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

LEAF, WIDE = 16, 8
RAY_CHUNK = 1 << 19
T_MIN = 0.001
SUN_T_MAX = 10_000.0


class Tree(NamedTuple):
    levels: list  # root first: [m, WIDE, 6] child boxes (min xyz, max xyz); +inf/-inf pads
    children: list  # root first: real children below each level (nodes or leaves)
    leaf_tris: torch.Tensor  # [leaves, LEAF, 3, 3] v0, e1 = v1 - v0, e2 = v2 - v0
    leaf_real: torch.Tensor  # [leaves, LEAF] bool: a real triangle in the slot


def _morton(x: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of points in [0, 1]^3."""
    q = np.clip(x * 1024.0, 0, 1023).astype(np.uint32)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def leaf_slots(scene, tri_vtx: np.ndarray) -> np.ndarray:
    """[leaves, LEAF] triangle ids of the hierarchy built from the scene's
    pose at set-up (the last slot of the last leaf repeats its triangle)."""
    obj, t, s, q = [], [], [], []
    for inst in scene.instances:
        p = scene.primitives[inst.primitive].positions
        obj.append(p)
        t.append(np.tile(np.array(inst.translation, np.float32), (len(p), 1)))
        s.append(np.full(len(p), inst.scale, np.float32))
        q.append(np.tile(np.array(inst.rotation, np.float32), (len(p), 1)))
    obj, t, s, q = (np.concatenate(a) for a in (obj, t, s, q))
    qv, qw = q[:, :3], q[:, 3:4]
    tvec = 2.0 * np.cross(qv, obj)
    world = (t + s[:, None] * (obj + qw * tvec + np.cross(qv, tvec))).astype(np.float32)
    v = world[tri_vtx]
    lo, hi = v.min(1), v.max(1)
    centre = (lo + hi) * 0.5
    smin, smax = lo.min(0), hi.max(0)
    codes = _morton((centre - smin) / np.maximum(smax - smin, 1e-9))
    n = len(tri_vtx)
    order = np.lexsort((np.arange(n), codes)).astype(np.int64)
    leaves = -(-n // LEAF)
    return np.concatenate([order, np.full(leaves * LEAF - n, order[-1])]).reshape(leaves, LEAF)


def refit(slots: torch.Tensor, tri_xyz: torch.Tensor) -> Tree:
    """The hierarchy over ``slots`` with boxes fitted to the frame's
    triangles [T, 3, 3] (world positions)."""
    dev = tri_xyz.device
    leaves = slots.shape[0]
    real = torch.arange(leaves * LEAF, device=dev).reshape(leaves, LEAF) < tri_xyz.shape[0]
    v = tri_xyz[slots]
    leaf_tris = torch.stack([v[:, :, 0], v[:, :, 1] - v[:, :, 0], v[:, :, 2] - v[:, :, 0]], 2)
    flat = v.reshape(leaves, LEAF * 3, 3)
    bmin, bmax = flat.amin(1), flat.amax(1)
    levels, children = [], []
    while True:
        n = bmin.shape[0]
        m = -(-n // WIDE)
        p = m * WIDE - n
        pmin = torch.cat([bmin, bmin.new_full((p, 3), torch.inf)]).reshape(m, WIDE, 3)
        pmax = torch.cat([bmax, bmax.new_full((p, 3), -torch.inf)]).reshape(m, WIDE, 3)
        levels.append(torch.cat([pmin, pmax], -1))
        children.append(n)
        bmin, bmax = pmin.amin(1), pmax.amax(1)
        if m == 1:
            break
    return Tree(levels[::-1], children[::-1], leaf_tris, real)


def _inverse(d: torch.Tensor) -> torch.Tensor:
    big = torch.where(d < 0, -1e20, 1e20).to(d.dtype)
    return torch.where(torch.abs(d) > 1e-20, 1.0 / d, big)


def _slab(o, inv, t_max, box):
    t0 = (box[..., :3] - o) * inv
    t1 = (box[..., 3:] - o) * inv
    enter = torch.minimum(t0, t1).amax(-1)
    leave = torch.maximum(t0, t1).amin(-1)
    return (enter <= leave) & (leave >= 0.0) & (enter <= t_max)


def _tri(o, d, t_max, tri):
    """Moller-Trumbore -> (hit, exit stage: 0 determinant, 1 u, 2 v, 3 all)."""
    def dot(a, b):
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]

    def cross(a, b):
        return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)

    v0, e1, e2 = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, 1.0 / det, 0.0)
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN) & (t < t_max)
    u_out = ~((u >= 0.0) & (u <= 1.0))
    v_out = ~((v >= 0.0) & (u + v <= 1.0))
    stage = torch.where(~ok, 0, torch.where(u_out, 1, torch.where(v_out, 2, 3)))
    return hit, stage


def occluded(tree: Tree, o, d, t_max, counts: bool = False):
    """Any hit of rays (o, d) [N, 3] in (T_MIN, t_max [N]) -> hit [N] bool
    (and with ``counts``, (inner pops, [tests leaving at stages 0..3]) of
    the least any-hit walk)."""
    dev = o.device
    n = o.shape[0]
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    inv = _inverse(d)
    lanes = torch.arange(WIDE, device=dev)
    slot = torch.arange(LEAF, device=dev)
    if counts:
        # per ray: nodes popped, the stages of every test (all its leaves,
        # read where it misses), and the cheapest hitting leaf's tests as
        # the key (tests up to the hit << 20 | four 5-bit stage counts)
        pops = torch.zeros(n, dtype=torch.int64, device=dev)
        stages = torch.zeros((n, 4), dtype=torch.int64, device=dev)
        best = torch.full((n,), 1 << 62, dtype=torch.int64, device=dev)
    for s in range(0, n, RAY_CHUNK):
        ray = torch.nonzero(t_max[s : s + RAY_CHUNK] > 0)[:, 0] + s
        node = torch.zeros_like(ray)
        for lvl, boxes in enumerate(tree.levels):
            if counts:
                pops.index_add_(0, ray, torch.ones_like(ray))
            h = _slab(o[ray][:, None], inv[ray][:, None], t_max[ray][:, None], boxes[node])
            h &= (node[:, None] * WIDE + lanes[None]) < tree.children[lvl]
            pair = torch.nonzero(h)
            ray, node = ray[pair[:, 0]], node[pair[:, 0]] * WIDE + pair[:, 1]
        for c in range(0, ray.numel(), RAY_CHUNK):
            r, lf = ray[c : c + RAY_CHUNK], node[c : c + RAY_CHUNK]
            h, stage = _tri(o[r][:, None], d[r][:, None], t_max[r][:, None], tree.leaf_tris[lf])
            h &= tree.leaf_real[lf]
            any_h = h.any(dim=1)
            hit[r[any_h]] = True
            if counts:
                # a leaf's tests up to its first hit (all its real slots
                # where none hits), as four stage counts per (ray, leaf)
                first = torch.where(any_h, h.to(torch.int8).argmax(1), LEAF - 1)
                tested = (slot[None] <= first[:, None]) & tree.leaf_real[lf]
                per = torch.stack([(tested & (stage == k)).sum(1) for k in range(4)], 1)
                stages.index_add_(0, r, per)
                key = ((first + 1) << 20) | per[:, 0] | (per[:, 1] << 5) | (per[:, 2] << 10) \
                    | (per[:, 3] << 15)
                best.scatter_reduce_(0, r[any_h], key[any_h], "amin")
    if counts:
        miss = ~hit
        packed = best[hit]
        hit_stages = torch.stack([(packed >> (5 * k)) & 31 for k in range(4)], 1)
        n_pops = int(pops[miss].sum()) + int(hit.sum()) * len(tree.levels)
        tests = stages[miss].sum(0) + hit_stages.sum(0)
        return hit, (n_pops, [int(x) for x in tests])
    return hit


def shadow_fn(scene, tri_vtx: torch.Tensor):
    """shadows(world, tri_vtx, position, sun_dir, in_list, lights) -> (sun
    factor [M], light factors [M, L]) for reference/frame.py: the
    hierarchy refitted to the frame, a sun ray (t_max 10,000) and a ray
    to each light of the pixel's cluster list (t_max its distance) from
    every shaded point."""
    slots = torch.from_numpy(leaf_slots(scene, tri_vtx.cpu().numpy())).to(tri_vtx.device)

    def shadows(world, tri_vtx, position, sun_dir, in_list, lights):
        tree = refit(slots, world[tri_vtx])
        n = position.shape[0]
        dirs = [sun_dir.expand(n, 3)]
        tmax = [torch.full((n,), SUN_T_MAX, device=position.device)]
        for li in range(lights.shape[0]):
            to = lights[li] - position
            dist = torch.sqrt(to[:, 0] * to[:, 0] + to[:, 1] * to[:, 1] + to[:, 2] * to[:, 2])
            dirs.append(to / torch.clamp(dist[:, None], min=1e-12))
            tmax.append(torch.where(in_list[:, li], dist, 0.0))
        k = len(dirs)
        hit = occluded(tree, position.repeat(k, 1), torch.cat(dirs), torch.cat(tmax))
        f = torch.where(hit, 0.0, 1.0).reshape(k, n)
        return f[0], f[1:].T

    return shadows
