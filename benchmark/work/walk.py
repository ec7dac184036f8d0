"""Kernel 5's work (any-hit shadow rays through the frame's wide BVH):
the walk table once, the ray planes once, a hit byte per ray; 25
operations a child box per inner-node pop (8 children: 6 subtractions,
6 multiplies, 10 min/max and 3 compares each), and per triangle test by
the stage at which it leaves: 16 operations at the determinant, 28 at u,
46 at v, 54 for the whole test.

The pops and tests are the least an any-hit walk of the call's own tree
needs for the call's rays, as benchmark/reference/occlusion.py counts
them: a ray that misses pops every node whose box it enters and tests
every triangle of every leaf it enters; a ray that hits pops one node a
level down to one leaf that holds a hit and tests that leaf up to its
first hit, the leaf with the fewest such tests. No walk does less, so a
kernel's share of this bound is never flattered by a ray that hits.
"""

from __future__ import annotations

import torch

from benchmark.reference.occlusion import LEAF, WIDE, Tree, occluded

STAGE_OPS = (16, 28, 46, 54)


def _tree(bvh, table) -> Tree:
    """The call's tree in the walk's layout: levels root first, leaf
    triangles as (v0, e1, e2) from the kernel's own table."""
    levels, children = [], []
    for k in range(bvh.num_levels - 1, -1, -1):
        off, m = bvh.level_offsets[k], bvh.level_counts[k]
        levels.append(bvh.node_boxes[off : off + m].reshape(m, WIDE, 6))
        children.append(bvh.children_below(k))
    tris = table.tris.reshape(bvh.num_leaves, LEAF, 3, 4)[..., :3]
    real = torch.arange(bvh.num_leaves * LEAF, device=tris.device).reshape(-1, LEAF) < bvh.num_tris
    return Tree(levels, children, tris, real)


def occlusion_work(args, kwargs) -> tuple:
    bvh, table, rays, t_min = args
    if abs(float(t_min) - 0.001) > 1e-9:
        raise ValueError(f"the walk counts rays with t_min 0.001, not {t_min}")
    _, (pops, tests) = occluded(_tree(bvh, table), rays[0:3].T, rays[6:9].T, rays[9],
                                counts=True)
    nbytes = sum(t.nbytes for t in table) + rays.nbytes + rays.shape[1]
    return nbytes, pops * WIDE * 25 + sum(n * c for n, c in zip(tests, STAGE_OPS))
