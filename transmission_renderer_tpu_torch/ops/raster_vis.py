"""Visibility raster: triangle records in; triangle id, depth and two
perspective-correct barycentrics out.

Counterpart of ``transmission_renderer_tpu/ops/raster_pallas.py``
(pack_payload, gather_bin_payload, rasterize_pallas_tiles,
rasterize_pallas) and of the pure raster of
``transmission_renderer_tpu/ops/raster.py`` (_raster_tile,
rasterize_tilelist, rasterize), which computes the same function with
another walk order. Kernel 6 of the port: ``raster_vis`` launches
``csrc/raster_vis.cu`` for CUDA tensors and runs ``raster_vis_plain``
for CPU tensors, in one of two orders:

- kernel-6 order (``xla_order=False``; raster_pallas.py:203-251): the big
  list, then the tile's record run; a record wins where its depth is
  strictly greater; b = e * (1 / esum). ``rasterize_pallas*`` take it,
  with 8x128 tiles and runs from the uncut ``tile_start``.
- XLA-raster order (``xla_order=True``; raster.py:518-600): the tile's
  run cut to ``max_tris_per_tile``, then the big list; a record wins where
  its depth is greater, or equal with a smaller triangle id; b = e / esum.
  ``rasterize_tilelist`` / ``rasterize`` take it, with any tile size of
  at most 1024 pixels. The visibility-buffer frame rasterises this way.

The two orders pick different triangles on exact depth ties across the
big list and the binned run, so the order is a parameter, not one rule.

Both reference functions run compiled on the CPU, where the compiler
contracts multiply-adds: an edge function is fma(a, nx, b * ny) + c and
the clip w and z sums are fma(e2, v2, fma(e0, v0, e1 * v1)). The port
computes exactly these (the kernel with fmaf, the plain version through
float64), which reproduces the reference's depths and barycentrics bit
for bit, and with them its coverage and depth-race decisions.

Record layout [N, 16] float32: signed adjugate rows (9), clip z (3),
clip w (3), tri id + CLASS_BIT * class as a float value (1). The TPU
kernel packed 8 records per 128-lane row for its DMA; here a record is a
row of its own.
"""

from __future__ import annotations

import torch

from transmission_renderer_tpu_torch import kernels
from transmission_renderer_tpu_torch.ops.raster import (
    TileBins,
    TriangleSetup,
    VisibilityBuffer,
    _fma,
    tile_image,
    untile_image,
)

TILE_H = 8
TILE_W = 128
REC_F32 = 16
CLASS_SHIFT = 22
CLASS_BIT = 1 << CLASS_SHIFT
MAX_TILE_PX = 1024  # one CUDA thread per pixel of a tile


def pack_payload(setup: TriangleSetup, class_flags: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """[T, 16] float32 records; ``class_flags`` ([T], 1 = transmissive)
    selects each record's draw class."""
    t = setup.adj.shape[0]
    if t > CLASS_BIT:
        raise ValueError(f"{t} records exceed the 2^22 tri-id field")
    ids = torch.arange(t, dtype=torch.int32, device=setup.adj.device)
    if class_flags is not None:
        ids = ids + CLASS_BIT * class_flags.to(torch.int32)
    return torch.cat([setup.adj.reshape(t, 9), setup.z_clip, setup.w_clip,
                      ids.to(torch.float32)[:, None]], dim=1)


def gather_bin_payload(setup: TriangleSetup, bins: TileBins,
                       class_flags: torch.Tensor | None = None):
    """(records in sorted-pair order [S, 16], big-list records [B, 16]);
    -1 entries read a degenerate record (all-zero edges never cover)."""
    payload = pack_payload(setup, class_flags)
    t = payload.shape[0]
    degenerate = payload.new_zeros((1, REC_F32))
    degenerate[0, 15] = -1.0
    ext = torch.cat([payload, degenerate])

    def rows(ids):
        return ext[torch.where(ids >= 0, ids, t).long()].contiguous()

    return rows(bins.sorted_tri_ids), rows(bins.big_tri_ids)


def _covered(e, a, b):
    """Top-left fill rule: e > 0, or e == 0 on a top or left edge."""
    tl = (a > 0) | ((a == 0) & (b > 0))
    return (e > 0) | ((e == 0) & tl)


def raster_vis_plain(
    records: torch.Tensor,  # [S, 16] sorted-pair records
    big: torch.Tensor,  # [B, 16] big-list records
    tile_ids: torch.Tensor,  # [K] int32 global tile ids
    run_start: torch.Tensor,  # [K] int32 first record of each tile's run
    run_count: torch.Tensor,  # [K] int32 records in each run
    big_count: torch.Tensor,  # [1] int32 big records walked by every tile
    width: int,
    height: int,
    tile_w: int,
    tile_h: int,
    init_depth_tiles: torch.Tensor | None = None,  # [K, tile_h, tile_w]
    pass_class: int | None = None,
    xla_order: bool = True,
) -> tuple:
    """The visibility raster in plain PyTorch -> (tri [K, th, tw] int32,
    depth, b1, b2). Tiles race in parallel, one record rank per step;
    each record's arithmetic is the kernel's (see the module docstring)."""
    dev = records.device
    k_tiles = tile_ids.shape[0]
    tiles_x = -(-width // tile_w)
    tid = tile_ids.long()
    tx = (tid % tiles_x).to(torch.float32)[:, None, None]
    ty = (tid // tiles_x).to(torch.float32)[:, None, None]
    cols = torch.arange(tile_w, dtype=torch.float32, device=dev)
    rows = torch.arange(tile_h, dtype=torch.float32, device=dev)
    shape = (k_tiles, tile_h, tile_w)
    nx = (((tx * tile_w + cols[None, None, :]) + 0.5) * (2.0 / width) - 1.0).expand(shape)
    ny = (((ty * tile_h + rows[None, :, None]) + 0.5) * (2.0 / height) - 1.0).expand(shape)

    best_tri = torch.full(shape, -1, dtype=torch.int32, device=dev)
    best_depth = (init_depth_tiles.clone() if init_depth_tiles is not None
                  else torch.zeros(shape, dtype=torch.float32, device=dev))
    best_b1 = torch.zeros(shape, dtype=torch.float32, device=dev)
    best_b2 = torch.zeros(shape, dtype=torch.float32, device=dev)

    def race(rec, act):
        """Race one record per active tile (rec [A or 1, 16])."""
        def f(i):
            return rec[:, i][:, None, None]

        a0, b0, c0 = f(0), f(1), f(2)
        a1, b1, c1 = f(3), f(4), f(5)
        a2, b2, c2 = f(6), f(7), f(8)
        pnx, pny = nx[act], ny[act]
        e0 = _fma(a0, pnx, b0 * pny) + c0
        e1 = _fma(a1, pnx, b1 * pny) + c1
        e2 = _fma(a2, pnx, b2 * pny) + c2
        inside = _covered(e0, a0, b0) & _covered(e1, a1, b1) & _covered(e2, a2, b2)
        w_int = _fma(e2, f(14), _fma(e0, f(12), e1 * f(13)))
        z_int = _fma(e2, f(11), _fma(e0, f(9), e1 * f(10)))
        depth = z_int / w_int
        inside &= (w_int > 0) & (depth >= 0.0) & (depth <= 1.0)
        tri_enc = rec[:, 15].to(torch.int32)[:, None, None]
        if pass_class is not None:
            inside &= (((tri_enc >> CLASS_SHIFT) & 1) == 1) == (pass_class == 1)
        tri = torch.where(tri_enc < 0, tri_enc, tri_enc & (CLASS_BIT - 1))
        esum = e0 + e1 + e2
        bd, bt = best_depth[act], best_tri[act]
        if xla_order:
            win = inside & ((depth > bd) | ((depth == bd) & (tri < bt)))
            nb1, nb2 = e1 / esum, e2 / esum
        else:
            win = inside & (depth > bd)
            inv = 1.0 / esum
            nb1, nb2 = e1 * inv, e2 * inv
        best_tri[act] = torch.where(win, tri, bt)
        best_b1[act] = torch.where(win, nb1, best_b1[act])
        best_b2[act] = torch.where(win, nb2, best_b2[act])
        best_depth[act] = torch.where(win, depth, bd)

    everyone = slice(None)

    def walk_runs():
        start = run_start.long()
        for j in range(int(run_count.max()) if k_tiles else 0):
            act = torch.nonzero(run_count > j)[:, 0]
            race(records[start[act] + j], act)

    def walk_big():
        for j in range(int(big_count[0])):
            race(big[j : j + 1], everyone)

    if xla_order:
        walk_runs()
        walk_big()
    else:
        walk_big()
        walk_runs()
    return best_tri, best_depth, best_b1, best_b2


def _raster_vis_cuda(records, big, tile_ids, run_start, run_count, big_count, width,
                     height, tile_w, tile_h, init_depth_tiles=None, pass_class=None,
                     xla_order=True) -> tuple:
    dev = records.device
    k_tiles = tile_ids.shape[0]
    if tile_w * tile_h > MAX_TILE_PX:
        raise ValueError(f"{tile_w}x{tile_h} tiles: the kernel takes at most "
                         f"{MAX_TILE_PX} pixels a tile")
    kernels.check(records, "records", torch.float32, (records.shape[0], REC_F32))
    kernels.check(big, "big records", torch.float32, (big.shape[0], REC_F32), device=dev)
    kernels.check(tile_ids, "tile_ids", torch.int32, (k_tiles,), device=dev)
    kernels.check(run_start, "run_start", torch.int32, (k_tiles,), device=dev)
    kernels.check(run_count, "run_count", torch.int32, (k_tiles,), device=dev)
    kernels.check(big_count, "big_count", torch.int32, (1,), device=dev)
    shape = (k_tiles, tile_h, tile_w)
    if init_depth_tiles is not None:
        kernels.check(init_depth_tiles, "init_depth_tiles", torch.float32, shape, device=dev)
    tri = torch.empty(shape, dtype=torch.int32, device=dev)
    depth, b1, b2 = torch.empty((3,) + shape, dtype=torch.float32, device=dev)
    fn = kernels.entry("trt_raster_vis", [
        kernels.VOIDP, kernels.VOIDP, kernels.VOIDP, kernels.VOIDP, kernels.VOIDP,
        kernels.VOIDP, kernels.VOIDP, kernels.INT, kernels.INT, kernels.INT,
        kernels.INT, kernels.FLOAT, kernels.FLOAT, kernels.INT, kernels.INT,
        kernels.VOIDP, kernels.VOIDP, kernels.VOIDP, kernels.VOIDP,
    ])
    kernels.launch(
        KERNEL, fn, kernels.ptr(records), kernels.ptr(big), kernels.ptr(big_count),
        kernels.ptr(tile_ids), kernels.ptr(run_start), kernels.ptr(run_count),
        kernels.ptr(init_depth_tiles), k_tiles, -(-width // tile_w), tile_w, tile_h,
        2.0 / width, 2.0 / height, -1 if pass_class is None else int(pass_class),
        int(xla_order), kernels.ptr(tri), kernels.ptr(depth), kernels.ptr(b1),
        kernels.ptr(b2),
    )
    return tri, depth, b1, b2


KERNEL = kernels.KernelHandle(
    "raster_vis", "transmission_renderer_tpu_torch/csrc/raster_vis.cu",
    "transmission_renderer_tpu/ops/raster_pallas.py:103",
    cuda=_raster_vis_cuda, plain=raster_vis_plain,
)


def raster_vis(records, big, tile_ids, run_start, run_count, big_count, width, height,
               tile_w, tile_h, init_depth_tiles=None, pass_class=None,
               xla_order=True) -> tuple:
    """Kernel 6 (plain version for CPU tensors): see raster_vis_plain."""
    return KERNEL(records.is_cuda, records, big, tile_ids, run_start, run_count,
                  big_count, width, height, tile_w, tile_h,
                  init_depth_tiles=init_depth_tiles, pass_class=pass_class,
                  xla_order=xla_order)


def _untiled(outs, width, height, tile_w, tile_h) -> VisibilityBuffer:
    tiles_x, tiles_y = -(-width // tile_w), -(-height // tile_h)

    def untile(a):
        return untile_image(a, tiles_x, tiles_y, tile_w, tile_h, width, height)

    tri, depth, b1, b2 = outs
    return VisibilityBuffer(tri_id=untile(tri), depth=untile(depth),
                            bary=torch.stack([untile(b1), untile(b2)], dim=-1))


# ---------------------------------------------------------------------------
# kernel-6 order: the reference's Pallas raster
# ---------------------------------------------------------------------------

def rasterize_pallas_tiles(
    setup: TriangleSetup,
    bins: TileBins,
    tile_ids: torch.Tensor,  # [K] int32 global tile ids
    tile_start: torch.Tensor,  # [K + 1] int32 into the sorted payload
    width: int,
    height: int,
    init_depth_tiles: torch.Tensor | None = None,  # [K, 8, 128]
    pass_class: int | None = None,
    payload: tuple | None = None,
) -> tuple:
    """The reference kernel over a tile list -> (tri, depth, b1, b2), each
    [K, 8, 128]. ``pass_class`` filters records by draw class (records
    packed with class flags); ``payload`` shares one gather across passes."""
    payload, big = payload if payload is not None else gather_bin_payload(setup, bins)
    n_big = bins.big_tri_ids.shape[0]
    # a length-1 big list means big triangles ride the sorted stream
    big_count = (torch.zeros((1,), dtype=torch.int32, device=big.device) if n_big <= 1
                 else torch.clamp(bins.big_tri_count, max=n_big).to(torch.int32).reshape(1))
    start = tile_start[:-1].contiguous()
    return raster_vis(payload, big, tile_ids.contiguous(), start,
                      (tile_start[1:] - start).contiguous(), big_count, width, height,
                      TILE_W, TILE_H, init_depth_tiles=init_depth_tiles,
                      pass_class=pass_class, xla_order=False)


def rasterize_pallas(setup: TriangleSetup, bins: TileBins, width: int, height: int,
                     init_depth: torch.Tensor | None = None,
                     pass_class: int | None = None,
                     payload: tuple | None = None) -> VisibilityBuffer:
    """Full-frame raster in kernel-6 order (8x128 tiles, uncut runs)."""
    n_tiles = -(-width // TILE_W) * -(-height // TILE_H)
    tile_ids = torch.arange(n_tiles, dtype=torch.int32, device=setup.adj.device)
    init = (tile_image(init_depth, TILE_W, TILE_H).contiguous()
            if init_depth is not None else None)
    outs = rasterize_pallas_tiles(setup, bins, tile_ids, bins.tile_start, width, height,
                                  init_depth_tiles=init, pass_class=pass_class,
                                  payload=payload)
    return _untiled(outs, width, height, TILE_W, TILE_H)


# ---------------------------------------------------------------------------
# XLA-raster order: the reference's pure raster over materialised bins
# ---------------------------------------------------------------------------

def rasterize_tilelist(
    setup: TriangleSetup,
    bins: TileBins,  # from bin_triangles_materialized
    tile_indices: torch.Tensor,  # [K] int32 global tile ids
    width: int,
    height: int,
    tile_w: int,
    tile_h: int,
    init_depth_tiles: torch.Tensor | None = None,  # [K, tile_h, tile_w]
    payload: tuple | None = None,
) -> tuple:
    """Rasterise a list of tiles in XLA-raster order -> (tri, depth, b1,
    b2), each [K, tile_h, tile_w]. Each tile walks the first
    ``tile_tri_count`` records of its sorted run (its materialised list),
    then the big list."""
    payload, big = payload if payload is not None else gather_bin_payload(setup, bins)
    tid = tile_indices.long()
    big_count = bins.big_tri_count.to(torch.int32).reshape(1)
    return raster_vis(payload, big, tile_indices.contiguous(),
                      bins.tile_start[tid].contiguous(),
                      bins.tile_tri_count[tid].contiguous(), big_count, width, height,
                      tile_w, tile_h, init_depth_tiles=init_depth_tiles, xla_order=True)


def rasterize(setup: TriangleSetup, bins: TileBins, width: int, height: int,
              tile_w: int, tile_h: int, init_depth: torch.Tensor | None = None,
              payload: tuple | None = None) -> VisibilityBuffer:
    """Rasterise every tile (XLA-raster order) into a visibility buffer;
    ``init_depth`` ([H, W]) seeds the depth race with an existing
    surface. Alpha-clip coverage (the reference's ``alpha_coverage_fn``)
    is not part of this raster."""
    n_tiles = -(-width // tile_w) * -(-height // tile_h)
    tile_ids = torch.arange(n_tiles, dtype=torch.int32, device=setup.adj.device)
    init = (tile_image(init_depth, tile_w, tile_h).contiguous()
            if init_depth is not None else None)
    outs = rasterize_tilelist(setup, bins, tile_ids, width, height, tile_w, tile_h,
                              init_depth_tiles=init, payload=payload)
    return _untiled(outs, width, height, tile_w, tile_h)
