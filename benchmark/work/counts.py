"""The least time the card could take for a kernel call: the bytes it
must move and the operations it must compute, against the card's peaks.

Peaks (NVIDIA H100 SXM5 80GB data sheet, at its 700 W limit): HBM3
3.35e12 bytes/s; float32 outside the tensor cores 67e12 operations/s
counting a fused multiply-add as two. The port's kernels build with
``--fmad=false``, so every add, multiply, min/max and compare counted
here issues on its own: 33.5e12 of them a second. A card set below
700 W (``nvidia-smi --query-gpu=power.limit``) runs below these peaks,
so every run prints the limit beside its numbers.

What is counted comes from the frame's own arrays, never from the
kernel's own bookkeeping: for the G-buffer raster (kernel 1), the pixels
of the tiles it races, the records of each tile's run in the frame's
sorted (tile, class) stream and of the big list, the (pixel, record)
pairs where the record covers the pixel, and the pixels that some
record wins; each is counted by plain code here, so a kernel that
replaces kernel 1 is held to the same work.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2

TILE_H, TILE_W = 8, 128
REC_F32 = 64
CLASS_SHIFT = 22
# G-buffer planes: 22, less 6 without position derivatives, 6 without uvs
ALL_PLANES, DPOS_PLANES, UV_PLANES = 22, 6, 6
# items (tile, list position) evaluated at once when counting
CHUNK = 2048


def bound_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def kernel_work(name: str, call) -> tuple:
    """(bytes, operations) one recorded call must move and compute."""
    if name == "raster_gbuf":
        return raster_gbuf_work(*call)
    if name == "bvh_occlusion":
        from benchmark.work.walk import occlusion_work

        return occlusion_work(*call)
    raise KeyError(name)


def _pixel_ndc(tile_ids, width, height):
    tiles_x = -(-width // TILE_W)
    tid = tile_ids.long()
    cols = torch.arange(TILE_W, dtype=torch.float32, device=tid.device)
    rows = torch.arange(TILE_H, dtype=torch.float32, device=tid.device)
    tx = (tid % tiles_x).to(torch.float32)[:, None, None]
    ty = (tid // tiles_x).to(torch.float32)[:, None, None]
    nx = ((tx * TILE_W + cols[None, None, :]) + 0.5) * (2.0 / width) - 1.0
    ny = ((ty * TILE_H + rows[None, :, None]) + 0.5) * (2.0 / height) - 1.0
    shape = (tid.shape[0], TILE_H, TILE_W)
    return nx.expand(shape), ny.expand(shape)


def raster_gbuf_work(args, kwargs) -> tuple:
    """Kernel 1's call (payload rows, tile ids, tile starts, big count,
    width, height; seeds, peel bounds, pass class, channels): every
    listed tile tests the big list and its own run. 42 of a record's 64
    floats are read, each tile's 8x128 depth seed (and peel bound) and
    every active plane is written. Per (pixel, record) pair three edge
    functions and their coverage tests (15 operations); where the record
    covers the pixel the w and z sums, a divide and 5 tests more (31 in
    all); per pixel some record wins, its interpolation once: 11
    operations of set-up, 6 per interpolated value (position, normal,
    uv) and 18 per derivative pair (uv, and position with its
    derivatives)."""
    payload, tile_ids, tile_start, big_count, width, height = args
    pass_class = kwargs.get("pass_class")
    pos_derivs = kwargs.get("pos_derivs", True)
    uv = kwargs.get("uv_channels", True)
    seed = kwargs.get("init_depth_tiles")
    max_depth = kwargs.get("max_depth_tiles")
    n_tiles = kwargs.get("n_tiles_global") or (-(-width // TILE_W) * -(-height // TILE_H))
    nc = (tile_start.shape[0] - 1) // n_tiles
    recs = payload[0].reshape(-1, REC_F32)
    nbig = int(big_count)
    big = payload[1].reshape(-1, REC_F32)[:nbig]
    tid = tile_ids.long()
    if pass_class is None or nc == 1:
        start, end = tile_start[nc * tid].long(), tile_start[nc * tid + nc].long()
    else:
        start = tile_start[nc * tid + pass_class].long()
        end = tile_start[nc * tid + pass_class + 1].long()
    count = end - start
    k = tid.shape[0]
    nx, ny = _pixel_ndc(tile_ids, width, height)
    if seed is None:
        seed = torch.zeros((k, TILE_H, TILE_W), dtype=torch.float32, device=tid.device)
    won = torch.zeros((k, TILE_H, TILE_W), dtype=torch.int32, device=tid.device)
    covered = torch.zeros((), dtype=torch.int64, device=tid.device)
    # one item per (tile slot, list position): the big list, then the run
    n_items = nbig + count
    slot = torch.repeat_interleave(torch.arange(k, device=tid.device), n_items)
    first = torch.cumsum(n_items, 0) - n_items
    pos = torch.arange(slot.shape[0], device=tid.device) - first[slot]
    lrecs = torch.cat([big, recs]) if nbig else recs
    rows_all = torch.where(pos < nbig, pos, nbig + start[slot] + pos - nbig)
    for s in range(0, slot.shape[0], CHUNK):
        sl = slot[s : s + CHUNK]
        r = lrecs[rows_all[s : s + CHUNK]]

        def f(i):
            return r[:, i][:, None, None]

        x, y = nx[sl], ny[sl]
        e0 = f(0) * x + f(1) * y + f(2)
        e1 = f(3) * x + f(4) * y + f(5)
        e2 = f(6) * x + f(7) * y + f(8)

        def cov(ev, a, b):
            return (ev > 0) | ((ev == 0) & ((a > 0) | ((a == 0) & (b > 0))))

        inside = cov(e0, f(0), f(1)) & cov(e1, f(3), f(4)) & cov(e2, f(6), f(7))
        if pass_class is not None:
            inside &= (f(15).to(torch.int32) >> CLASS_SHIFT) == pass_class
        covered += inside.sum()
        w_int = e0 * f(12) + e1 * f(13) + e2 * f(14)
        depth = (e0 * f(9) + e1 * f(10) + e2 * f(11)) / w_int
        ok = inside & (w_int > 0) & (depth >= 0.0) & (depth <= 1.0) & (depth > seed[sl])
        if max_depth is not None:
            ok &= depth < max_depth[sl]
        won.index_add_(0, sl, ok.to(torch.int32))
    winners = int((won > 0).sum())
    covered = int(covered)
    planes = ALL_PLANES - (0 if pos_derivs else DPOS_PLANES) - (0 if uv else UV_PLANES)
    seeds = 1 + (max_depth is not None)
    px = k * TILE_H * TILE_W
    runs = int(count.sum())
    nbytes = (runs + nbig) * 42 * 4 + k * 12 + px * 4 * (seeds + planes)
    interp = 11 + 6 * (6 + 2 * uv) + 18 * (2 * uv + 3 * pos_derivs)
    pairs = (runs + k * nbig) * TILE_H * TILE_W
    return nbytes, (pairs - covered) * 15 + covered * 31 + winners * interp
