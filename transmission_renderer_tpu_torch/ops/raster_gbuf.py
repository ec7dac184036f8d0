"""G-buffer raster: triangle records in, interpolated G-buffer out.

Counterpart of ``transmission_renderer_tpu/ops/raster_pallas_gbuf.py``
(pack_gbuf_payload, gather_gbuf_payload, rasterize_gbuffer_tiles,
rasterize_gbuffer_pallas, gbuffer_from_channels). Kernel 1 of the port:
``rasterize_gbuffer_tiles`` launches ``csrc/raster_gbuf.cu`` (a plan of
the work list ``gbuf_work_list`` describes, a depth race over it, a
per-pixel resolve; one call of the handle) for CUDA tensors and runs
``rasterize_gbuffer_tiles_plain`` for CPU tensors.

Record layout (64 f32, 2 per 128-wide payload row): [0:9] signed
adjugate rows, [9:12] clip z, [12:15] clip w, [15] tri id + CLASS_BIT *
draw class, [16:40] three vertices of pos.xyz nrm.xyz uv.xy, [40]
material id, [41] instance scale, [44:48] the pixel box (x0, y0, x1, y1:
inclusive pixel indices, ops/raster.py::setup_triangles), [42:44] and
[48:64] padding. A record covers a pixel where its three edge functions
pass the top-left rule and the pixel lies in its box.

Each tile walks one list of records: the big list (``big_count``
records of ``payload[1]``, walked by every tile; empty on the frame's
class-split bins, whose big triangles ride the sorted stream, and filled
by materialised bins), then the tile's run of the sorted stream. Per
pixel the raster keeps the first record of that list whose depth beats
the seed depth and every earlier winner (reversed-Z GREATER), and
interpolates the winner's attributes with the closed-form derivatives
dA/dnx = (sum(a_i A_i) D - N sum(a_i)) / D^2 * 2/w.

That winner is exactly the record of maximum depth among those that
pass the seed and ``max_depth`` filters, ties going to the smallest list
position. So a tile's list can be cut into segments of at most ``SEG``
records, each raced on its own, and the segment winners merged by the
64-bit key (float bits of the depth << 32) | (2^32 - 1 - position),
whose unsigned maximum is that winner; the kernel does so, and
``rasterize_gbuffer_tiles_plain(segment=...)`` does it in plain PyTorch.
"""

from __future__ import annotations

import torch

from transmission_renderer_tpu_torch import kernels
from transmission_renderer_tpu_torch.ops.raster import (
    TileBins,
    TriangleSetup,
    tile_image,
    untile_image,
)
from transmission_renderer_tpu_torch.render.gbuffer import GBuffer

TILE_H = 8
TILE_W = 128
REC_F32 = 64
BOX_F32 = 44  # the pixel box's first float: one aligned float4
RECS_PER_ROW = 128 // REC_F32
CHUNK_ROWS = 16  # zero rows padded after the payload, as the reference
CLASS_SHIFT = 22
CLASS_BIT = 1 << CLASS_SHIFT
# records per work item of the kernel's race: a run longer than this is
# raced by several blocks at once (on the 1080p frame the race took 0.41,
# 0.37, 0.33 and 0.32 ms at 256, 128, 64 and 32: PERF.md, Findings)
SEG = 64
# the kernel's plan sorts slots into this many buckets by segment count
PLAN_BUCKETS = 64
KEY_INDEX_MASK = 0xFFFFFFFF

GBUF_CHANNELS = (
    "tri",  # int32
    "depth",
    "pos_x", "pos_y", "pos_z",
    "nrm_x", "nrm_y", "nrm_z",
    "uv_u", "uv_v",
    "duvdx_u", "duvdx_v", "duvdy_u", "duvdy_v",
    "dposdx_x", "dposdx_y", "dposdx_z",
    "dposdy_x", "dposdy_y", "dposdy_z",
    "material",  # int32
    "scale",
)
DPOS_CHANNELS = GBUF_CHANNELS[14:20]
UV_CHANNELS = GBUF_CHANNELS[8:14]
INT_CHANNELS = ("tri", "material")


def active_channels(pos_derivs: bool, uv_channels: bool = True) -> tuple:
    drop = () if pos_derivs else DPOS_CHANNELS
    if not uv_channels:
        drop = drop + UV_CHANNELS
    return tuple(c for c in GBUF_CHANNELS if c not in drop)


def pack_gbuf_payload(
    setup: TriangleSetup,
    tri_vertices: torch.Tensor,  # [T, 3]
    tri_material: torch.Tensor,  # [T]
    tri_scale: torch.Tensor,  # [T]
    world_positions: torch.Tensor,  # [VV, 3]
    world_normals: torch.Tensor,  # [VV, 3]
    uvs: torch.Tensor,  # [VV, 2]
    class_flags: torch.Tensor | None = None,
) -> torch.Tensor:
    """[T, 64] per-frame triangle records."""
    t = setup.adj.shape[0]
    if t > CLASS_BIT:
        raise ValueError(f"{t} records exceed the 2^22 tri-id field")
    ids = torch.arange(t, dtype=torch.int32, device=setup.adj.device)
    if class_flags is not None:
        ids = ids + CLASS_BIT * class_flags.to(torch.int32)
    attr8 = torch.cat([world_positions, world_normals, uvs], dim=1)
    v = attr8[tri_vertices.long()]  # [T, 3, 8]
    return torch.cat(
        [
            setup.adj.reshape(t, 9),
            setup.z_clip,
            setup.w_clip,
            ids.to(torch.float32)[:, None],
            v.reshape(t, 24),
            tri_material.to(torch.float32)[:, None],
            tri_scale[:, None],
            torch.zeros((t, BOX_F32 - 42), dtype=torch.float32, device=setup.adj.device),
            setup.pixel_box,
            torch.zeros((t, REC_F32 - BOX_F32 - 4), dtype=torch.float32,
                        device=setup.adj.device),
        ],
        dim=1,
    )


def gather_gbuf_payload(records: torch.Tensor, bins: TileBins):
    """Records in sorted-pair order -> (rows [R, 128], big_rows), two
    records per row plus CHUNK_ROWS zero rows; sentinel entries read the
    degenerate record (tri id -1)."""
    t = records.shape[0]
    degenerate = torch.zeros((1, REC_F32), dtype=torch.float32,
                             device=records.device)
    degenerate[0, 15] = -1.0
    rec_ext = torch.cat([records, degenerate], dim=0)

    def pack_rows(ids, extra_pad):
        ids = torch.where(ids >= 0, ids, t).long()
        recs = rec_ext[ids]
        pad = (-recs.shape[0]) % RECS_PER_ROW
        rows = torch.cat([recs, recs.new_zeros((pad, REC_F32))]).reshape(-1, 128)
        if extra_pad:
            rows = torch.cat([rows, rows.new_zeros((extra_pad, 128))])
        return rows

    return (
        pack_rows(bins.sorted_tri_ids, CHUNK_ROWS),
        pack_rows(bins.big_tri_ids, 0),
    )


def _tile_runs(tile_start, tile_ids, num_classes, pass_class):
    """(start, count) [K] int64 of each listed tile's run in the pass: the
    class's run, or every class's (no class, or one-class bins)."""
    tid = tile_ids.long()
    if pass_class is None or num_classes == 1:
        start = tile_start[num_classes * tid]
        end = tile_start[num_classes * tid + num_classes]
    else:
        start = tile_start[num_classes * tid + pass_class]
        end = tile_start[num_classes * tid + pass_class + 1]
    return start.long(), (end - start).long()


def _num_classes(tile_start, width, height, n_tiles_global=None) -> int:
    """Draw classes of class-split bins over ``n_tiles_global`` tiles, by
    default the frame's own grid (a row-band frame bins a grid padded to a
    multiple of the band count, reference raster_pallas_gbuf.py:399)."""
    if n_tiles_global is None:
        n_tiles_global = -(-width // TILE_W) * -(-height // TILE_H)
    return (tile_start.shape[0] - 1) // n_tiles_global


def _big_records(payload, big_count) -> tuple:
    """(big-list records [nbig, 64], nbig): the first ``big_count``
    records of ``payload[1]``."""
    nbig = int(big_count)
    return payload[1].reshape(-1, REC_F32)[:nbig], nbig


def _list_rows(start, slot, v, nbig):
    """Row of list position v of ``slot`` in cat([big records, records])."""
    return torch.where(v < nbig, v, start[slot] + v)


def _pixel_xy(tile_ids, width, tile_w=TILE_W, tile_h=TILE_H):
    """(px, py) [K, tile_h, tile_w] float32: the pixel indices of each
    pixel of the listed tiles, as the kernels compute them (kernels 1
    and 6), which the pixel box test reads."""
    dev = tile_ids.device
    tiles_x = -(-width // tile_w)
    tid = tile_ids.long()
    cols = torch.arange(tile_w, dtype=torch.float32, device=dev)
    rows = torch.arange(tile_h, dtype=torch.float32, device=dev)
    tx = (tid % tiles_x).to(torch.float32)[:, None, None]
    ty = (tid // tiles_x).to(torch.float32)[:, None, None]
    shape = (tid.shape[0], tile_h, tile_w)
    return ((tx * tile_w + cols[None, None, :]).expand(shape),
            (ty * tile_h + rows[None, :, None]).expand(shape))


def _pixel_ndc(tile_ids, width, height, tile_w=TILE_W, tile_h=TILE_H):
    """(nx, ny) [K, tile_h, tile_w]: the NDC centre of each pixel of the
    listed tiles, in the kernels' arithmetic order (kernels 1 and 6)."""
    px, py = _pixel_xy(tile_ids, width, tile_w, tile_h)
    return (px + 0.5) * (2.0 / width) - 1.0, (py + 0.5) * (2.0 / height) - 1.0


def gbuf_work_list(count: torch.Tensor, segment: int = SEG):
    """The race's work list in the compact form the kernel's plan builds,
    from the run length of each tile slot [K]: (order [S] int64, the S
    slots with a non-empty run by segment count, most first, counts of
    PLAN_BUCKETS - 1 and more as one; seg_cum [S] int64, the running
    count of segments in that order). Item i is segment i - seg_cum[p-1]
    of slot order[p], for the p with seg_cum[p-1] <= i < seg_cum[p]. The
    kernel orders the slots of one count as its atomics land, here in
    slot order: the merge is a maximum, so the order is free."""
    nseg = (count + segment - 1) // segment
    bucket = torch.clamp(nseg, max=PLAN_BUCKETS - 1)
    order = torch.argsort(bucket, descending=True, stable=True)[: int((nseg > 0).sum())]
    return order, torch.cumsum(nseg[order], 0)


def work_items(start: torch.Tensor, count: torch.Tensor, segment: int = SEG):
    """The work list expanded, in the kernel's order: (slot, begin, end)
    [n_items] int64, one item per segment of at most ``segment`` records
    of a tile slot's run [begin, end)."""
    order, seg_cum = gbuf_work_list(count, segment)
    nseg = (count[order] + segment - 1) // segment
    slot = torch.repeat_interleave(order, nseg)
    first = torch.repeat_interleave(seg_cum - nseg, nseg)
    j = torch.arange(slot.shape[0], device=count.device) - first
    begin = start[slot] + j * segment
    end = torch.minimum(begin + segment, start[slot] + count[slot])
    return slot, begin, end


def _edges(f, nx, ny):
    """Edge functions of the record whose float i is f(i), at (nx, ny)."""
    a0, b0, c0 = f(0), f(1), f(2)
    a1, b1, c1 = f(3), f(4), f(5)
    a2, b2, c2 = f(6), f(7), f(8)
    return a0 * nx + b0 * ny + c0, a1 * nx + b1 * ny + c1, a2 * nx + b2 * ny + c2


def in_box(f, px, py, at: int):
    """Where pixels (px, py) lie in the pixel box held at floats at..at+3
    (x0, y0, x1, y1) of the record whose float i is f(i) (kernels 1 and
    6; the kernels test it only where the edge functions cover)."""
    return (px >= f(at)) & (px <= f(at + 2)) & (py >= f(at + 1)) & (py <= f(at + 3))


def _covers(f, e, p):
    """Coverage of the record whose float i is f(i) at the pixels p = (px,
    py) of its edge functions e: the top-left rule, inside its pixel box."""
    def covered(e, a, b):
        tl = (a > 0) | ((a == 0) & (b > 0))
        return (e > 0) | ((e == 0) & tl)

    inside = covered(e[0], f(0), f(1)) & covered(e[1], f(3), f(4)) & covered(e[2], f(6), f(7))
    return inside & in_box(f, *p, BOX_F32)


def _race_test(f, e, p, pass_class):
    """(inside, depth, encoded tri id) of a record at the pixels p of its
    edge functions e: coverage, w > 0, depth in [0, 1], class."""
    e0, e1, e2 = e
    inside = _covers(f, e, p)
    w_int = e0 * f(12) + e1 * f(13) + e2 * f(14)
    z_int = e0 * f(9) + e1 * f(10) + e2 * f(11)
    depth = z_int / w_int
    inside &= (w_int > 0) & (depth >= 0.0) & (depth <= 1.0)
    tri_enc = f(15).to(torch.int32)
    if pass_class is not None:
        inside &= (tri_enc >> CLASS_SHIFT) == pass_class
    return inside, depth, tri_enc


_ATTR = ("pos_x", "pos_y", "pos_z", "nrm_x", "nrm_y", "nrm_z", "uv_u", "uv_v")
_DX = ("dposdx_x", "dposdx_y", "dposdx_z", None, None, None, "duvdx_u", "duvdx_v")
_DY = ("dposdy_x", "dposdy_y", "dposdy_z", None, None, None, "duvdy_u", "duvdy_v")


def _interpolate(f, e, names, width, height) -> dict:
    """The winner's attribute channels among ``names`` (perspective-correct
    values and closed-form screen derivatives), tri, material and scale."""
    e0, e1, e2 = e
    a0, b0, a1, b1, a2, b2 = f(0), f(1), f(3), f(4), f(6), f(7)
    d_sum = e0 + e1 + e2
    inv_d = 1.0 / d_sum
    a_sum = a0 + a1 + a2
    b_sum = b0 + b1 + b2
    inv_d2x = inv_d * inv_d * (2.0 / width)
    inv_d2y = inv_d * inv_d * (2.0 / height)
    out = {}
    for q in range(8):
        if _ATTR[q] not in names and (_DX[q] or "") not in names:
            continue
        A0, A1, A2 = f(16 + q), f(24 + q), f(32 + q)
        n_attr = e0 * A0 + e1 * A1 + e2 * A2
        if _ATTR[q] in names:
            out[_ATTR[q]] = n_attr * inv_d
        if _DX[q] is not None and _DX[q] in names:
            na = a0 * A0 + a1 * A1 + a2 * A2
            nb = b0 * A0 + b1 * A1 + b2 * A2
            out[_DX[q]] = (na * d_sum - n_attr * a_sum) * inv_d2x
            out[_DY[q]] = (nb * d_sum - n_attr * b_sum) * inv_d2y
    tri_enc = f(15).to(torch.int32)
    out["tri"] = torch.where(tri_enc < 0, tri_enc, tri_enc & (CLASS_BIT - 1))
    out["material"] = f(40).to(torch.int32)
    out["scale"] = f(41)
    return out


def rasterize_gbuffer_tiles_plain(
    payload: tuple,
    tile_ids: torch.Tensor,
    tile_start: torch.Tensor,
    big_count,
    width: int,
    height: int,
    init_depth_tiles: torch.Tensor | None = None,
    max_depth_tiles: torch.Tensor | None = None,
    pass_class: int | None = None,
    pos_derivs: bool = True,
    uv_channels: bool = True,
    segment: int | None = None,
    n_tiles_global: int | None = None,
) -> dict:
    """The G-buffer raster in plain PyTorch, in the kernel's arithmetic
    order. With ``segment`` None the depth race walks the big list, record
    by record over every tile, then the runs record rank by record rank,
    vectorised over every tile whose run is that long, and interpolates at
    every win; with ``segment`` set it races each segment of at most that
    many records of a tile's list on its own, merges the segment winners
    by their (depth, -position) key and interpolates each pixel's winner
    once, as the kernel does. Both give the same channels bit for bit."""
    recs = payload[0].reshape(-1, REC_F32)
    big, nbig = _big_records(payload, big_count)
    dev = recs.device
    k_tiles = tile_ids.shape[0]
    start, count = _tile_runs(tile_start, tile_ids,
                              _num_classes(tile_start, width, height, n_tiles_global),
                              pass_class)
    nx, ny = _pixel_ndc(tile_ids, width, height)
    px, py = _pixel_xy(tile_ids, width)
    shape = (k_tiles, TILE_H, TILE_W)

    names = active_channels(pos_derivs, uv_channels)
    ch = {
        n: torch.zeros(shape, dtype=torch.int32 if n in INT_CHANNELS
                       else torch.float32, device=dev)
        for n in names
    }
    ch["tri"].fill_(-1)
    ch["nrm_z"].fill_(1.0)
    ch["scale"].fill_(1.0)
    if init_depth_tiles is not None:
        ch["depth"].copy_(init_depth_tiles)
    if segment is not None:
        lrecs = torch.cat([big, recs]) if nbig else recs
        key = _race_segments(lrecs, nbig, (nx, ny, px, py), start, count, ch["depth"],
                             max_depth_tiles, pass_class, segment)
        won = key != 0
        k = torch.arange(k_tiles, device=dev)[:, None, None].expand(shape)
        pos = KEY_INDEX_MASK - (key & KEY_INDEX_MASK)
        rw = lrecs[torch.where(won, _list_rows(start, k, pos, nbig), 0)]
        f = lambda i: rw[..., i]  # noqa: E731
        e = _edges(f, nx, ny)
        vals = _interpolate(f, e, names, width, height)
        vals["depth"] = _race_test(f, e, (px, py), None)[1]
        return {n: torch.where(won, vals[n], ch[n]) for n in names}

    def race(r, act):
        """Race one record per listed tile of ``act`` (r [A or 1, 64])."""
        f = lambda i: r[:, i][:, None, None]  # noqa: E731
        e = _edges(f, nx[act], ny[act])
        inside, depth, _ = _race_test(f, e, (px[act], py[act]), pass_class)
        win = inside & (depth > ch["depth"][act])
        if max_depth_tiles is not None:
            win &= depth < max_depth_tiles[act]
        vals = _interpolate(f, e, names, width, height)
        vals["depth"] = depth  # stored last: the win mask read the old depth
        for name, val in vals.items():
            ch[name][act] = torch.where(win, val, ch[name][act])

    for j in range(nbig):
        race(big[j : j + 1], slice(None))
    for j in range(int(count.max()) if k_tiles else 0):
        act = torch.nonzero(count > j)[:, 0]
        race(recs[start[act] + j], act)
    return ch


def _race_segments(lrecs, nbig, pixels, start, count, seed, max_depth, pass_class,
                   segment):
    """Each work item's depth race from the seed over its segment of the
    slot's list (the big list at positions [0, nbig) of ``lrecs``, then the
    run; ``pixels`` = (nx, ny, px, py) of every slot's pixels), merged per
    pixel of each tile slot into the key (float bits of
    depth + 0 << 32) | (2^32 - 1 - list position) [K, 8, 128] int64; 0
    where no record won. The + 0 turns -0 into +0, so that the key orders
    as the depth does."""
    slot, begin, end = work_items(torch.zeros_like(count), nbig + count, segment)
    best = seed[slot].clone()
    best_i = torch.full(best.shape, -1, dtype=torch.int64, device=lrecs.device)
    n_max = int((end - begin).max()) if slot.numel() else 0
    for j in range(n_max):
        act = torch.nonzero(end - begin > j)[:, 0]
        v = begin[act] + j
        r = lrecs[_list_rows(start, slot[act], v, nbig)]
        f = lambda i: r[:, i][:, None, None]  # noqa: E731
        nx, ny, px, py = (a[slot[act]] for a in pixels)
        inside, depth, _ = _race_test(f, _edges(f, nx, ny), (px, py), pass_class)
        win = inside & (depth > best[act])
        if max_depth is not None:
            win &= depth < max_depth[slot[act]]
        best[act] = torch.where(win, depth, best[act])
        best_i[act] = torch.where(win, v[:, None, None], best_i[act])
    bits = (best + 0.0).view(torch.int32).to(torch.int64)
    key = torch.where(best_i >= 0, (bits << 32) | (KEY_INDEX_MASK - best_i), 0)
    merged = torch.zeros_like(seed, dtype=torch.int64)
    return merged.scatter_reduce_(0, slot[:, None, None].expand_as(key), key, "amax")


def covered_pairs(payload, tile_ids, tile_start, width, height, pass_class=None,
                  big_count=0, chunk: int = 4096, n_tiles_global=None) -> int:
    """The (pixel, record) pairs of one call whose record covers the pixel
    (top-left rule inside its pixel box, records of ``pass_class``; each
    tile's list, the big list then its run): where the race goes on from
    the edge functions to the depth, the rest of its work per pair."""
    recs = payload[0].reshape(-1, REC_F32)
    big, nbig = _big_records(payload, big_count)
    lrecs = torch.cat([big, recs]) if nbig else recs
    start, count = _tile_runs(tile_start, tile_ids,
                              _num_classes(tile_start, width, height, n_tiles_global),
                              pass_class)
    # one item per (tile slot, list position)
    slot, v, _ = work_items(torch.zeros_like(count), nbig + count, 1)
    nx, ny = _pixel_ndc(tile_ids, width, height)
    px, py = _pixel_xy(tile_ids, width)
    total = 0
    for s in range(0, slot.shape[0], chunk):
        sl = slot[s : s + chunk]
        r = lrecs[_list_rows(start, sl, v[s : s + chunk], nbig)]
        f = lambda i: r[:, i][:, None, None]  # noqa: E731
        inside = _covers(f, _edges(f, nx[sl], ny[sl]), (px[sl], py[sl]))
        if pass_class is not None:
            inside &= (f(15).to(torch.int32) >> CLASS_SHIFT) == pass_class
        total += int(inside.sum())
    return total


def _rasterize_cuda(*args, **kwargs) -> dict:
    return _raster_launch(*args, **kwargs)[0]


def _raster_launch(payload, tile_ids, tile_start, big_count, width, height,
                   init_depth_tiles=None, max_depth_tiles=None,
                   pass_class=None, pos_derivs=True, uv_channels=True, n_tiles_global=None):
    """Launch kernel 1 -> (channels, the int64 buffer it worked in: the
    per-pixel keys, then the plan, whose words the CUDA tests read). A
    ``big_count`` tensor stays on the card, where the kernel reads it (no
    host sync)."""
    rows, big_rows = payload
    dev = rows.device
    k_tiles = tile_ids.shape[0]
    tiles_x = -(-width // TILE_W)
    nc = _num_classes(tile_start, width, height, n_tiles_global)
    kernels.check(rows, "payload rows", torch.float32, (rows.shape[0], 128), align=16)
    kernels.check(tile_start, "tile_start", torch.int32, device=dev)
    kernels.check(tile_ids, "tile_ids", torch.int32, (k_tiles,), device=dev)
    if isinstance(big_count, torch.Tensor):
        big_count = big_count.to(device=dev, dtype=torch.int32).reshape(1)
    elif big_count:
        big_count = torch.tensor([big_count], dtype=torch.int32, device=dev)
    else:
        big_count = big_rows = None
    if big_count is not None:
        kernels.check(big_rows, "big rows", torch.float32, (big_rows.shape[0], 128),
                      device=dev, align=16)
    if init_depth_tiles is None:
        init_depth_tiles = torch.zeros((k_tiles, TILE_H, TILE_W), device=dev)
    kernels.check(init_depth_tiles, "init_depth_tiles", torch.float32,
                  (k_tiles, TILE_H, TILE_W), device=dev)
    if max_depth_tiles is not None:
        kernels.check(max_depth_tiles, "max_depth_tiles", torch.float32,
                      (k_tiles, TILE_H, TILE_W), device=dev)
    names = active_channels(pos_derivs, uv_channels)
    fnames = [n for n in names if n not in INT_CHANNELS]
    shape = (k_tiles, TILE_H, TILE_W)
    tri = torch.empty(shape, dtype=torch.int32, device=dev)
    mat = torch.empty(shape, dtype=torch.int32, device=dev)
    fout = torch.empty((len(fnames),) + shape, dtype=torch.float32, device=dev)
    # the merge key of every pixel (0: no winner), then the race's work
    # list, which the kernel builds (2 + 2K int32 in K + 1 more words)
    keys = torch.zeros(k_tiles * (TILE_H * TILE_W + 1) + 1, dtype=torch.int64, device=dev)
    fn = kernels.entry("trt_raster_gbuf", [
        kernels.VOIDP, kernels.VOIDP, kernels.VOIDP, kernels.VOIDP, kernels.VOIDP,
        kernels.VOIDP, kernels.VOIDP, kernels.INT, kernels.INT, kernels.INT, kernels.INT,
        kernels.INT, kernels.FLOAT, kernels.FLOAT, kernels.INT, kernels.INT, kernels.VOIDP,
        kernels.VOIDP, kernels.VOIDP, kernels.VOIDP,
    ])
    kernels.launch(
        KERNEL, fn, kernels.ptr(rows), kernels.ptr(big_rows), kernels.ptr(big_count),
        kernels.ptr(tile_start), kernels.ptr(tile_ids), kernels.ptr(init_depth_tiles),
        kernels.ptr(max_depth_tiles), k_tiles, tiles_x, nc,
        -1 if pass_class is None else int(pass_class), SEG,
        2.0 / width, 2.0 / height, int(pos_derivs), int(uv_channels),
        kernels.ptr(keys), kernels.ptr(tri), kernels.ptr(mat), kernels.ptr(fout),
    )
    out = {"tri": tri, "material": mat}
    out.update({n: fout[i] for i, n in enumerate(fnames)})
    return {n: out[n] for n in names}, keys


KERNEL = kernels.KernelHandle(
    "raster_gbuf", "transmission_renderer_tpu_torch/csrc/raster_gbuf.cu",
    "transmission_renderer_tpu/ops/raster_pallas_gbuf.py:178",
    cuda=_rasterize_cuda, plain=rasterize_gbuffer_tiles_plain,
)


def rasterize_gbuffer_tiles(
    payload: tuple,  # (payload_rows, big_rows) from gather_gbuf_payload
    tile_ids: torch.Tensor,  # [K] int32 global tile ids
    tile_start: torch.Tensor,  # [num_classes * n_tiles_global + 1] int32
    big_count,  # records of big_rows every tile walks first (int or [1] tensor)
    width: int,
    height: int,
    init_depth_tiles: torch.Tensor | None = None,  # [K, 8, 128]
    max_depth_tiles: torch.Tensor | None = None,  # [K, 8, 128] peel bound
    pass_class: int | None = None,
    pos_derivs: bool = True,
    uv_channels: bool = True,
    n_tiles_global: int | None = None,  # tiles of the binned grid (default the frame's)
) -> dict:
    """Rasterise a tile list -> {channel: [K, 8, 128]} for the active
    channels (kernel 1; plain version for CPU tensors). A row band's
    tiles index bins over a grid padded below the frame: pass that grid's
    tile count as ``n_tiles_global`` (tiles past the frame's bottom hold
    no records and race nothing)."""
    if n_tiles_global is None:
        n_tiles_global = -(-width // TILE_W) * -(-height // TILE_H)
    return KERNEL(
        payload[0].is_cuda, payload, tile_ids, tile_start, big_count, width, height,
        init_depth_tiles=init_depth_tiles, max_depth_tiles=max_depth_tiles,
        pass_class=pass_class, pos_derivs=pos_derivs, uv_channels=uv_channels,
        n_tiles_global=n_tiles_global,
    )


def gbuffer_from_channels(ch: dict) -> GBuffer:
    """Assemble a GBuffer from channel images; absent dpos/uv channels
    read as zeros (the kernel's cleared value)."""
    zero = torch.zeros_like(ch["depth"])
    valid = ch["tri"] >= 0
    vmask = valid[..., None]

    def get(name):
        return ch.get(name, zero)

    def stack(*names):
        return torch.stack([get(n) for n in names], dim=-1)

    normal_bg = torch.tensor([0.0, 0.0, 1.0], device=zero.device)
    return GBuffer(
        valid=valid,
        depth=ch["depth"],
        position=torch.where(vmask, stack("pos_x", "pos_y", "pos_z"), 0.0),
        normal=torch.where(vmask, stack("nrm_x", "nrm_y", "nrm_z"), normal_bg),
        uv=torch.where(vmask, stack("uv_u", "uv_v"), 0.0),
        duv_dx=torch.where(vmask, stack("duvdx_u", "duvdx_v"), 0.0),
        duv_dy=torch.where(vmask, stack("duvdy_u", "duvdy_v"), 0.0),
        dpos_dx=torch.where(vmask, stack("dposdx_x", "dposdx_y", "dposdx_z"), 0.0),
        dpos_dy=torch.where(vmask, stack("dposdy_x", "dposdy_y", "dposdy_z"), 0.0),
        material_id=torch.where(valid, ch["material"], 0),
        model_scale=torch.where(valid, ch["scale"], 1.0),
        tri_id=ch["tri"],
    )


def rasterize_gbuffer_pallas(
    records: torch.Tensor,
    bins: TileBins,
    width: int,
    height: int,
    init_depth: torch.Tensor | None = None,
    pass_class: int | None = None,
    payload=None,
    pos_derivs: bool = True,
    uv_channels: bool = True,
) -> GBuffer:
    """Full-frame G-buffer raster -> GBuffer [H, W] (every tile)."""
    tiles_x = -(-width // TILE_W)
    tiles_y = -(-height // TILE_H)
    n_tiles = tiles_x * tiles_y
    tile_ids = torch.arange(n_tiles, dtype=torch.int32, device=records.device)
    payload = payload if payload is not None else gather_gbuf_payload(records, bins)
    init_tiles = (
        tile_image(init_depth, TILE_W, TILE_H).contiguous()
        if init_depth is not None else None
    )
    # a length-1 big list means big triangles ride the sorted stream
    n_big = bins.big_tri_ids.shape[0]
    big_count = (0 if n_big <= 1 else
                 torch.clamp(bins.big_tri_count, max=n_big).to(torch.int32).reshape(1))
    raw = rasterize_gbuffer_tiles(
        payload, tile_ids, bins.tile_start, big_count, width, height,
        init_depth_tiles=init_tiles, pass_class=pass_class,
        pos_derivs=pos_derivs, uv_channels=uv_channels,
    )
    return gbuffer_from_channels({
        n: untile_image(a, tiles_x, tiles_y, TILE_W, TILE_H, width, height)
        for n, a in raw.items()
    })
