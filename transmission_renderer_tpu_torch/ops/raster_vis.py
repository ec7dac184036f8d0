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

In XLA-raster order the raster can also take the reference's alpha test
(``alpha_coverage_fn``, raster.py:556-561, built by
render/frame.py::_make_alpha_fn): a ``VisAlpha`` of tensors, so that the
kernel reads the same data. A covered fragment in the depth range is then
dropped where ``alpha_keep`` says its diffuse alpha is below the cutoff.
The kill does not depend on the walk order, so both the kernel and the
plain version tap only the fragments that would beat their current best,
which gives the same winners. The kernel-6 order (the reference's Pallas
kernel) has no alpha test.

In both orders the winner is a maximum over the records strictly deeper
than the seed: of (depth, -list position) in kernel-6 order, whose list
is the big list then the run, and of (depth, -triangle id) in XLA order.
So a tile's list can be cut into segments of at most ``SEG`` records,
each raced on its own, and the segment winners merged by the 64-bit key
(float bits of depth + 0 << 32) | (2^32 - 1 - id), whose unsigned
maximum is that winner; one resolve per pixel then recomputes the
winner's depth and barycentrics. The kernel does so (a plan of the work
list ``raster_gbuf.gbuf_work_list`` describes, over ``list_lengths``; a
race; a resolve: one call of the handle), and
``raster_vis_plain(segment=...)`` does it in plain PyTorch.

Both reference functions run compiled on the CPU, where the compiler
contracts multiply-adds: an edge function is fma(a, nx, b * ny) + c and
the clip w and z sums are fma(e2, v2, fma(e0, v0, e1 * v1)). The port
computes exactly these (the kernel with fmaf, the plain version through
float64), which reproduces the reference's depths and barycentrics bit
for bit, and with them its coverage and depth-race decisions.

Record layout [N, 20] float32: signed adjugate rows (9), clip z (3),
clip w (3), tri id + CLASS_BIT * class as a float value (1), then the
pixel box (x0, y0, x1, y1: inclusive pixel indices,
ops/raster.py::setup_triangles) (4). A record covers a pixel where its
edge functions pass the top-left rule and the pixel lies in its box; the
reference's 16-float record has no box, and covers a sliver's pixels
past it where float32 edge functions read "inside". The TPU kernel
packed 8 records per 128-lane row for its DMA; here a record is a row of
its own.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

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
from transmission_renderer_tpu_torch.ops.raster_gbuf import (
    _pixel_ndc,
    _pixel_xy,
    in_box,
    work_items,
)
from transmission_renderer_tpu_torch.ops.texture import (
    WRAP_REPEAT,
    atlas_classes,
    class_mask,
    sample_texture_rows,
)
from transmission_renderer_tpu_torch.render import checks
from transmission_renderer_tpu_torch.render.shading import _mip_lod
from transmission_renderer_tpu_torch.scene.textures import IMAGE_MASK, LAYER_SHIFT, META_COLS

TILE_H = 8
TILE_W = 128
REC_F32 = 20
BOX_F32 = 16  # the pixel box's first float: one aligned float4
CLASS_SHIFT = 22
CLASS_BIT = 1 << CLASS_SHIFT
MAX_TILE_PX = 1024  # the kernel's race tests 4 pixels a thread, 256 threads a block
# records per work item of the kernel's race: a tile's list longer than
# this is raced by several blocks at once (on the 1080p vis frame an H100
# took 0.282, 0.296 and 0.337 ms at 32, 64 and 128: PERF.md, Findings)
SEG = 32
KEY_ID_MASK = 0xFFFFFFFF
# the indices the checked form tests, by bit of its error word (the plain
# version reports its own through render/checks.py::index at the same sites)
CHECK_SITES = {
    0: "kernel 6 (ops/raster_vis.py): a run's record row past the records",
    1: "kernel 6 (ops/raster_vis.py): a big-list record row past the big list",
    2: "kernel 6 (ops/raster_vis.py): a seed depth past the seed tiles",
    3: "kernel 6 (ops/raster_vis.py): a triangle id past the triangles",
    4: "kernel 6 (ops/raster_vis.py): a material id past the materials",
    5: "kernel 6 (ops/raster_vis.py): a diffuse texture's atlas image past the atlas meta",
    6: "kernel 6 (ops/raster_vis.py): an alpha tap's texel past the atlas",
}


class VisAlpha(NamedTuple):
    """What the raster's alpha test reads (render/frame.py::vis_alpha
    builds it): per triangle a side table (the record stays as it is), per
    material its diffuse texture and factors, and the atlas."""

    tri_clip: torch.Tensor  # [T] int32, 1: bucket ALPHA_CLIP or TRANSMISSION_ALPHA_CLIP
    tri_material: torch.Tensor  # [T] int32
    tri_uv: torch.Tensor  # [T, 6] float32, the three expanded vertex uvs
    tex_diffuse: torch.Tensor  # [M] int32 packed refs, -1: none
    alpha_factor: torch.Tensor  # [M] float32 diffuse_factor[:, 3]
    cutoff: torch.Tensor  # [M] float32 alpha_clipping_cutoff
    atlas_texels: torch.Tensor  # [R, row_elems] bfloat16
    atlas_meta: torch.Tensor  # [images, META_COLS + class tag] int32


def alpha_tap(alpha: VisAlpha, f, e, width: int, height: int) -> tuple:
    """Where the alpha test taps the atlas for the fragments whose record
    float i is f(i) ([N] each) at the pixels of their edge functions e ->
    (triangle id, material id, diffuse ref, meta rows [N, META_COLS], uv
    [N, 2], lod): the uv, e . uv / sum(e), and its analytic derivatives
    with the 2/width and 2/height factors (render/frame.py::_make_alpha_fn),
    and the implicit LOD (render/shading.py::_mip_lod). Every operation
    rounds on its own, as in the kernel (built with --fmad=false); the
    edge functions are the raster's own."""
    tri = checks.index((f(15).to(torch.int32) & (CLASS_BIT - 1)).long(),
                       alpha.tri_clip.shape[0], CHECK_SITES[3])
    mid = checks.index(alpha.tri_material[tri].long(), alpha.tex_diffuse.shape[0],
                       CHECK_SITES[4])
    tid = alpha.tex_diffuse[mid]
    img = checks.index((torch.clamp(tid, min=0) & IMAGE_MASK).long(),
                       alpha.atlas_meta.shape[0], CHECK_SITES[5], used=tid >= 0)
    rows = alpha.atlas_meta[img][..., :META_COLS]
    t = alpha.tri_uv[tri]
    e0, e1, e2 = e
    a0, b0, a1, b1, a2, b2 = f(0), f(1), f(3), f(4), f(6), f(7)
    d_sum = e0 + e1 + e2
    inv_d = 1.0 / d_sum
    a_sum = a0 + a1 + a2
    b_sum = b0 + b1 + b2
    inv_d2x = inv_d * inv_d * (2.0 / width)
    inv_d2y = inv_d * inv_d * (2.0 / height)
    uv, dx, dy = [], [], []
    for c in (0, 1):
        u0, u1, u2 = t[:, c], t[:, 2 + c], t[:, 4 + c]
        n = e0 * u0 + e1 * u1 + e2 * u2
        na = a0 * u0 + a1 * u1 + a2 * u2
        nb = b0 * u0 + b1 * u1 + b2 * u2
        uv.append(n * inv_d)
        dx.append((na * d_sum - n * a_sum) * inv_d2x)
        dy.append((nb * d_sum - n * b_sum) * inv_d2y)
    lod = _mip_lod(torch.stack(dx, -1), torch.stack(dy, -1), rows[..., 2], rows[..., 3])
    return tri, mid, tid, rows, torch.stack(uv, -1), lod


def alpha_test(alpha: VisAlpha, f, e, width: int, height: int) -> tuple:
    """The reference's alpha test (render/frame.py::_make_alpha_fn) of the
    fragments of ``alpha_tap`` -> (whether the triangle is in a clip
    bucket, the alpha, the material's cutoff), each [N]: the trilinear
    REPEAT tap of the diffuse alpha at alpha_tap's uv and lod, times the
    factor (the factor alone without a texture)."""
    tri, mid, tid, rows, uv, lod = alpha_tap(alpha, f, e, width, height)
    classes = atlas_classes(alpha.atlas_meta)
    layer = (torch.clamp(tid, min=0) >> LAYER_SHIFT) if max(classes) > 1 else None
    s = sample_texture_rows(alpha.atlas_texels, rows, uv, lod, WRAP_REPEAT, classes, layer=layer)
    value = alpha.alpha_factor[mid] * torch.where(tid >= 0, s[..., 3], 1.0)
    return alpha.tri_clip[tri] != 0, value, alpha.cutoff[mid]


def alpha_keep(alpha: VisAlpha, f, e, width: int, height: int) -> torch.Tensor:
    """[N] bool, True where a fragment stays: alpha_test's alpha reaches
    the cutoff, or the triangle is not in a clip bucket."""
    clip, value, cutoff = alpha_test(alpha, f, e, width, height)
    return ~clip | (value >= cutoff)


def _alpha_gate(alpha: VisAlpha, win: torch.Tensor, rec: torch.Tensor, e, width: int,
                height: int) -> torch.Tensor:
    """``win`` ([A, th, tw]: the fragments of records rec [A or 1, 20] that
    would beat the current best) with the alpha test's kills removed; only
    those fragments are tapped."""
    at = torch.nonzero(win, as_tuple=True)
    if at[0].numel() == 0:
        return win
    r = rec[at[0]] if rec.shape[0] > 1 else rec.expand(at[0].numel(), -1)
    keep = alpha_keep(alpha, lambda i: r[:, i], [x.expand(win.shape)[at] for x in e],
                      width, height)
    win = win.clone()
    win[at] = keep
    return win


def pack_payload(setup: TriangleSetup, class_flags: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """[T, 20] float32 records; ``class_flags`` ([T], 1 = transmissive)
    selects each record's draw class."""
    t = setup.adj.shape[0]
    if t > CLASS_BIT:
        raise ValueError(f"{t} records exceed the 2^22 tri-id field")
    ids = torch.arange(t, dtype=torch.int32, device=setup.adj.device)
    if class_flags is not None:
        ids = ids + CLASS_BIT * class_flags.to(torch.int32)
    return torch.cat([setup.adj.reshape(t, 9), setup.z_clip, setup.w_clip,
                      ids.to(torch.float32)[:, None], setup.pixel_box], dim=1)


def gather_bin_payload(setup: TriangleSetup, bins: TileBins,
                       class_flags: torch.Tensor | None = None):
    """(records in sorted-pair order [S, 20], big-list records [B, 20],
    the records by triangle id [T + 1, 20]); -1 entries read the last row,
    a degenerate record (all-zero edges never cover). A triangle's record
    is the same row wherever it is gathered: the kernel's resolve reads
    the XLA-order winner by its id in the third tensor."""
    payload = pack_payload(setup, class_flags)
    t = payload.shape[0]
    degenerate = payload.new_zeros((1, REC_F32))
    degenerate[0, 15] = -1.0
    ext = torch.cat([payload, degenerate])

    def rows(ids):
        return ext[torch.where(ids >= 0, ids, t).long()].contiguous()

    return rows(bins.sorted_tri_ids), rows(bins.big_tri_ids), ext


def _covered(e, a, b):
    """Top-left fill rule: e > 0, or e == 0 on a top or left edge."""
    tl = (a > 0) | ((a == 0) & (b > 0))
    return (e > 0) | ((e == 0) & tl)


def _edges(f, nx, ny):
    """Edge functions of the record whose float i is f(i), contracted as
    the reference's compiler does."""
    return (_fma(f(0), nx, f(1) * ny) + f(2), _fma(f(3), nx, f(4) * ny) + f(5),
            _fma(f(6), nx, f(7) * ny) + f(8))


def _covers(f, e, p, pass_class):
    """Where the record whose float i is f(i) covers the pixels p = (px,
    py) of its edge functions e (top-left rule, inside its pixel box), if
    it is of ``pass_class`` and not padding (tri id < 0)."""
    inside = _covered(e[0], f(0), f(1)) & _covered(e[1], f(3), f(4)) & _covered(e[2], f(6), f(7))
    inside &= in_box(f, *p, BOX_F32)
    tri_enc = f(15).to(torch.int32)
    inside &= tri_enc >= 0
    if pass_class is not None:
        inside &= (((tri_enc >> CLASS_SHIFT) & 1) == 1) == (pass_class == 1)
    return inside


def _depth(f, e):
    """(clip w sum, depth) of a record at the pixels of its edge functions."""
    e0, e1, e2 = e
    w_int = _fma(e2, f(14), _fma(e0, f(12), e1 * f(13)))
    z_int = _fma(e2, f(11), _fma(e0, f(9), e1 * f(10)))
    return w_int, z_int / w_int


def _race_test(f, e, p, pass_class):
    """(inside, depth, tri id) of a record at the pixels p of its edge
    functions e: coverage, class, w > 0 and depth in [0, 1]."""
    inside = _covers(f, e, p, pass_class)
    w_int, depth = _depth(f, e)
    inside &= (w_int > 0) & (depth >= 0.0) & (depth <= 1.0)
    return inside, depth, f(15).to(torch.int32) & (CLASS_BIT - 1)


def _barycentrics(e, xla_order):
    """(b1, b2) of the winner, by the order's own formula."""
    e0, e1, e2 = e
    esum = e0 + e1 + e2
    if xla_order:
        return e1 / esum, e2 / esum
    inv = 1.0 / esum
    return e1 * inv, e2 * inv


def list_lengths(run_count: torch.Tensor, big_count: torch.Tensor) -> torch.Tensor:
    """[K] int64: the records each tile slot walks, its list: the big list
    at positions [0, nbig), then its run (kernel 6's work list cuts these
    into SEG-record segments, raster_gbuf.gbuf_work_list)."""
    return big_count.long()[0] + run_count.long()


def _list_rows(run_start, slot, v, nbig, n_big_rows, n_records, used=None):
    """Row of list position v of ``slot`` in cat([big, records]) (big:
    [n_big_rows, 20], of which the list walks nbig), each checked against
    its array (render/checks.py::index) where ``used``."""
    is_big = v < nbig
    is_run = ~is_big
    if used is not None:
        is_big, is_run = is_big & used, is_run & used
    big_row = checks.index(v, n_big_rows, CHECK_SITES[1], used=is_big)
    run_row = checks.index(run_start.long()[slot] + v - nbig, n_records, CHECK_SITES[0],
                           used=is_run)
    return torch.where(v < nbig, big_row, n_big_rows + run_row)


def raster_vis_plain(
    payload: tuple,  # (records [S, 20], big [B, 20], rows [T + 1, 20])
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
    segment: int | None = None,
    alpha: VisAlpha | None = None,
) -> tuple:
    """The visibility raster in plain PyTorch -> (tri [K, th, tw] int32,
    depth, b1, b2); each record's arithmetic is the kernel's (see the
    module docstring). With ``segment`` None tiles race in parallel, one
    record rank per step, in the order's walk; with ``segment`` set each
    segment of at most that many records of a tile's list is raced on its
    own, the winners merge by their key and each pixel's winner is
    resolved once, as the kernel does. Both give the same bits. ``alpha``
    (XLA order only) adds the alpha test."""
    if alpha is not None and not xla_order:
        raise ValueError("the alpha test is the XLA-raster order's (kernel-6 order has none)")
    records, big = payload[0], payload[1]
    dev = records.device
    k_tiles = tile_ids.shape[0]
    shape = (k_tiles, tile_h, tile_w)
    nx, ny = _pixel_ndc(tile_ids, width, height, tile_w, tile_h)
    px, py = _pixel_xy(tile_ids, width, tile_w, tile_h)
    seed = (init_depth_tiles.clone() if init_depth_tiles is not None
            else torch.zeros(shape, dtype=torch.float32, device=dev))
    if segment is not None:
        return _segmented(payload, tile_ids, run_start, run_count, big_count,
                          (nx, ny, px, py), seed, pass_class, xla_order, segment, alpha,
                          width, height)

    best_tri = torch.full(shape, -1, dtype=torch.int32, device=dev)
    best_depth = seed
    best_b1 = torch.zeros(shape, dtype=torch.float32, device=dev)
    best_b2 = torch.zeros(shape, dtype=torch.float32, device=dev)

    def race(rec, act):
        """Race one record per active tile (rec [A or 1, 20])."""
        f = lambda i: rec[:, i][:, None, None]  # noqa: E731
        e = _edges(f, nx[act], ny[act])
        inside, depth, tri = _race_test(f, e, (px[act], py[act]), pass_class)
        bd, bt = best_depth[act], best_tri[act]
        if xla_order:
            win = inside & ((depth > bd) | ((depth == bd) & (tri < bt)))
        else:
            win = inside & (depth > bd)
        if alpha is not None:
            win = _alpha_gate(alpha, win, rec, e, width, height)
        nb1, nb2 = _barycentrics(e, xla_order)
        best_tri[act] = torch.where(win, tri, bt)
        best_b1[act] = torch.where(win, nb1, best_b1[act])
        best_b2[act] = torch.where(win, nb2, best_b2[act])
        best_depth[act] = torch.where(win, depth, bd)

    everyone = slice(None)

    def walk_runs():
        start = run_start.long()
        for j in range(int(run_count.max()) if k_tiles else 0):
            act = torch.nonzero(run_count > j)[:, 0]
            race(records[checks.index(start[act] + j, records.shape[0], CHECK_SITES[0])], act)

    def walk_big():
        rows = big[checks.index(torch.arange(int(big_count[0]), device=dev), big.shape[0],
                                CHECK_SITES[1])]
        for j in range(rows.shape[0]):
            race(rows[j : j + 1], everyone)

    if xla_order:
        walk_runs()
        walk_big()
    else:
        walk_big()
        walk_runs()
    return best_tri, best_depth, best_b1, best_b2


def _segmented(payload, tile_ids, run_start, run_count, big_count, pixels, seed, pass_class,
               xla_order, segment, alpha=None, width=0, height=0) -> tuple:
    """raster_vis_plain's segmented race (``pixels`` = (nx, ny, px, py) of
    every slot's pixels): each work item (a tile slot's
    list segment) raced from the seed by the order's rule, the winners
    merged per pixel by the key (float bits of depth + 0 << 32) | (2^32 -
    1 - id) (id: the list position in kernel-6 order, the triangle id in
    XLA order; 0: no winner; + 0 folds -0 into +0), then one resolve per
    pixel."""
    records, big, rows = payload
    dev = records.device
    nx, ny, px, py = pixels
    nbig = int(big_count[0])
    recs = torch.cat([big, records])  # row nb + r: records[r]
    nb = big.shape[0]
    lengths = list_lengths(run_count, big_count)
    slot, begin, end = work_items(torch.zeros_like(lengths), lengths, segment)
    best = seed[slot].clone()
    best_id = torch.full(best.shape, -1, dtype=torch.int64, device=dev)
    for j in range(int((end - begin).max()) if slot.numel() else 0):
        act = torch.nonzero(end - begin > j)[:, 0]
        v = begin[act] + j
        r = recs[_list_rows(run_start, slot[act], v, nbig, nb, records.shape[0])]
        f = lambda i: r[:, i][:, None, None]  # noqa: E731
        e = _edges(f, nx[slot[act]], ny[slot[act]])
        inside, depth, tri = _race_test(f, e, (px[slot[act]], py[slot[act]]), pass_class)
        idv = tri.long() if xla_order else v[:, None, None]
        bd, bi = best[act], best_id[act]
        win = inside & (depth > bd)
        if xla_order:
            win |= inside & (depth == bd) & (idv < bi)
        if alpha is not None:
            win = _alpha_gate(alpha, win, r, e, width, height)
        best[act] = torch.where(win, depth, bd)
        best_id[act] = torch.where(win, idv, bi)
    bits = (best + 0.0).view(torch.int32).to(torch.int64)
    key = torch.where(best_id >= 0, (bits << 32) | (KEY_ID_MASK - best_id), 0)
    merged = torch.zeros(seed.shape, dtype=torch.int64, device=dev).scatter_reduce_(
        0, slot[:, None, None].expand_as(key), key, "amax")

    # the resolve: each pixel's winner once
    won = merged != 0
    wid = torch.where(won, KEY_ID_MASK - (merged & KEY_ID_MASK), 0)
    if xla_order:
        rw = rows[wid]
    else:
        k = torch.arange(seed.shape[0], device=dev)[:, None, None].expand_as(wid)
        rw = torch.cat([recs, rows[-1:]])[  # no winner: the degenerate row
            torch.where(won, _list_rows(run_start, k, wid, nbig, nb, records.shape[0], won),
                        recs.shape[0])]
    f = lambda i: rw[..., i]  # noqa: E731
    e = _edges(f, nx, ny)
    b1, b2 = _barycentrics(e, xla_order)
    tri = f(15).to(torch.int32) & (CLASS_BIT - 1)
    return (torch.where(won, tri, -1), torch.where(won, _depth(f, e)[1], seed),
            torch.where(won, b1, 0.0), torch.where(won, b2, 0.0))


def covered_pairs(payload, tile_ids, run_start, run_count, big_count, width, height,
                  tile_w, tile_h, pass_class=None, chunk: int = 4096) -> int:
    """The (pixel, record) pairs of one call whose record covers the pixel
    (top-left rule inside its pixel box, records of ``pass_class``, not
    padding), over each tile's run and the big list: where the race goes on from the edge
    functions to the depth, the rest of its work per pair."""
    records, big = payload[0], payload[1]
    nbig = int(big_count[0])
    recs = torch.cat([big, records])
    slot, v, _ = work_items(torch.zeros_like(run_count.long()),
                            list_lengths(run_count, big_count), 1)
    nx, ny = _pixel_ndc(tile_ids, width, height, tile_w, tile_h)
    px, py = _pixel_xy(tile_ids, width, tile_w, tile_h)
    total = 0
    for s in range(0, slot.shape[0], chunk):
        sl = slot[s : s + chunk]
        r = recs[_list_rows(run_start, sl, v[s : s + chunk], nbig, big.shape[0],
                            records.shape[0])]
        f = lambda i: r[:, i][:, None, None]  # noqa: E731
        total += int(_covers(f, _edges(f, nx[sl], ny[sl]), (px[sl], py[sl]), pass_class).sum())
    return total


def _raster_vis_cuda(payload, tile_ids, run_start, run_count, big_count, width, height,
                     tile_w, tile_h, init_depth_tiles=None, pass_class=None,
                     xla_order=True, alpha=None) -> tuple:
    return _raster_vis_launch(payload, tile_ids, run_start, run_count, big_count, width,
                              height, tile_w, tile_h, init_depth_tiles, pass_class,
                              xla_order, alpha)[0]


def _alpha_args(alpha: VisAlpha, dev) -> tuple:
    """(pointer array, dims array) of the alpha form's C arguments."""
    n_tris, n_mat = alpha.tri_clip.shape[0], alpha.tex_diffuse.shape[0]
    for t, name, dtype, shape in (
            (alpha.tri_clip, "clip flags", torch.int32, (n_tris,)),
            (alpha.tri_material, "triangle materials", torch.int32, (n_tris,)),
            (alpha.tri_uv, "triangle uvs", torch.float32, (n_tris, 6)),
            (alpha.tex_diffuse, "diffuse refs", torch.int32, (n_mat,)),
            (alpha.alpha_factor, "alpha factors", torch.float32, (n_mat,)),
            (alpha.cutoff, "alpha cutoffs", torch.float32, (n_mat,)),
            (alpha.atlas_texels, "atlas texels", torch.bfloat16, None),
            (alpha.atlas_meta, "atlas meta", torch.int32, None)):
        kernels.check(t, name, dtype, shape, device=dev)
    classes = atlas_classes(alpha.atlas_meta)
    n_texels = alpha.atlas_texels.numel()
    ptrs = (ctypes.c_void_p * 8)(*(t.data_ptr() for t in alpha))
    dims = (ctypes.c_int * 9)(n_tris, n_mat, alpha.atlas_meta.shape[0],
                              alpha.atlas_meta.shape[1], alpha.atlas_texels.shape[-1],
                              class_mask(classes), max(classes), n_texels >> 31,
                              n_texels & (2**31 - 1))
    return ptrs, dims


def _raster_vis_launch(payload, tile_ids, run_start, run_count, big_count, width, height,
                       tile_w, tile_h, init_depth_tiles=None, pass_class=None,
                       xla_order=True, alpha=None) -> tuple:
    """Launch kernel 6 -> ((tri, depth, b1, b2), the int64 buffer it worked
    in: the per-pixel keys, then the plan, whose words the CUDA tests
    read). ``alpha`` takes the alpha form; under checks
    (render/checks.py) the checked form runs and its error word is
    reported after the frame."""
    records, big, rows = payload
    dev = records.device
    k_tiles = tile_ids.shape[0]
    if tile_w * tile_h > MAX_TILE_PX:
        raise ValueError(f"{tile_w}x{tile_h} tiles: the kernel takes at most "
                         f"{MAX_TILE_PX} pixels a tile")
    if alpha is not None and not xla_order:
        raise ValueError("the alpha test is the XLA-raster order's (kernel-6 order has none)")
    kernels.check(records, "records", torch.float32, (records.shape[0], REC_F32), align=16)
    kernels.check(big, "big records", torch.float32, (big.shape[0], REC_F32), device=dev,
                  align=16)
    kernels.check(rows, "records by tri id", torch.float32, (rows.shape[0], REC_F32),
                  device=dev, align=16)
    kernels.check(tile_ids, "tile_ids", torch.int32, (k_tiles,), device=dev)
    kernels.check(run_start, "run_start", torch.int32, (k_tiles,), device=dev)
    kernels.check(run_count, "run_count", torch.int32, (k_tiles,), device=dev)
    kernels.check(big_count, "big_count", torch.int32, (1,), device=dev)
    shape = (k_tiles, tile_h, tile_w)
    if init_depth_tiles is not None:
        kernels.check(init_depth_tiles, "init_depth_tiles", torch.float32, shape, device=dev)
    tri = torch.empty(shape, dtype=torch.int32, device=dev)
    depth, b1, b2 = torch.empty((3,) + shape, dtype=torch.float32, device=dev)
    # the merge key of every pixel (0: no winner), then the race's work
    # list, which the kernel builds (2 + 2K int32 in K + 1 more words)
    keys = torch.zeros(k_tiles * (tile_w * tile_h + 1) + 1, dtype=torch.int64, device=dev)
    ptrs, dims = _alpha_args(alpha, dev) if alpha is not None else (None, None)
    err = bounds = None
    if checks.active():
        err = torch.zeros(1, dtype=torch.int32, device=dev)
        n_init = init_depth_tiles.numel() if init_depth_tiles is not None else 0
        bounds = (ctypes.c_longlong * 4)(records.shape[0], big.shape[0], rows.shape[0], n_init)
    p = kernels.VOIDP
    fn = kernels.entry("trt_raster_vis", [
        p, p, p, p, p, p, p, p, kernels.INT, kernels.INT, kernels.INT, kernels.INT,
        kernels.FLOAT, kernels.FLOAT, kernels.INT, kernels.INT, kernels.INT, p, p, p, p, p,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong), p,
    ])
    kernels.launch(
        KERNEL, fn, kernels.ptr(records), kernels.ptr(big), kernels.ptr(rows),
        kernels.ptr(big_count), kernels.ptr(tile_ids), kernels.ptr(run_start),
        kernels.ptr(run_count), kernels.ptr(init_depth_tiles), k_tiles,
        -(-width // tile_w), tile_w, tile_h, 2.0 / width, 2.0 / height,
        -1 if pass_class is None else int(pass_class), int(xla_order), SEG,
        kernels.ptr(keys), kernels.ptr(tri), kernels.ptr(depth), kernels.ptr(b1),
        kernels.ptr(b2), ptrs, dims, bounds, kernels.ptr(err),
    )
    if err is not None:
        checks.report_word(err, CHECK_SITES)
    return (tri, depth, b1, b2), keys


KERNEL = kernels.KernelHandle(
    "raster_vis", "transmission_renderer_tpu_torch/csrc/raster_vis.cu",
    "transmission_renderer_tpu/ops/raster_pallas.py:103",
    cuda=_raster_vis_cuda, plain=raster_vis_plain,
)


def raster_vis(payload, tile_ids, run_start, run_count, big_count, width, height,
               tile_w, tile_h, init_depth_tiles=None, pass_class=None,
               xla_order=True, alpha=None) -> tuple:
    """Kernel 6 (plain version for CPU tensors): see raster_vis_plain."""
    # a call without alpha records the keywords it recorded before
    kw = {} if alpha is None else {"alpha": alpha}
    return KERNEL(payload[0].is_cuda, payload, tile_ids, run_start, run_count,
                  big_count, width, height, tile_w, tile_h,
                  init_depth_tiles=init_depth_tiles, pass_class=pass_class,
                  xla_order=xla_order, **kw)


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
    payload = payload if payload is not None else gather_bin_payload(setup, bins)
    n_big = bins.big_tri_ids.shape[0]
    # a length-1 big list means big triangles ride the sorted stream
    big_count = (torch.zeros((1,), dtype=torch.int32, device=payload[0].device) if n_big <= 1
                 else torch.clamp(bins.big_tri_count, max=n_big).to(torch.int32).reshape(1))
    start = tile_start[:-1].contiguous()
    return raster_vis(payload, tile_ids.contiguous(), start,
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
    alpha: VisAlpha | None = None,
) -> tuple:
    """Rasterise a list of tiles in XLA-raster order -> (tri, depth, b1,
    b2), each [K, tile_h, tile_w]. Each tile walks the first
    ``tile_tri_count`` records of its sorted run (its materialised list),
    then the big list; ``alpha`` adds the alpha test."""
    payload = payload if payload is not None else gather_bin_payload(setup, bins)
    tid = tile_indices.long()
    big_count = bins.big_tri_count.to(torch.int32).reshape(1)
    return raster_vis(payload, tile_indices.contiguous(),
                      bins.tile_start[tid].contiguous(),
                      bins.tile_tri_count[tid].contiguous(), big_count, width, height,
                      tile_w, tile_h, init_depth_tiles=init_depth_tiles, xla_order=True,
                      alpha=alpha)


def rasterize(setup: TriangleSetup, bins: TileBins, width: int, height: int,
              tile_w: int, tile_h: int, init_depth: torch.Tensor | None = None,
              payload: tuple | None = None, alpha: VisAlpha | None = None) -> VisibilityBuffer:
    """Rasterise every tile (XLA-raster order) into a visibility buffer;
    ``init_depth`` ([H, W]) seeds the depth race with an existing
    surface; ``alpha`` kills alpha-clip fragments in the race (the
    reference's ``alpha_coverage_fn``)."""
    n_tiles = -(-width // tile_w) * -(-height // tile_h)
    tile_ids = torch.arange(n_tiles, dtype=torch.int32, device=setup.adj.device)
    init = (tile_image(init_depth, tile_w, tile_h).contiguous()
            if init_depth is not None else None)
    outs = rasterize_tilelist(setup, bins, tile_ids, width, height, tile_w, tile_h,
                              init_depth_tiles=init, payload=payload, alpha=alpha)
    return _untiled(outs, width, height, tile_w, tile_h)
