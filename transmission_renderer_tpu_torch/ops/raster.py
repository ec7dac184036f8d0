"""Triangle setup, sort-based binning, tile layout helpers.

Counterpart of ``transmission_renderer_tpu/ops/raster.py``:
``setup_triangles`` (2D-homogeneous adjugate edge functions, backface and
off-screen culls, tile bounding boxes), ``VisibilityBuffer``, both modes
of ``bin_triangles`` (``bin_triangles``: the G-buffer kernel path's
``materialize=False`` mode with class-split bins, the ``pallas_tiers``
demotion ladder and no pair compaction; ``bin_triangles_materialized``:
the visibility-buffer path's ``materialize=True`` mode with capped
per-tile lists and a separate big-triangle list) and
``tile_image`` / ``untile_image``.

Binning order is part of the result: records of a tile sort by the two
keys (tile * num_classes + class, triangle id), and the raster keeps the
first record on equal depth, so the same order gives the same triangle
ids. The visibility raster that walks the materialised bins (the
reference's ``rasterize_tilelist`` / ``rasterize``) sits with its kernel
in ``ops/raster_vis.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from transmission_renderer_tpu_torch.render import checks

BIN_GATHER_SITE = ("ops/raster.py::bin_triangles_materialized: a tile's list slot past "
                   "the sorted pairs")

class TriangleSetup(NamedTuple):
    """Per-triangle rasterisation constants (all [T, ...])."""

    adj: torch.Tensor  # [T, 3, 3] signed adjugate rows
    z_clip: torch.Tensor  # [T, 3]
    w_clip: torch.Tensor  # [T, 3]
    valid: torch.Tensor  # [T] bool
    tile_bbox: torch.Tensor  # [T, 4] int32 (tx0, ty0, tx1, ty1) inclusive


class VisibilityBuffer(NamedTuple):
    tri_id: torch.Tensor  # [H, W] int32, -1 = background
    depth: torch.Tensor  # [H, W] f32 reversed-Z (0 = cleared/far)
    bary: torch.Tensor  # [H, W, 2] perspective-correct (b1, b2)


class TileBins(NamedTuple):
    """Sorted (bin, triangle) pairs: class-split for the G-buffer kernel
    (``bin_triangles``), or one bin per tile with the capped per-tile
    lists and the big-triangle list of the visibility-buffer path
    (``bin_triangles_materialized``)."""

    sorted_tri_ids: torch.Tensor  # [S] int32 (sentinel pairs sort last)
    tile_start: torch.Tensor  # [num_classes * n_tiles + 1] int32
    big_tri_ids: torch.Tensor  # [B] int32, -1 padded ([1] all -1: none)
    big_tri_count: torch.Tensor  # [] int32 (see each binning's docstring)
    max_bin_count: torch.Tensor  # [] int32 busiest bin, unclamped
    mid_tri_count: torch.Tensor  # [] int32 (0: the ladder replaces it)
    tier_demands: tuple = ()  # per-rung unclamped demand ([] int32 each)
    tier_slots: tuple = ()  # per-rung static capacity
    # materialised mode only: [n_tiles, max_tris_per_tile] -1 padded, and
    # the per-tile counts clamped to max_tris_per_tile
    tile_tri_ids: torch.Tensor | None = None
    tile_tri_count: torch.Tensor | None = None


def _adjugate3(m: torch.Tensor) -> torch.Tensor:
    """Adjugate of [..., 3, 3]: adj @ m = det * I."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return torch.stack(
        [
            torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
            torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
            torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
        ],
        dim=-2,
    )


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 fused multiply-add: the float32 product is exact in
    float64, so one float64 add and one rounding give fma(a, b, c)."""
    f64 = torch.float64
    return (a.to(f64) * b.to(f64) + c.to(f64)).to(torch.float32)


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] exactly as the reference's jitted frame
    computes it: jnp.linalg.det's rule-of-Sarrus closed form, whose first
    five products its compiler chains through fused multiply-adds while
    the last one is subtracted unfused. Bit-equal values keep the
    backface cull's decisions equal, down to the sign of degenerate
    triangles (two equal vertices, as at a sphere's poles), whose
    unfused determinant would be exactly 0. Those never cover a pixel,
    but they fill bins, and the visibility-buffer path cuts its bins at
    ``max_tris_per_tile``. (A standalone jnp.linalg.det call fuses the
    last product too.)"""
    def g(i, j):
        return m[..., i, j]

    s = _fma(g(0, 0) * g(1, 1), g(2, 2), g(0, 1) * g(1, 2) * g(2, 0))
    s = _fma(g(0, 2) * g(1, 0), g(2, 1), s)
    s = _fma(-(g(0, 2) * g(1, 1)), g(2, 0), s)
    s = _fma(-(g(0, 0) * g(1, 2)), g(2, 1), s)
    return s - g(0, 1) * g(1, 0) * g(2, 2)


def _tile_index(v: torch.Tensor, tile: int, n: int) -> torch.Tensor:
    """clip(floor(v / tile), 0, n - 1) as int32, clamped in float first:
    out-of-range coordinates saturate and NaN reads 0, as the reference's
    float-to-int conversion does."""
    v = torch.nan_to_num(torch.floor(v / tile), nan=0.0)
    return torch.clamp(v, 0, n - 1).to(torch.int32)


def setup_triangles(
    clip_positions: torch.Tensor,  # [V, 4]
    tri_vertices: torch.Tensor,  # [T, 3] int32
    tri_enabled: torch.Tensor,  # [T] bool
    width: int,
    height: int,
    tile_w: int,
    tile_h: int,
) -> TriangleSetup:
    """Adjugate edge matrix, orientation cull (front faces have
    det < 0 under the y-flipping projection), tile bbox."""
    v = clip_positions[tri_vertices.long()]  # [T, 3, 4]
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    m = torch.stack([x, y, w], dim=-2)  # [T, 3(xyw), 3(vertex)]
    det = _det3(m)
    adj = _adjugate3(m)
    valid = tri_enabled & (det < 0.0)

    tiles_x = -(-width // tile_w)
    tiles_y = -(-height // tile_h)
    safe_w = torch.clamp(w, min=1e-30)
    sx = (x / safe_w + 1.0) * (0.5 * width)
    sy = (y / safe_w + 1.0) * (0.5 * height)
    any_behind = torch.any(w <= 1e-6, dim=-1)
    zero = torch.zeros_like(sx[:, 0])
    x0 = torch.where(any_behind, zero, sx.amin(dim=-1))
    x1 = torch.where(any_behind, zero + float(width), sx.amax(dim=-1))
    y0 = torch.where(any_behind, zero, sy.amin(dim=-1))
    y1 = torch.where(any_behind, zero + float(height), sy.amax(dim=-1))
    tx0 = _tile_index(x0, tile_w, tiles_x)
    ty0 = _tile_index(y0, tile_h, tiles_y)
    tx1 = _tile_index(x1 - 1e-6, tile_w, tiles_x)
    ty1 = _tile_index(y1 - 1e-6, tile_h, tiles_y)
    on_screen = (x1 > 0) & (x0 < width) & (y1 > 0) & (y0 < height)
    valid = valid & (any_behind | on_screen)
    # every w <= 0: no fragment can pass the w_interp > 0 test
    valid = valid & ~torch.all(w <= 0.0, dim=-1)
    return TriangleSetup(
        adj=-adj,
        z_clip=z,
        w_clip=w,
        valid=valid,
        tile_bbox=torch.stack([tx0, ty0, tx1, ty1], dim=-1),
    )


def _expand(tri, bbox, slots, tiles_x, n_valid_tri, cls, num_classes, n_bins):
    """bbox-expanded (bin, tri) pairs: slot j of a triangle covers tile
    (tx0 + j % bw, ty0 + j // bw); slots past the coverage get the
    sentinel bin."""
    tx0, ty0, tx1, ty1 = (bbox[:, i] for i in range(4))
    bw = tx1 - tx0 + 1
    coverage = bw * (ty1 - ty0 + 1)
    bw_safe = torch.clamp(bw, min=1)[:, None]  # masked below when <= 0
    slot = torch.arange(slots, dtype=torch.int32, device=tri.device)[None, :]
    tile = (ty0[:, None] + slot // bw_safe) * tiles_x + (tx0[:, None] + slot % bw_safe)
    ok = n_valid_tri[:, None] & (slot < coverage[:, None])
    bins = torch.where(ok, tile * num_classes + cls[:, None], n_bins)
    tris = tri[:, None].expand(-1, slots)
    return bins.reshape(-1), tris.reshape(-1)


def bin_triangles(
    setup: TriangleSetup,
    tiles_x: int,
    tiles_y: int,
    max_tiles_per_tri: int,
    class_flags: torch.Tensor,  # [T] int in [0, num_classes)
    num_classes: int,
    tiers: tuple,
) -> TileBins:
    """Sort-based class-split binning with the demotion tier ladder.

    Triangles covering <= K tiles emit K (bin, tri) pair slots; larger
    ones demote to the first rung of ``tiers`` ((tile_cap, max_tris),
    cap 0 = full screen) whose cap holds their coverage, and emit cap
    slots each. Rung overflow drops draws; ``tier_demands`` reports it.
    """
    if not tiers or tiers[-1][0] != 0:
        raise ValueError("the tier ladder must end in the full-screen rung (cap 0)")
    dev = setup.adj.device
    n_tiles = tiles_x * tiles_y
    n_bins = num_classes * n_tiles
    num_tris = setup.adj.shape[0]
    k = max_tiles_per_tri
    cls = class_flags.to(torch.int32)
    bbox = setup.tile_bbox
    coverage = (bbox[:, 2] - bbox[:, 0] + 1) * (bbox[:, 3] - bbox[:, 1] + 1)
    is_big = setup.valid & (coverage > k)
    in_bins = setup.valid & (coverage <= k)
    tri_ids = torch.arange(num_tris, dtype=torch.int32, device=dev)
    parts_b, parts_t = [], []
    b, t = _expand(tri_ids, bbox, k, tiles_x, in_bins, cls, num_classes, n_bins)
    parts_b.append(b)
    parts_t.append(t)

    spans, prev_cap = [], k
    for cap_tiles, max_n in tiers:
        cap_tiles = n_tiles if cap_tiles == 0 else min(cap_tiles, n_tiles)
        if cap_tiles <= prev_cap:
            continue
        spans.append((prev_cap, cap_tiles, max_n))
        prev_cap = cap_tiles

    # one compaction shared by every rung: each demoted triangle gets
    # (rung offset + rank within rung); the rest get a unique slot past
    # the end that is sliced away
    total_slots = sum(mn for _, _, mn in spans)
    pos = tri_ids.long() + total_slots
    demands = []
    off = 0
    for lo, hi, mn in spans:
        sel = is_big & (coverage > lo) & (coverage <= hi)
        csum = torch.cumsum(sel.to(torch.int32), 0)
        rank = csum - 1
        demands.append(csum[-1].to(torch.int32))
        pos = torch.where(sel & (rank < mn), (off + rank).long(), pos)
        off += mn
    compact = torch.full((total_slots + num_tris,), num_tris, dtype=torch.int32,
                         device=dev)
    compact[pos] = tri_ids
    off = 0
    for lo, hi, mn in spans:
        tri = compact[off : off + mn]
        off += mn
        safe = torch.clamp(tri, max=num_tris - 1).long()
        b, t = _expand(tri, bbox[safe], hi, tiles_x, tri < num_tris,
                       cls[safe], num_classes, n_bins)
        parts_b.append(b)
        parts_t.append(t)
    giant_demand = demands[-1]
    flat_tris = torch.cat(parts_t)
    flat_tris = torch.where(flat_tris >= num_tris, -1, flat_tris)
    sorted_tris, tile_start = _sort_pairs(torch.cat(parts_b), flat_tris, n_bins)
    raw_counts = tile_start[1:] - tile_start[:-1]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return TileBins(
        sorted_tri_ids=sorted_tris,
        tile_start=tile_start,
        big_tri_ids=torch.full((1,), -1, dtype=torch.int32, device=dev),
        big_tri_count=giant_demand,
        max_bin_count=raw_counts.max().to(torch.int32),
        mid_tri_count=zero,
        tier_demands=tuple(demands),
        tier_slots=tuple(mn for _, _, mn in spans),
    )


def _sort_pairs(flat_bins: torch.Tensor, flat_tris: torch.Tensor, n_bins: int):
    """Two-key sort of (bin, tri) pairs (tri-ascending within a bin is
    draw order) -> (sorted tri ids int32, tile_start [n_bins + 1] int32)."""
    key = flat_bins.to(torch.int64) * (1 << 32) + (flat_tris.to(torch.int64) + 1)
    key, _ = torch.sort(key)
    sorted_bins = key >> 32
    sorted_tris = ((key & 0xFFFFFFFF) - 1).to(torch.int32)
    tile_start = torch.searchsorted(
        sorted_bins, torch.arange(n_bins + 1, dtype=torch.int64, device=key.device)
    ).to(torch.int32)
    return sorted_tris, tile_start


def bin_triangles_materialized(
    setup: TriangleSetup,
    tiles_x: int,
    tiles_y: int,
    max_tiles_per_tri: int,
    max_tris_per_tile: int,
    max_big_tris: int,
) -> TileBins:
    """The visibility-buffer path's binning (the reference's
    ``bin_triangles(materialize=True)``).

    Triangles covering <= K tiles emit one (tile, tri) pair per covered
    tile of their bbox; each tile's sorted run is cut to its first
    ``max_tris_per_tile`` triangles (the rest are dropped, and
    ``max_bin_count`` keeps the uncut maximum). Larger triangles go to
    the big list, ascending ids cut to ``max_big_tris``;
    ``big_tri_count`` is that list's length (clamped, as the reference's).
    """
    dev = setup.adj.device
    n_tiles = tiles_x * tiles_y
    num_tris = setup.adj.shape[0]
    bbox = setup.tile_bbox
    coverage = (bbox[:, 2] - bbox[:, 0] + 1) * (bbox[:, 3] - bbox[:, 1] + 1)
    is_big = setup.valid & (coverage > max_tiles_per_tri)
    in_bins = setup.valid & (coverage <= max_tiles_per_tri)
    tri_ids = torch.arange(num_tris, dtype=torch.int32, device=dev)
    zeros = torch.zeros_like(tri_ids)
    flat_bins, flat_tris = _expand(tri_ids, bbox, max_tiles_per_tri, tiles_x, in_bins,
                                   zeros, 1, n_tiles)
    sorted_tris, tile_start = _sort_pairs(flat_bins, flat_tris, n_tiles)
    raw_counts = tile_start[1:] - tile_start[:-1]
    counts = torch.clamp(raw_counts, max=max_tris_per_tile)
    slot = torch.arange(max_tris_per_tile, device=dev)
    gather = tile_start[:-1, None].long() + slot[None, :]
    in_range = slot[None, :] < counts[:, None]
    # slots past a tile's count read a clamped row and are dropped; under
    # checks a counted slot past the pairs is reported
    gather = torch.clamp(checks.index(gather, sorted_tris.shape[0], BIN_GATHER_SITE,
                                      used=in_range), 0, sorted_tris.shape[0] - 1)
    tile_tri_ids = torch.where(in_range, sorted_tris[gather], -1)

    # big list: the is_big ids in ascending order (a stable sort puts them
    # first), -1 past their number, cut or padded to max_big_tris
    n_big = is_big.to(torch.int32).sum()
    order = torch.argsort((~is_big).to(torch.uint8), stable=True).to(torch.int32)
    big_ids = torch.where(tri_ids < n_big, order, -1)[:max_big_tris]
    if num_tris < max_big_tris:
        big_ids = torch.cat([big_ids, big_ids.new_full((max_big_tris - num_tris,), -1)])
    return TileBins(
        sorted_tri_ids=sorted_tris,
        tile_start=tile_start,
        big_tri_ids=big_ids,
        big_tri_count=torch.clamp(n_big, max=max_big_tris).to(torch.int32),
        max_bin_count=raw_counts.max().to(torch.int32),
        mid_tri_count=torch.zeros((), dtype=torch.int32, device=dev),
        tile_tri_ids=tile_tri_ids,
        tile_tri_count=counts.to(torch.int32),
    )


def tile_image(img: torch.Tensor, tile_w: int, tile_h: int) -> torch.Tensor:
    """[H, W, ...] -> [n_tiles, tile_h, tile_w, ...] (zero-padded)."""
    h, w = img.shape[:2]
    tiles_x = -(-w // tile_w)
    tiles_y = -(-h // tile_h)
    pad_h, pad_w = tiles_y * tile_h - h, tiles_x * tile_w - w
    if pad_h or pad_w:
        out = img.new_zeros((tiles_y * tile_h, tiles_x * tile_w) + img.shape[2:])
        out[:h, :w] = img
        img = out
    img = img.reshape((tiles_y, tile_h, tiles_x, tile_w) + img.shape[2:])
    img = img.transpose(1, 2)
    return img.reshape((tiles_y * tiles_x, tile_h, tile_w) + img.shape[4:])


def untile_image(a: torch.Tensor, tiles_x: int, tiles_y: int, tile_w: int,
                 tile_h: int, width: int, height: int) -> torch.Tensor:
    """[n_tiles, th, tw, ...] -> [height, width, ...] (row-major tiles)."""
    extra = a.shape[3:]
    a = a.reshape((tiles_y, tiles_x, tile_h, tile_w) + extra)
    a = a.transpose(1, 2).reshape((tiles_y * tile_h, tiles_x * tile_w) + extra)
    return a[:height, :width]
