"""Texture sampling over the quad-block atlas, and the GGX LUT taps.

Counterpart of ``transmission_renderer_tpu/ops/texture.py``:
``_tap_footprint``, ``_level_meta_from_rows``, ``_class_geometry``,
``_flat_row_index``, ``atlas_classes``, ``sample_bundle_rows`` (the
classic 2-level trilinear, ``fused=False``, or bilinear at floor(lod)),
``select_layer``, ``sample_texture_rows``, ``sample_texture`` (bilinear,
the AS-debug caster's tap),
``quad_lut_2ch``, ``lut_2ch_fetch_parts``, ``sample_lut_2ch_quad`` and
``sample_lut_2ch``.

On the G-buffer kernel path the material tap runs as kernel 2
(ops/tap_finish.py::sample_bundle_planes, whose plain version is
``sample_bundle_rows``) and the LUT tap inside kernel 4
(ops/tap_finish.py::transmission_fetch_planes); the tensor shading path
of the visibility-buffer frame calls these functions directly.
Conventions match Vulkan: texel centres at integer + 0.5, LOD 0 = full
resolution; a sub-block select is an exact gather, the same value the
reference's where-chain picks.
"""

from __future__ import annotations

import torch

from transmission_renderer_tpu_torch.render import checks
from transmission_renderer_tpu_torch.scene.textures import (  # noqa: F401
    BLOCK_TEXELS,
    IMAGE_MASK,
    LAYER_SHIFT,
    META_COLS,
    META_LAYERS_COL,
    QUAD_GROUP,
    QUAD_GROUP_SHIFT,
    WRAP_CLAMP,
    WRAP_REPEAT,
)


TEXEL_SITE = "ops/texture.py::_fetch_block: a tap's texel past the atlas"


def atlas_classes(meta: torch.Tensor) -> tuple:
    """Static set of per-image layer counts, decoded from the meta pad
    width (bit L-1 set when some image has L layers)."""
    mask = meta.shape[-1] - META_COLS
    if mask < 1:
        raise ValueError("atlas meta is missing its layer-class tag")
    return tuple(lc + 1 for lc in range(mask.bit_length()) if (mask >> lc) & 1)


def class_mask(classes: tuple) -> int:
    """The layer-class set as a bit mask (bit L-1 for class L), as the
    CUDA taps take it."""
    mask = 0
    for lc in classes:
        mask |= 1 << (lc - 1)
    return mask


def _class_geometry(row_elems: int, layers: int):
    """(group, shift, block_elems) of a layer class in a flat pool."""
    block_elems = BLOCK_TEXELS * 4 * layers
    g = max(1, row_elems // block_elems)
    g = 1 << max(g.bit_length() - 1, 0)
    return g, g.bit_length() - 1, block_elems


def _wrap_bilinear_coords(x, y, width, height, wrap_mode):
    """Footprint corner math -> (x0, y0 int32 wrapped, fx, fy)."""
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = x0f.to(torch.int32)
    y0 = y0f.to(torch.int32)
    if wrap_mode == WRAP_REPEAT:
        x0 = torch.remainder(x0, width)
        y0 = torch.remainder(y0, height)
    else:
        # below-zero footprints collapse onto the first column/row; the
        # upper edge is baked into the boundary blocks
        fx = torch.where(x0 < 0, 0.0, fx)
        fy = torch.where(y0 < 0, 0.0, fy)
        x0 = torch.minimum(torch.clamp(x0, min=0), width - 1)
        y0 = torch.minimum(torch.clamp(y0, min=0), height - 1)
    return x0, y0, fx, fy


def _tap_footprint(qoff, width, height, uv, wrap_mode):
    """-> (qidx, fx, fy, x0, y0): the footprint {x0, x0+1} x {y0, y0+1}
    lives in the block of phase (y0 & 1, x0 & 1) at (y0 >> 1, x0 >> 1)."""
    x = uv[..., 0] * width.to(torch.float32) - 0.5
    y = uv[..., 1] * height.to(torch.float32) - 0.5
    x0, y0, fx, fy = _wrap_bilinear_coords(x, y, width, height, wrap_mode)
    bw = (width + 1) >> 1
    bh = (height + 1) >> 1
    phase = (y0 & 1) * 2 + (x0 & 1)
    qidx = qoff + phase * (bw * bh) + (y0 >> 1) * bw + (x0 >> 1)
    return qidx, fx, fy, x0, y0


def _level_meta_from_rows(rows: torch.Tensor, level: torch.Tensor):
    """(block offset, width, height) of the clamped mip level from meta
    rows [..., META_COLS]; level sizes are max(size0 >> level, 1)."""
    num_mips = rows[..., 0]
    level = torch.minimum(torch.clamp(level, min=0), num_mips - 1)
    width = torch.clamp(rows[..., 2] >> level, min=1)
    height = torch.clamp(rows[..., 3] >> level, min=1)
    offset = torch.gather(rows, -1, (4 + level).long()[..., None])[..., 0]
    return offset, width, height


def _flat_row_index(qidx, row_elems, classes, layers_pix):
    """Physical row of a virtual block index (per-class group shift,
    selected by the pixel's layer count; the first class is the default)."""
    row_idx = qidx >> _class_geometry(row_elems, classes[0])[1]
    for lc in classes[1:]:
        shift = _class_geometry(row_elems, lc)[1]
        row_idx = torch.where(layers_pix == lc, qidx >> shift, row_idx)
    return row_idx


def _fetch_block(quads, qoff, width, height, uv, wrap_mode, classes, layers_pix):
    """The pixel's 2x2 block, all layers, normalised to the max layer
    width ([..., 4 texels * 4 * Lmax], absent layers zero) in float32."""
    qidx, fx, fy, x0, y0 = _tap_footprint(qoff, width, height, uv, wrap_mode)
    row_elems = quads.shape[-1]
    l_max = max(classes)
    row_idx = _flat_row_index(qidx, row_elems, classes, layers_pix)
    flat = quads.reshape(-1)
    out = None
    for lc in classes:
        g, _, blkw = _class_geometry(row_elems, lc)
        sub = qidx & (g - 1)
        base = row_idx.long() * row_elems + (sub * blkw).long()
        idx = base[..., None] + torch.arange(blkw, device=quads.device)
        blk = flat[checks.index(idx, flat.numel(), TEXEL_SITE)]
        if lc < l_max:
            zeros = blk.new_zeros(blk.shape[:-1] + (4 * (l_max - lc),))
            parts = []
            for t in range(BLOCK_TEXELS):
                parts += [blk[..., t * 4 * lc : (t + 1) * 4 * lc], zeros]
            blk = torch.cat(parts, dim=-1)
        if out is None:
            out = blk
        else:
            out = torch.where((layers_pix == lc)[..., None], blk, out)
    # bf16 texels convert AFTER the select; the lerp runs in f32
    return out.to(torch.float32), fx[..., None], fy[..., None]


def _lerp4(c00, c10, c01, c11, fx, fy):
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def _bilinear_level_quad(quads, qoff, width, height, uv, wrap_mode, classes,
                         layers_pix):
    blk, fx, fy = _fetch_block(quads, qoff, width, height, uv, wrap_mode,
                               classes, layers_pix)
    c = blk.shape[-1] // BLOCK_TEXELS
    q = blk.reshape(blk.shape[:-1] + (BLOCK_TEXELS, c))
    return _lerp4(q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :], fx, fy)


def sample_bundle_rows(
    quads: torch.Tensor,  # [R, row_elems] bfloat16
    rows: torch.Tensor,  # [..., META_COLS] int32 meta rows
    uv: torch.Tensor,  # [..., 2]
    lod: torch.Tensor,  # [...]
    wrap_mode: int,
    classes: tuple,
    trilinear: bool = True,
) -> torch.Tensor:
    """Explicit-LOD sample of all bundle layers -> [..., Lmax, 4]: two
    bilinear levels blended by the lod fraction, or with ``trilinear``
    False the bilinear tap at floor(lod) alone."""
    lod = torch.clamp(lod, min=0.0)
    layers_pix = rows[..., META_LAYERS_COL]
    l_max = max(classes)
    l0 = torch.floor(lod).to(torch.int32)
    o0, w0, h0 = _level_meta_from_rows(rows, l0)
    c0 = _bilinear_level_quad(quads, o0, w0, h0, uv, wrap_mode, classes,
                              layers_pix)
    if trilinear:
        o1, w1, h1 = _level_meta_from_rows(rows, l0 + 1)
        c1 = _bilinear_level_quad(quads, o1, w1, h1, uv, wrap_mode, classes,
                                  layers_pix)
        frac = (lod - l0.to(torch.float32))[..., None]
        c0 = c0 + (c1 - c0) * frac
    return c0.reshape(c0.shape[:-1] + (l_max, 4))


def select_layer(samples: torch.Tensor, layer: torch.Tensor) -> torch.Tensor:
    """[..., L, 4] bundle samples + [...] layer -> [..., 4] (a layer past
    the bundle reads layer 0, as the reference's select chain)."""
    layer = torch.where((layer >= 0) & (layer < samples.shape[-2]), layer, 0).long()
    idx = layer[..., None, None].expand(layer.shape + (1, samples.shape[-1]))
    return torch.gather(samples, -2, idx)[..., 0, :]


def sample_texture_rows(
    quads: torch.Tensor,
    rows: torch.Tensor,  # [..., META_COLS] int32 meta rows
    uv: torch.Tensor,
    lod: torch.Tensor,
    wrap_mode: int,
    classes: tuple,
    layer: torch.Tensor | None = None,
) -> torch.Tensor:
    """Trilinear sample of one texture per pixel -> [..., 4]: bundle
    layer ``layer`` (layer 0 when None, exact for single images)."""
    s = sample_bundle_rows(quads, rows, uv, lod, wrap_mode, classes)
    return s[..., 0, :] if layer is None else select_layer(s, layer)


def sample_texture(
    quads: torch.Tensor,  # [R, row_elems] bfloat16
    meta: torch.Tensor,  # [num_images, META_COLS + class tag] int32
    texture_id: torch.Tensor,  # [...] int32 packed refs (callers mask -1)
    uv: torch.Tensor,  # [..., 2]
    lod: torch.Tensor,  # [...]
    wrap_mode: int = WRAP_REPEAT,
) -> torch.Tensor:
    """Bilinear sample at floor(lod) of one texture per pixel -> [..., 4]:
    the reference's ``sample_texture(..., trilinear=False)``, what the
    AS-debug caster taps. ``texture_id`` is a packed ref (image | layer
    << 16); one meta-row gather per sample."""
    texture_id = torch.clamp(texture_id, min=0)
    classes = atlas_classes(meta)
    rows = meta[(texture_id & IMAGE_MASK).long()][..., :META_COLS]
    s = sample_bundle_rows(quads, rows, uv, lod, wrap_mode, classes, trilinear=False)
    if max(classes) == 1:
        return s[..., 0, :]
    return select_layer(s, texture_id >> LAYER_SHIFT)


# ---------------------------------------------------------------------------
# GGX split-sum LUT (2 channels, clamp-to-edge bilinear)
# ---------------------------------------------------------------------------

def quad_lut_2ch(lut: torch.Tensor) -> torch.Tensor:
    """[S, S, 2] LUT -> phase-shifted 2x2 blocks, QUAD_GROUP per row
    (CLAMP edges baked): [ceil(4 (S/2)^2 / G), 8 G]."""
    s = lut.shape[0]
    b = (s + 1) // 2
    pad = 2 * b + 1 - s
    padded = torch.cat([lut, lut[-1:].expand(pad, -1, -1)], dim=0)
    padded = torch.cat([padded, padded[:, -1:].expand(-1, pad, -1)], dim=1)
    phases = []
    for py in (0, 1):
        for px in (0, 1):
            sub = padded[py : py + 2 * b, px : px + 2 * b]
            blk = sub.reshape(b, 2, b, 2, 2).permute(0, 2, 1, 3, 4)
            phases.append(blk.reshape(b * b, 8))
    q = torch.cat(phases, dim=0)
    extra = (-q.shape[0]) % QUAD_GROUP
    if extra:
        q = torch.cat([q, q.new_zeros((extra, 8))])
    return q.reshape(-1, 8 * QUAD_GROUP)


def _lut_coords(size: int, u: torch.Tensor, v: torch.Tensor):
    s = size
    x = torch.clamp(u * s - 0.5, 0.0, s - 1.0)
    y = torch.clamp(v * s - 0.5, 0.0, s - 1.0)
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = x - x0.to(torch.float32)
    fy = y - y0.to(torch.float32)
    return x0, y0, fx, fy


def lut_2ch_fetch_parts(quads: torch.Tensor, size: int, u, v):
    """(rows, sub, fx, fy): the quad-row gather + footprint halves of
    sample_lut_2ch_quad."""
    x0, y0, fx, fy = _lut_coords(size, u, v)
    b = (size + 1) >> 1
    qidx = ((y0 & 1) * 2 + (x0 & 1)) * (b * b) + (y0 >> 1) * b + (x0 >> 1)
    return quads[(qidx >> QUAD_GROUP_SHIFT).long()], qidx & (QUAD_GROUP - 1), fx, fy


def sample_lut_2ch_quad(quads: torch.Tensor, size: int, u, v) -> torch.Tensor:
    """One-row clamp-sampled bilinear LUT fetch -> [..., 2]."""
    rows, sub, fx, fy = lut_2ch_fetch_parts(quads, size, u, v)
    grp = rows.reshape(rows.shape[:-1] + (QUAD_GROUP, 8))
    q8 = torch.gather(
        grp, -2, sub.long()[..., None, None].expand(sub.shape + (1, 8))
    )[..., 0, :]
    q = q8.reshape(sub.shape + (4, 2))
    return _lerp4(q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :],
                  fx[..., None], fy[..., None])


def sample_lut_2ch(lut: torch.Tensor, u, v) -> torch.Tensor:
    """Clamp-sampled bilinear fetch straight from an [S, S, 2] LUT — the
    same texels and lerp as the quad form (shader/src/lib.rs:126-133)."""
    s = lut.shape[0]
    x0, y0, fx, fy = _lut_coords(s, u, v)
    x1 = torch.clamp(x0 + 1, max=s - 1).long()
    y1 = torch.clamp(y0 + 1, max=s - 1).long()
    x0, y0 = x0.long(), y0.long()
    return _lerp4(lut[y0, x0], lut[y0, x1], lut[y1, x0], lut[y1, x1],
                  fx[..., None], fy[..., None])

