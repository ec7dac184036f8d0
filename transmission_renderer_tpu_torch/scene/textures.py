"""Texture atlas: quad-block texel pool + per-image metadata table.

Counterpart of ``transmission_renderer_tpu/scene/textures.py``
(AtlasBuilder, META_* columns, mip_levels_for_size, linear_to_srgb). The
values are the reference's exactly: byte-space 2x2 box mips, texels
decoded to linear once, each level stored as four phase-shifted 2x2
blocks (CLAMP/REPEAT edges baked in), per-image row groups of
``ROW_ELEMS`` elements and the layer-class bitmask padded onto the meta
table. The TPU row grouping is kept so the samplers (and their tests)
address the same texels; a Hopper-native layout is later work.

Storage is bfloat16. The reference rounds through ``ml_dtypes`` (absent
on the machine with the card); here float32 -> ``torch.bfloat16`` does
the same round-to-nearest-even, so the texels are bit-identical.
Only the compact 4-texel block (the reference's default,
``TRTPU_ATLAS_FUSED=0``) exists in the port.
"""

from __future__ import annotations

import numpy as np
import torch

# meta row: [0] num_mips, [1] srgb, [2] level-0 width, [3] level-0 height,
# [4 + m] block offset of mip m, [4 + MAX_MIPS] the image's layer count
MAX_MIPS = 13
META_LAYERS_COL = 4 + MAX_MIPS
META_COLS = 5 + MAX_MIPS

QUAD_GROUP = 4  # blocks per row of the GGX LUT's quad table
QUAD_GROUP_SHIFT = 2
BLOCK_TEXELS = 4  # texels per quad block (t00 t10 t01 t11)
ROW_ELEMS = 128  # flat atlas row width in elements

WRAP_REPEAT = 0
WRAP_CLAMP = 1

LAYER_SHIFT = 16
IMAGE_MASK = (1 << LAYER_SHIFT) - 1


def texture_ref(image_id: int, layer: int = 0) -> int:
    """Pack an atlas entry + bundle layer into one material texture ref."""
    assert 0 <= image_id <= IMAGE_MASK and layer >= 0
    return image_id | (layer << LAYER_SHIFT)


def mip_levels_for_size(width: int, height: int) -> int:
    """floor(log2(max(w,h))) + 1 (src/main.rs:2590-2592)."""
    return int(np.floor(np.log2(max(width, height)))) + 1


def _box_downsample(img: np.ndarray) -> np.ndarray:
    """2x2 byte-space average (Vulkan LINEAR blit), floor(n/2) sizing."""
    h, w = img.shape[:2]
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    img = img[: nh * 2, : nw * 2].astype(np.float32)
    if h == 1:
        pooled = (img[:, 0::2] + img[:, 1::2]) / 2.0
    elif w == 1:
        pooled = (img[0::2] + img[1::2]) / 2.0
    else:
        pooled = (
            img[0::2, 0::2] + img[0::2, 1::2] + img[1::2, 0::2] + img[1::2, 1::2]
        ) / 4.0
    return np.round(pooled).astype(np.uint8)


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """Exact sRGB EOTF (what R8G8B8A8_SRGB sampling applies)."""
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c: np.ndarray) -> np.ndarray:
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)


def _decode_rgba8(img: np.ndarray, srgb: bool) -> np.ndarray:
    """[H, W, 4] uint8 -> linear float32 (/255, sRGB EOTF on RGB)."""
    f = img.astype(np.float32) / np.float32(255.0)
    if srgb:
        f = np.concatenate([srgb_to_linear(f[..., :3]), f[..., 3:]], axis=-1)
    return f.astype(np.float32)


def quad_block_counts(width: int, height: int) -> tuple[int, int]:
    """(bw, bh): per-phase block-grid size for a level of (width, height)."""
    return (width + 1) // 2, (height + 1) // 2


def _quad_blocks(texels: np.ndarray, wrap: int) -> np.ndarray:
    """[H, W, C] -> [4 * bh * bw, 4 * C] phase-shifted 2x2 blocks:
    block (phase=(py,px), by, bx) holds (y0, x0), (y0, x0+1), (y0+1, x0),
    (y0+1, x0+1) with y0 = 2*by + py, x0 = 2*bx + px, wrapped."""
    h, w, c = texels.shape
    bw, bh = quad_block_counts(w, h)

    def wrapc(v, size):
        return v % size if wrap == WRAP_REPEAT else np.clip(v, 0, size - 1)

    out = np.empty((4, bh, bw, BLOCK_TEXELS, c), np.float32)
    for py in (0, 1):
        for px in (0, 1):
            xs0 = wrapc(2 * np.arange(bw) + px, w)
            xs1 = wrapc(2 * np.arange(bw) + px + 1, w)
            ys0 = wrapc(2 * np.arange(bh) + py, h)
            ys1 = wrapc(2 * np.arange(bh) + py + 1, h)
            p = 2 * py + px
            out[p, :, :, 0] = texels[np.ix_(ys0, xs0)]
            out[p, :, :, 1] = texels[np.ix_(ys0, xs1)]
            out[p, :, :, 2] = texels[np.ix_(ys1, xs0)]
            out[p, :, :, 3] = texels[np.ix_(ys1, xs1)]
    return out.reshape(-1, BLOCK_TEXELS * c)


class AtlasBuilder:
    """Accumulates images; ``finish()`` yields (texels, meta, srgb)."""

    def __init__(self):
        self._images: list[tuple[list[np.ndarray], int]] = []
        self._meta: list[np.ndarray] = []
        self._srgb: list[bool] = []

    def push_bundle(
        self,
        rgbas: list[np.ndarray],
        srgbs: list[bool],
        generate_mips: bool = True,
        wrap: int = WRAP_REPEAT,
    ) -> int:
        """Add same-size RGBA8 images as one multi-layer entry (+ mips)."""
        assert rgbas and len(rgbas) == len(srgbs)
        h, w = rgbas[0].shape[:2]
        for r in rgbas:
            assert r.dtype == np.uint8 and r.shape == (h, w, 4), r.shape
        image_id = len(self._meta)
        levels = mip_levels_for_size(w, h) if generate_mips else 1
        levels = min(levels, MAX_MIPS)
        row = np.zeros(META_COLS, np.int32)
        row[0] = levels
        row[1] = int(srgbs[0])
        row[2] = w
        row[3] = h
        level_imgs = list(rgbas)
        chains = []
        for m in range(levels):
            chains.append(np.concatenate(
                [_decode_rgba8(im, s) for im, s in zip(level_imgs, srgbs)],
                axis=-1,
            ))
            if m + 1 < levels:
                level_imgs = [_box_downsample(im) for im in level_imgs]
        self._meta.append(row)
        self._srgb.append(bool(srgbs[0]))
        self._images.append((chains, wrap))
        return image_id

    def push_image(self, rgba: np.ndarray, srgb: bool,
                   generate_mips: bool = True, wrap: int = WRAP_REPEAT) -> int:
        return self.push_bundle([rgba], [srgb], generate_mips, wrap)

    @property
    def num_images(self) -> int:
        return len(self._meta)

    def push_time_meta(self) -> np.ndarray:
        """Meta rows as pushed (level-0 sizes are what SceneFlags reads)."""
        return np.stack(self._meta)

    def finish(self):
        """-> (texels [R, row_elems] bfloat16, meta int32, srgb bool),
        all CPU tensors. Per-image row groups: an image with L layers
        packs G = ROW_ELEMS // (16 L) blocks per row (power of two) and
        its meta offsets are virtual block indices row_base * G + local."""
        if not self._meta:
            self.push_image(np.full((1, 1, 4), 255, np.uint8), srgb=False)
        row_elems = max(
            ROW_ELEMS,
            max(BLOCK_TEXELS * 4 * (c[0].shape[-1] // 4) for c, _ in self._images),
        )
        rows_out, metas = [], []
        row_base = 0
        for (chains, wrap), meta_row in zip(self._images, self._meta):
            layers = chains[0].shape[-1] // 4
            block_elems = BLOCK_TEXELS * 4 * layers
            g = max(1, row_elems // block_elems)
            g = 1 << max(g.bit_length() - 1, 0)
            row = meta_row.copy()
            levels = int(row[0])
            blocks, local = [], 0
            for m, dec in enumerate(chains):
                row[4 + m] = row_base * g + local
                blk = _quad_blocks(dec, wrap)
                blocks.append(blk)
                local += len(blk)
            # unused mip slots alias the last level (LOD clamp = index clamp)
            row[4 + levels : META_LAYERS_COL] = row[4 + levels - 1]
            row[META_LAYERS_COL] = layers
            q = np.concatenate(blocks)
            pad = (-len(q)) % g
            if pad:
                q = np.concatenate([q, np.zeros((pad, block_elems), np.float32)])
            q = q.reshape(-1, g * block_elems)
            if q.shape[1] < row_elems:
                q = np.pad(q, ((0, 0), (0, row_elems - q.shape[1])))
            rows_out.append(q)
            metas.append(row)
            row_base += len(q)
            assert row_base * g < (1 << 24), "atlas offsets exceed f32 range"
        texels = torch.from_numpy(np.concatenate(rows_out)).to(torch.bfloat16)
        meta = np.stack(metas)
        # static class tag: bit L-1 of the meta PAD WIDTH is set when some
        # image has L layers (ops/texture.py::atlas_classes)
        mask = 0
        for row in metas:
            mask |= 1 << (int(row[META_LAYERS_COL]) - 1)
        meta = np.pad(meta, ((0, 0), (0, mask)))
        return (
            texels,
            torch.from_numpy(meta.astype(np.int32)),
            torch.from_numpy(np.array(self._srgb, bool)),
        )
