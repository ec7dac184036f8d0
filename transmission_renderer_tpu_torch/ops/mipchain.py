"""Opaque-framebuffer mip pyramid and its clamp-sampled LOD fetch.

Counterpart of ``transmission_renderer_tpu/ops/mipchain.py``
(pyramid_shapes, build_pyramid, sample_pyramid_lod). The 2x box filter
is the reference's exact association ``((a + b) + (c + d)) * 0.25``
(its MXU pairing-matmul form sums the same two pairs), so levels are
bit-identical. Levels are kept as planar [3, h, w] float32 images: the
quad-block phase tables and ROW form were TPU gather layouts, and the
transmission fetch kernel (ops/tap_finish.py, kernel 4) reads texels
directly with the same clamp-to-edge footprint.

``sample_pyramid_lod`` is the plain oracle of the kernel's pyramid half:
a static contiguous ``level_set`` sums tent-weighted bilinear taps of the
two levels bracketing each pixel's lod (which equals the reference's
per-level ascending sum for small sets: the other levels' weights are
exact zeros). With no level set (per-pixel roughness, every level built)
the set is the whole pyramid: the tent weights of the two bracketing
levels are then 1 - frac and frac, the reference's lerp
``c0 + (c1 - c0) * frac`` (mipchain.py:677-683) up to one rounding of
the combine (~2.4e-7 at texel values below 4).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from transmission_renderer_tpu_torch.scene.textures import mip_levels_for_size


class MipPyramid(NamedTuple):
    levels: tuple  # per level: [3, h, w] float32, or None when not built
    widths: tuple
    heights: tuple

    @property
    def num_levels(self) -> int:
        return len(self.widths)


def pyramid_shapes(width: int, height: int) -> list[tuple[int, int]]:
    """(w, h) per level, floor(n/2) per step (Vulkan blit convention)."""
    shapes = [(width, height)]
    for _ in range(mip_levels_for_size(width, height) - 1):
        w, h = shapes[-1]
        shapes.append((max(w // 2, 1), max(h // 2, 1)))
    return shapes


def _downsample2x(img: torch.Tensor) -> torch.Tensor:
    """2x2 box downsample of [..., H, W]; odd trailing row/col dropped."""
    h, w = img.shape[-2:]
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    if h == 1:
        return (img[..., :, 0 : 2 * nw : 2] + img[..., :, 1 : 2 * nw : 2]) * 0.5
    if w == 1:
        return (img[..., 0 : 2 * nh : 2, :] + img[..., 1 : 2 * nh : 2, :]) * 0.5
    a = img[..., 0 : 2 * nh : 2, 0 : 2 * nw : 2]
    b = img[..., 0 : 2 * nh : 2, 1 : 2 * nw : 2]
    c = img[..., 1 : 2 * nh : 2, 0 : 2 * nw : 2]
    d = img[..., 1 : 2 * nh : 2, 1 : 2 * nw : 2]
    return ((a + b) + (c + d)) * 0.25


def build_pyramid(planes, level_set: tuple | None = None) -> MipPyramid:
    """(r, g, b) [H, W] planes -> pyramid; with a static ``level_set``
    (render/frame.py::refraction_level_set) the chain stops at the
    coarsest needed level and only levels in the set are kept."""
    img = torch.stack(tuple(planes))
    h, w = img.shape[-2:]
    shapes = pyramid_shapes(w, h)
    n_levels = len(shapes)
    max_needed = n_levels - 1 if level_set is None else min(max(level_set), n_levels - 1)
    levels = [img]
    for _ in range(max_needed):
        levels.append(_downsample2x(levels[-1]).contiguous())
    keep = []
    for k in range(n_levels):
        needed = (level_set is None or k in level_set) and k <= max_needed
        keep.append(levels[k].contiguous() if needed else None)
    return MipPyramid(
        levels=tuple(keep),
        widths=tuple(s[0] for s in shapes),
        heights=tuple(s[1] for s in shapes),
    )


def bilinear_clamp(level: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Clamp-to-edge bilinear tap of one [3, h, w] level -> [..., 3]."""
    _, h, w = level.shape
    x = uv[..., 0] * float(w) - 0.5
    y = uv[..., 1] * float(h) - 0.5
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = x0f.to(torch.int32)
    y0 = y0f.to(torch.int32)
    # below-zero footprints collapse onto texel 0 (both Vulkan taps clamp)
    fx = torch.where(x0 < 0, 0.0, fx)[..., None]
    fy = torch.where(y0 < 0, 0.0, fy)[..., None]
    x0 = torch.clamp(x0, 0, w - 1).long()
    y0 = torch.clamp(y0, 0, h - 1).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    t = level.permute(1, 2, 0)  # [h, w, 3]
    c00, c10, c01, c11 = t[y0, x0], t[y0, x1], t[y1, x0], t[y1, x1]
    top = c00 + (c10 - c00) * fx
    bot = c01 + (c11 - c01) * fx
    return top + (bot - top) * fy


def tent_weights(lod: torch.Tensor, lo: int, hi: int):
    """(l0, l1, w0, w1): the two levels bracketing the clamped lod and
    their tent weights (w1 = 0 when the lod sits on the set's top)."""
    lod = torch.clamp(lod, float(lo), float(hi))
    l0 = torch.floor(lod).to(torch.int32)
    l1 = torch.clamp(l0 + 1, max=hi)
    l0f = l0.to(torch.float32)
    w0 = torch.clamp(1.0 - torch.abs(lod - l0f), 0.0, 1.0)
    w1 = torch.clamp(1.0 - torch.abs(lod - (l0f + 1.0)), 0.0, 1.0)
    w1 = torch.where(l1 == l0, 0.0, w1)
    return l0, l1, w0, w1


def sample_pyramid_lod(pyr: MipPyramid, uv: torch.Tensor, lod: torch.Tensor,
                       level_set: tuple | None) -> torch.Tensor:
    """Trilinear clamp sample over a static contiguous level set, or with
    ``level_set`` None over the whole pyramid (every level built)
    -> [..., 3] (shader/src/lib.rs:135-138 framebuffer_sampler)."""
    if level_set is None:
        level_set = range(pyr.num_levels)
    lo, hi = min(level_set), max(level_set)
    if tuple(level_set) != tuple(range(lo, hi + 1)):
        raise ValueError("level_set must be contiguous")
    l0, l1, w0, w1 = tent_weights(lod, lo, hi)
    c0 = torch.zeros(uv.shape[:-1] + (3,), dtype=torch.float32, device=uv.device)
    c1 = torch.zeros_like(c0)
    for k in range(lo, hi + 1):
        ck = bilinear_clamp(pyr.levels[k], uv)
        c0 = torch.where((l0 == k)[..., None], ck, c0)
        c1 = torch.where((l1 == k)[..., None], ck, c1)
    return c0 * w0[..., None] + c1 * w1[..., None]
