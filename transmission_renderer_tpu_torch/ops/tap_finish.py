"""Material tap (kernel 2) and transmission fetch (kernel 4).

Counterpart of ``transmission_renderer_tpu/ops/tap_finish.py``
(sample_bundle_planes, transmission_fetch_planes). On the TPU these
kernels only finished rows that XLA had gathered; on Hopper each kernel
is the whole sampler, reading the atlas / pyramid / LUT itself:

* ``sample_bundle_planes`` launches ``csrc/tap_finish.cu`` — the
  explicit-LOD trilinear material tap -> 4 * Lmax bundle-channel planes;
* ``transmission_fetch_planes`` launches ``csrc/transmission_fetch.cu``
  — the tent-weighted pyramid taps of the refraction over a static level
  set (with no level set, per-pixel roughness, the whole pyramid), plus
  the GGX LUT tap -> (t_r, t_g, t_b, brdf_a, brdf_b).

For CPU tensors both take their plain versions (``*_plain``), which are
the port's sampler oracles in ops/texture.py and ops/mipchain.py.
"""

from __future__ import annotations

import ctypes

import torch

from transmission_renderer_tpu_torch import kernels
from transmission_renderer_tpu_torch.ops.mipchain import MipPyramid, sample_pyramid_lod
from transmission_renderer_tpu_torch.ops.texture import (
    class_mask,
    sample_bundle_rows,
    sample_lut_2ch,
)

# ---------------------------------------------------------------------------
# kernel 2: the material tap
# ---------------------------------------------------------------------------

def sample_bundle_planes_plain(quads, rows, uv, lod, wrap_mode, classes) -> list:
    s = sample_bundle_rows(quads, rows, uv, lod, wrap_mode, classes)
    return [s[:, layer, c] for layer in range(s.shape[1]) for c in range(4)]


def _sample_bundle_planes_cuda(quads, rows, uv, lod, wrap_mode, classes) -> list:
    dev = quads.device
    m = uv.shape[0]
    l_max = max(classes)
    kernels.check(quads, "atlas texels", torch.bfloat16)
    kernels.check(rows, "meta rows", torch.int32, device=dev)
    if rows.dim() != 2 or rows.shape[0] != m or rows.shape[1] < 18:
        raise ValueError(f"meta rows: shape {tuple(rows.shape)}, expected [{m}, >=18]")
    kernels.check(uv, "uv", torch.float32, (m, 2), device=dev)
    kernels.check(lod, "lod", torch.float32, (m,), device=dev)
    out = torch.empty((4 * l_max, m), dtype=torch.float32, device=dev)
    fn = kernels.entry("trt_tap_finish", [
        kernels.VOIDP, kernels.INT, kernels.VOIDP, kernels.INT, kernels.VOIDP,
        kernels.VOIDP, kernels.INT, kernels.INT, kernels.INT, kernels.INT,
        kernels.VOIDP, kernels.VOIDP,
    ])
    kernels.launch(
        TAP_KERNEL, fn, kernels.ptr(quads), quads.shape[-1], kernels.ptr(rows),
        rows.shape[1], kernels.ptr(uv), kernels.ptr(lod), m, int(wrap_mode),
        class_mask(classes), l_max, kernels.ptr(out),
    )
    return list(out)


TAP_KERNEL = kernels.KernelHandle(
    "tap_finish", "transmission_renderer_tpu_torch/csrc/tap_finish.cu",
    "transmission_renderer_tpu/ops/tap_finish.py:97",
    cuda=_sample_bundle_planes_cuda, plain=sample_bundle_planes_plain,
)


def sample_bundle_planes(
    quads: torch.Tensor,  # [R, row_elems] bfloat16 atlas
    rows: torch.Tensor,  # [M, >= META_COLS] int32 per-pixel meta rows
    uv: torch.Tensor,  # [M, 2]
    lod: torch.Tensor,  # [M]
    wrap_mode: int,
    classes: tuple,  # static layer-class set (texture.atlas_classes)
) -> list:
    """Explicit-LOD trilinear sample of all bundle layers -> 4 * Lmax
    [M] float32 planes ordered (layer, channel)."""
    return TAP_KERNEL(uv.is_cuda, quads, rows, uv, lod, wrap_mode, tuple(classes))


# ---------------------------------------------------------------------------
# kernel 4: the transmission fetch
# ---------------------------------------------------------------------------

def transmission_fetch_planes_plain(pyramid, level_set, uv_x, uv_y, lod,
                                    nov, rough, lut) -> tuple:
    uv = torch.stack([uv_x, uv_y], dim=-1)
    t = sample_pyramid_lod(pyramid, uv, lod, level_set)
    b = sample_lut_2ch(lut, nov, rough)
    return (t[..., 0], t[..., 1], t[..., 2], b[..., 0], b[..., 1])


def _transmission_fetch_cuda(pyramid, level_set, uv_x, uv_y, lod, nov,
                             rough, lut) -> tuple:
    dev = uv_x.device
    m = uv_x.shape[0]
    lo, hi = min(level_set), max(level_set)
    if tuple(level_set) != tuple(range(lo, hi + 1)) or hi - lo + 1 > 16:
        raise ValueError(f"level_set {level_set}: need <= 16 contiguous levels")
    for name, t in (("uv_x", uv_x), ("uv_y", uv_y), ("lod", lod),
                    ("nov", nov), ("rough", rough)):
        kernels.check(t, name, torch.float32, (m,), device=dev)
    s = lut.shape[0]
    kernels.check(lut, "ggx lut", torch.float32, (s, s, 2), device=dev)
    levels = [pyramid.levels[k] for k in range(lo, hi + 1)]
    for k, lv in zip(range(lo, hi + 1), levels):
        kernels.check(lv, f"pyramid level {k}", torch.float32,
                      (3, pyramid.heights[k], pyramid.widths[k]), device=dev)
    n = hi - lo + 1
    ptrs = (ctypes.c_void_p * n)(*(lv.data_ptr() for lv in levels))
    widths = (ctypes.c_int * n)(*pyramid.widths[lo : hi + 1])
    heights = (ctypes.c_int * n)(*pyramid.heights[lo : hi + 1])
    out = torch.empty((5, m), dtype=torch.float32, device=dev)
    fn = kernels.entry("trt_transmission_fetch", [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), kernels.INT, kernels.INT,
        kernels.VOIDP, kernels.VOIDP, kernels.VOIDP, kernels.VOIDP,
        kernels.VOIDP, kernels.INT, kernels.VOIDP, kernels.INT,
        kernels.VOIDP, kernels.VOIDP,
    ])
    kernels.launch(
        FETCH_KERNEL, fn, ptrs, widths, heights, lo, hi, kernels.ptr(uv_x),
        kernels.ptr(uv_y), kernels.ptr(lod), kernels.ptr(nov),
        kernels.ptr(rough), m, kernels.ptr(lut), s, kernels.ptr(out),
    )
    return tuple(out)


FETCH_KERNEL = kernels.KernelHandle(
    "transmission_fetch",
    "transmission_renderer_tpu_torch/csrc/transmission_fetch.cu",
    "transmission_renderer_tpu/ops/tap_finish.py:265",
    cuda=_transmission_fetch_cuda, plain=transmission_fetch_planes_plain,
)


def transmission_fetch_planes(
    pyramid: MipPyramid,
    level_set: tuple | None,  # static contiguous level set; None: every level
    uv_x: torch.Tensor,  # [M] refraction exit point, screen uv
    uv_y: torch.Tensor,
    lod: torch.Tensor,  # [M] framebuffer lod
    nov: torch.Tensor,  # [M] unclamped N.V (LUT u)
    rough: torch.Tensor,  # [M] perceptual roughness (LUT v)
    lut: torch.Tensor,  # [S, S, 2] GGX split-sum LUT
) -> tuple:
    """(transmitted r, g, b, brdf_a, brdf_b) [M] planes."""
    if level_set is None:
        level_set = range(pyramid.num_levels)
    return FETCH_KERNEL(uv_x.is_cuda, pyramid, tuple(level_set), uv_x, uv_y,
                        lod, nov, rough, lut)
