"""Split-sum GGX environment-BRDF LUT (NumPy).

Counterpart of ``transmission_renderer_tpu/utils/ggx_lut.py``. Like the
reference's, ``default_ggx_lut`` loads the reference asset's
``ggx_lut.png`` when the ``TRTPU_GGX_LUT`` environment variable names a
readable one (``load_ggx_lut_png``, through the port's PNG decoder: the
UNORM8 red and green channels / 255, rows as stored), and otherwise bakes
the table: the standard Karis split-sum integration (GGX importance
sampling, Smith height-correlated visibility, Hammersley points), flipped
on the roughness axis and quantised to UNORM8 to match the asset's
conventions. Either is box-reduced to the sampled size. The reference
also tries a fixed path of its own build environment after the variable;
the port does not, so set the variable to that asset for the same table.
"""

from __future__ import annotations

import functools
import os
import struct
import zlib

import numpy as np

from transmission_renderer_tpu_torch.utils.png import read_png


def _hammersley(n: int) -> np.ndarray:
    """[n, 2] low-discrepancy points (van der Corput base 2 in y)."""
    i = np.arange(n, dtype=np.uint32)
    bits = i.copy()
    bits = ((bits << 16) | (bits >> 16)) & 0xFFFFFFFF
    bits = ((bits & 0x55555555) << 1) | ((bits & 0xAAAAAAAA) >> 1)
    bits = ((bits & 0x33333333) << 2) | ((bits & 0xCCCCCCCC) >> 2)
    bits = ((bits & 0x0F0F0F0F) << 4) | ((bits & 0xF0F0F0F0) >> 4)
    bits = ((bits & 0x00FF00FF) << 8) | ((bits & 0xFF00FF00) >> 8)
    y = bits.astype(np.float64) * 2.3283064365386963e-10
    x = i.astype(np.float64) / n
    return np.stack([x, y], -1)


@functools.lru_cache(maxsize=4)
def compute_ggx_lut(size: int = 128, num_samples: int = 512) -> np.ndarray:
    """[size, size, 2] float32; axis 0 = perceptual roughness (v), axis 1 =
    NoV (u)."""
    xi = _hammersley(num_samples)
    nov = (np.arange(size, dtype=np.float64) + 0.5) / size
    rough = (np.arange(size, dtype=np.float64) + 0.5) / size
    nov_g, rough_g = np.meshgrid(nov, rough)
    a = rough_g**2  # perceptual -> actual roughness
    vx = np.sqrt(1.0 - nov_g**2)
    vz = nov_g
    scale = np.zeros_like(nov_g)
    bias = np.zeros_like(nov_g)
    for s in range(num_samples):
        u1, u2 = xi[s]
        phi = 2.0 * np.pi * u1
        cos_theta = np.sqrt((1.0 - u2) / (1.0 + (a**2 - 1.0) * u2))
        sin_theta = np.sqrt(np.maximum(1.0 - cos_theta**2, 0.0))
        hx = sin_theta * np.cos(phi)
        hz = cos_theta
        v_dot_h = vx * hx + vz * hz
        lz = 2 * v_dot_h * hz - vz  # l = 2 (v.h) h - v; only l.z is read
        nol = np.maximum(lz, 0.0)
        noh = np.maximum(hz, 0.0)
        voh = np.maximum(v_dot_h, 0.0)
        visible = nol > 0
        a2 = (a**2)
        ggx_v = nol * np.sqrt(nov_g**2 * (1 - a2) + a2)
        ggx_l = nov_g * np.sqrt(nol**2 * (1 - a2) + a2)
        vis = np.where(ggx_v + ggx_l > 0, 0.5 / np.maximum(ggx_v + ggx_l, 1e-12), 0.0)
        weight = np.where(visible & (noh > 0),
                          vis * 4.0 * voh * nol / np.maximum(noh, 1e-12), 0.0)
        fc = (1.0 - voh) ** 5
        scale += (1.0 - fc) * weight
        bias += fc * weight
    scale /= num_samples
    bias /= num_samples
    return np.stack([scale, bias], -1).astype(np.float32)


def load_ggx_lut_png(path: str) -> np.ndarray:
    """A ggx_lut.png as [S, S, 2] float32, rows as stored: the red and
    green UNORM8 channels / 255 (the reference uploads it linear and its
    shader reads .xy)."""
    return read_png(path)[..., :2].astype(np.float32) / 255.0


def _box_downsample(lut: np.ndarray, size: int) -> np.ndarray:
    """Integer-factor box average of an [S, S, 2] LUT down to [size,
    size, 2] (unchanged when size >= S); ValueError when size does not
    divide S."""
    s = lut.shape[0]
    if size >= s:
        return lut
    f = s // size
    if size * f != s:
        raise ValueError(f"LUT size {size} does not divide the source size {s}")
    return lut.reshape(size, f, size, f, lut.shape[-1]).mean(axis=(1, 3)).astype(np.float32)


@functools.lru_cache(maxsize=4)
def default_ggx_lut(size: int | None = 256) -> np.ndarray:
    """The LUT the renderer uses, box-reduced to ``size`` (None =
    native): the PNG that ``TRTPU_GGX_LUT`` names when it exists and
    reads (a file that does not read or reduce falls through, as in the
    reference), else the bake in the asset's orientation (roughness axis
    inverted, as the reference's ggx_lut.png stores it and its shader
    samples it) and UNORM8 quantisation."""
    path = os.environ.get("TRTPU_GGX_LUT")
    if path and os.path.exists(path):
        try:
            lut = load_ggx_lut_png(path)
            return _box_downsample(lut, size) if size else lut
        except (OSError, ValueError, IndexError, struct.error, zlib.error):
            pass
    lut = compute_ggx_lut()[::-1].copy()  # textbook -> asset orientation
    lut = np.round(lut * 255.0).astype(np.float32) / np.float32(255.0)
    return _box_downsample(lut, size) if size else lut
