"""Lottes tonemapper on channel planes, and on interleaved channels.

Counterpart of ``transmission_renderer_tpu/pbr/tonemap.py``
(LottesParams, bake_lottes_params, lottes_tonemap_planes,
lottes_tonemap): the same
constraint fit for b and c, evaluated in float64 on the host and stored
as float32, and the same per-channel op order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class LottesParams(NamedTuple):
    contrast: float = 1.35
    shoulder: float = 0.99
    max_luminance: float = 25.0
    grey_point_in: float = 0.18
    grey_point_out: float = 0.18
    crosstalk: float = 10.0
    saturation: float = 1.0
    cross_saturation: float = 1.33


class BakedLottesParams(NamedTuple):
    """ABI mirror of shader/src/tonemapping.rs:28-38 (float32 values)."""

    a: np.float32
    b: np.float32
    c: np.float32
    d: np.float32
    crosstalk: np.float32
    saturation: np.float32
    cross_saturation: np.float32


def bake_lottes_params(params: LottesParams = LottesParams()) -> BakedLottesParams:
    """Solve b, c so that curve(grey_in) = grey_out and
    curve(max_luminance) = 1, with curve(x) = x^a / (x^(a d) b + c)."""
    a = params.contrast
    d = params.shoulder
    gi, go = params.grey_point_in, params.grey_point_out
    lm = params.max_luminance
    gi_a, gi_ad = gi**a, gi ** (a * d)
    lm_a, lm_ad = lm**a, lm ** (a * d)
    denom = (lm_ad - gi_ad) * go
    b = (-gi_a + lm_a * go) / denom
    c = (lm_ad * gi_a - lm_a * gi_ad * go) / denom
    f = np.float32
    return BakedLottesParams(
        a=f(a), b=f(b), c=f(c), d=f(d), crosstalk=f(params.crosstalk),
        saturation=f(params.saturation),
        cross_saturation=f(params.cross_saturation),
    )


def _powf(x: torch.Tensor, e) -> torch.Tensor:
    """float32 x ** e, correctly rounded: evaluated in float64 and rounded
    once, which matches a correctly rounded libm powf (the reference's
    CPU pow) where float32 vector pow would drift by an ulp."""
    return (x.to(torch.float64) ** float(e)).to(torch.float32)


def _tonemap_inner(x: torch.Tensor, p: BakedLottesParams) -> torch.Tensor:
    """z / (z^d * b + c) (shader/src/tonemapping.rs:10-13)."""
    z = _powf(x, p.a)
    return z / (_powf(z, p.d) * float(p.b) + float(p.c))


def lottes_tonemap_planes(planes: tuple, p: BakedLottesParams) -> tuple:
    """Max-channel ratio-preserving Lottes tonemap
    (shader/src/tonemapping.rs:15-25) over (r, g, b) planes -> planes in
    [0, 1]. Negative shading noise is clamped to 0 first."""
    r, g, b = (torch.clamp(c, min=0.0) for c in planes)
    max_c = torch.maximum(torch.maximum(r, g), b)
    safe_max = torch.clamp(max_c, min=1e-30)
    tonemapped_max = _tonemap_inner(max_c, p)
    crosstalk_t = _powf(tonemapped_max, p.crosstalk)
    sat = float(np.float32(p.saturation) / np.float32(p.cross_saturation))

    def chan(c):
        ratio = c / safe_max
        ratio = _powf(ratio, sat)
        ratio = ratio + (1.0 - ratio) * crosstalk_t
        ratio = _powf(ratio, p.cross_saturation)
        return torch.clamp(ratio * tonemapped_max, 0.0, 1.0)

    return (chan(r), chan(g), chan(b))


def lottes_tonemap(colour: torch.Tensor, p: BakedLottesParams) -> torch.Tensor:
    """``lottes_tonemap_planes`` on interleaved [..., 3] linear HDR ->
    [..., 3] in [0, 1] (the reference's interleaved form)."""
    return torch.stack(lottes_tonemap_planes(tuple(colour.unbind(-1)), p), dim=-1)
