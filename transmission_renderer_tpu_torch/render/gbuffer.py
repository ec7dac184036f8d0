"""The G-buffer record.

Counterpart of ``transmission_renderer_tpu/render/gbuffer.py::GBuffer``
(the field set only; the reference's gather-based interpolation there
belongs to the pure raster path, which is later work — the port's
G-buffer comes from the raster kernel, ops/raster_gbuf.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GBuffer(NamedTuple):
    valid: torch.Tensor  # [..] bool
    depth: torch.Tensor  # [..] f32 (reversed-Z)
    position: torch.Tensor  # [.., 3] world space
    normal: torch.Tensor  # [.., 3] interpolated, unnormalised
    uv: torch.Tensor  # [.., 2]
    duv_dx: torch.Tensor  # [.., 2]
    duv_dy: torch.Tensor  # [.., 2]
    dpos_dx: torch.Tensor  # [.., 3]
    dpos_dy: torch.Tensor  # [.., 3]
    material_id: torch.Tensor  # [..] int32
    model_scale: torch.Tensor  # [..] f32
    tri_id: torch.Tensor  # [..] int32
