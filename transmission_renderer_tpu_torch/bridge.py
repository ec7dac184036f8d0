"""Carry the JAX package's frame inputs into the port.

``from_jax_arrays`` takes the reference's Scene, DrawList, FrameParams,
Lights and SceneFlags whose arrays the caller has already turned into
NumPy (``jax.tree_util.tree_map(np.asarray, x)``) and returns the port's
NamedTuples of tensors on ``device``, so both packages compute on
identical inputs; ``vis_buffer`` and ``tile_bins`` do the same for a
VisibilityBuffer and materialised TileBins. Fields are read by name and
no JAX code of either package is imported. The bfloat16 atlas (an
``ml_dtypes`` array) crosses by bit pattern.
"""

from __future__ import annotations

import numpy as np
import torch

from transmission_renderer_tpu_torch.ops.raster import TileBins, VisibilityBuffer
from transmission_renderer_tpu_torch.pbr.lights import Lights
from transmission_renderer_tpu_torch.render.frame import (
    DrawList,
    FrameParams,
    SceneFlags,
)
from transmission_renderer_tpu_torch.scene.types import (
    MaterialsSoA,
    Scene,
    Similarity,
)
from transmission_renderer_tpu_torch.utils.platform import CARD, resolve_device


def to_tensor(a, device=CARD) -> torch.Tensor:
    """A NumPy array (bfloat16 included) -> tensor, values unchanged."""
    device = resolve_device(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def _convert(obj, cls, device):
    return cls(*(to_tensor(getattr(obj, f), device) for f in cls._fields))


def vis_buffer(vis, device=CARD) -> VisibilityBuffer:
    """The reference's VisibilityBuffer (arrays or NumPy) -> the port's."""
    return _convert(vis, VisibilityBuffer, device)


def tile_bins(bins, device=CARD) -> TileBins:
    """The reference's materialised TileBins (``bin_triangles(...,
    materialize=True)``) -> the port's, field by field."""
    device = resolve_device(device)
    fields = {f: to_tensor(getattr(bins, f), device) for f in TileBins._fields
              if f not in ("tier_demands", "tier_slots")}
    return TileBins(**fields)


def from_jax_arrays(scene, dl, params, lights, flags, device=CARD):
    """(Scene, DrawList, FrameParams, Lights, SceneFlags) of the port."""
    device = resolve_device(device)
    fields = {}
    for f in Scene._fields:
        v = getattr(scene, f)
        if f == "inst_transform":
            fields[f] = _convert(v, Similarity, device)
        elif f == "materials":
            fields[f] = _convert(v, MaterialsSoA, device)
        else:
            fields[f] = to_tensor(v, device)
    return (
        Scene(**fields),
        _convert(dl, DrawList, device),
        _convert(params, FrameParams, device),
        _convert(lights, Lights, device),
        SceneFlags(*(getattr(flags, f) for f in SceneFlags._fields)),
    )
