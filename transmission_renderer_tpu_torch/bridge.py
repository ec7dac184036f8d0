"""Carry the JAX package's frame inputs into the port.

``from_jax_arrays`` takes the reference's Scene, DrawList, FrameParams,
Lights and SceneFlags whose arrays the caller has already turned into
NumPy (``jax.tree_util.tree_map(np.asarray, x)``) and returns the port's
NamedTuples of tensors on ``device``, so both packages compute on
identical inputs. It reads fields by name and imports no JAX code of
either package. The bfloat16 atlas (an ``ml_dtypes`` array) crosses by
bit pattern.
"""

from __future__ import annotations

import numpy as np
import torch

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


def to_tensor(a, device="cpu") -> torch.Tensor:
    """A NumPy array (bfloat16 included) -> tensor, values unchanged."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def _convert(obj, cls, device):
    return cls(*(to_tensor(getattr(obj, f), device) for f in cls._fields))


def from_jax_arrays(scene, dl, params, lights, flags, device="cpu"):
    """(Scene, DrawList, FrameParams, Lights, SceneFlags) of the port."""
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
