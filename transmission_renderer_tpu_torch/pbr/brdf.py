"""BRDF constants and Beer's-law volume attenuation.

Counterpart of ``transmission_renderer_tpu/pbr/brdf.py``: the constants
the shade kernel uses (F32_EPSILON, _FRAC_1_PI) and
``apply_volume_attenuation``, the one function of the reference's BRDF
library the transmission combine tail calls
(``render/shading.py:1029``). The rest of the library is the XLA shading
path, which the port replaces by the fused shade kernel's plain version.
"""

from __future__ import annotations

import torch

# f32::EPSILON — shading dot products clamp to this (glam-pbr lib.rs:95)
F32_EPSILON = 1.1920929e-07
_PI = 3.14159265358979323846
_FRAC_1_PI = 1.0 / _PI


def apply_volume_attenuation(
    transmitted_light: torch.Tensor,  # [..., 3]
    transmission_distance: torch.Tensor,  # [...]
    attenuation_distance: torch.Tensor,  # [...]
    attenuation_colour: torch.Tensor,  # [..., 3]
) -> torch.Tensor:
    """Beer's-law attenuation (glam-pbr/src/lib.rs:275-290);
    ``attenuation_distance == inf`` means no attenuation."""
    coefficient = -torch.log(attenuation_colour) / attenuation_distance[..., None]
    transmittance = torch.exp(-coefficient * transmission_distance[..., None])
    no_attenuation = torch.isinf(attenuation_distance)[..., None]
    return torch.where(
        no_attenuation, transmitted_light, transmittance * transmitted_light
    )
