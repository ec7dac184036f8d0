"""Light table — struct-of-arrays mirror of the reference's ``Light``.

Counterpart of ``transmission_renderer_tpu/pbr/lights.py`` (Lights,
point_light, spot_light, pack_lights, spotlight_factor).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from transmission_renderer_tpu_torch.utils.platform import CARD, resolve_device


class Lights(NamedTuple):
    """[L]-batched light table (shared-structs/src/lib.rs:74-139)."""

    position: torch.Tensor  # [L, 3]
    colour_emission: torch.Tensor  # [L, 3]
    falloff_distance_sq: torch.Tensor  # [L]
    spot_epsilon: torch.Tensor  # [L]  cos(inner) - cos(outer)
    spot_direction: torch.Tensor  # [L, 3]
    spot_outer_angle: torch.Tensor  # [L]

    @property
    def num(self) -> int:
        return self.position.shape[0]

    def is_a_spotlight(self) -> torch.Tensor:
        return self.spot_outer_angle != 0.0


def point_light(position, colour, intensity: float) -> dict:
    """shared-structs/src/lib.rs:94-103."""
    return dict(
        position=np.asarray(position, np.float32),
        colour_emission=np.asarray(colour, np.float32) * intensity,
        falloff_distance_sq=np.float32(intensity / 0.05),
        spot_epsilon=np.float32(0.0),
        spot_direction=np.zeros(3, np.float32),
        spot_outer_angle=np.float32(0.0),
    )


def spot_light(position, colour, intensity: float, direction, inner_angle_rad: float,
               outer_angle_rad: float) -> dict:
    """shared-structs/src/lib.rs:105-123; the cone's epsilon in float64,
    then float32, as the reference."""
    return dict(
        position=np.asarray(position, np.float32),
        colour_emission=np.asarray(colour, np.float32) * intensity,
        falloff_distance_sq=np.float32(intensity / 0.05),
        spot_epsilon=np.float32(np.cos(inner_angle_rad) - np.cos(outer_angle_rad)),
        spot_direction=np.asarray(direction, np.float32),
        spot_outer_angle=np.float32(outer_angle_rad),
    )


def pack_lights(lights: list[dict], device=CARD) -> Lights:
    """Stack point_light() / spot_light() dicts into a Lights table on ``device``."""
    device = resolve_device(device)
    if not lights:
        # one zero-emission dummy whose falloff 0 never passes assignment
        lights = [point_light([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 0.0)]
        lights[0]["falloff_distance_sq"] = np.float32(0.0)

    def col(key):
        v = np.stack([np.asarray(li[key], np.float32) for li in lights])
        return torch.from_numpy(v).to(device)

    return Lights(*(col(k) for k in Lights._fields))


def spotlight_factor(direction_to_light, spot_direction, spot_outer_angle,
                     spot_epsilon) -> torch.Tensor:
    """Smooth spot cone falloff (shared-structs/src/lib.rs:129-138);
    unclamped above 1 inside the inner cone, as the reference."""
    d = -direction_to_light * spot_direction
    theta = (d[..., 0] + d[..., 1]) + d[..., 2]
    return torch.clamp((theta - torch.cos(spot_outer_angle)) / spot_epsilon, min=0.0)
