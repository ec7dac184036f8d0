"""Light table — struct-of-arrays mirror of the reference's ``Light``.

Counterpart of ``transmission_renderer_tpu/pbr/lights.py`` (Lights,
point_light, pack_lights).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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


def pack_lights(lights: list[dict], device="cpu") -> Lights:
    """Stack point_light() dicts into a Lights table on ``device``."""
    if not lights:
        # one zero-emission dummy whose falloff 0 never passes assignment
        lights = [point_light([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 0.0)]
        lights[0]["falloff_distance_sq"] = np.float32(0.0)

    def col(key):
        v = np.stack([np.asarray(li[key], np.float32) for li in lights])
        return torch.from_numpy(v).to(device)

    return Lights(*(col(k) for k in Lights._fields))
