"""The traffic generator: one viewer's camera path from a mix's
parameters and the run's seed.

A mix is a JSON file of parameters. The viewer's target yaw sweeps
``yaw_range`` as a sine whose period (seconds of frames at ``dt``,
uniform in ``period_s``) and phase come from the seed; the camera
follows it through the rig's smoothing once a frame. The seed also draws
which frames of the window are checked against the plain reference.
The frames are a fixed sequence: frame k's inputs do not depend on how
fast the frames before it ran.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# independent streams of one run's seed
SCENE_STREAM, TRAFFIC_STREAM, CHECK_STREAM = 0, 1, 2


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


@dataclasses.dataclass(frozen=True)
class ViewerPath:
    dt: float
    yaw_lo: float
    yaw_hi: float
    period_frames: float
    phase: float
    rotate_model: bool
    ray_traced_shadows: bool
    warmup_frames: int
    checked: tuple  # frame indices of the window compared with the reference

    def target_yaw(self, k: int) -> float:
        """The viewer's target yaw at frame k (before the rig's update)."""
        s = 0.5 - 0.5 * math.cos(2.0 * math.pi * k / self.period_frames + self.phase)
        return self.yaw_lo + (self.yaw_hi - self.yaw_lo) * s


def make_path(mix: dict, seed: int) -> ViewerPath:
    r = rng(seed, TRAFFIC_STREAM)
    period_s = r.uniform(*mix["period_s"])
    phase = r.uniform(0.0, 2.0 * math.pi)
    c = rng(seed, CHECK_STREAM)
    checked = tuple(sorted(int(k) for k in c.choice(mix["check_within_frames"],
                                                      mix["checked_frames"], replace=False)))
    return ViewerPath(dt=mix["dt"], yaw_lo=mix["yaw_range"][0], yaw_hi=mix["yaw_range"][1],
                      period_frames=period_s / mix["dt"], phase=phase,
                      rotate_model=mix["rotate_model"],
                      ray_traced_shadows=mix["ray_traced_shadows"],
                      warmup_frames=mix["warmup_frames"], checked=checked)
