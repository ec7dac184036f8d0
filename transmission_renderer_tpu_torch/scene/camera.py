"""Camera: reversed-Z projection, look-at view, sun direction, camera rig.

Counterpart of ``transmission_renderer_tpu/scene/camera.py``
(perspective_matrix_reversed, look_at_rh, sun_normal, Camera, CameraRig).
Host NumPy math, copied so the port needs no JAX package import (the
reference's ``scene`` package imports ``jax.numpy``). The interactive
rig controls (move/rotate/smoothing) are not needed by the port's frame.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def perspective_matrix_reversed(
    width: int, height: int, vertical_fov: float = math.radians(59.0),
    z_near: float = 0.01, z_far: float = 500.0,
) -> np.ndarray:
    """Reversed-Z Vulkan-convention projection (src/main.rs:39-54),
    row-major for ``clip = M @ [p, 1]``."""
    aspect_ratio = width / height
    focal_length = 1.0 / math.tan(vertical_fov / 2.0)
    a = z_near / (z_far - z_near)
    b = z_far * a
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = focal_length / aspect_ratio
    m[1, 1] = -focal_length
    m[2, 2] = a
    m[2, 3] = b
    m[3, 2] = -1.0
    return m


def look_at_rh(eye, center, up) -> np.ndarray:
    """Right-handed look-at view matrix (glam Mat4::look_at_rh)."""
    eye = np.asarray(eye, np.float32)
    f = np.asarray(center, np.float32) - eye
    f = f / np.linalg.norm(f)
    up = np.asarray(up, np.float32)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -s @ eye
    m[1, 3] = -u @ eye
    m[2, 3] = f @ eye
    return m


def sun_normal(pitch: float, yaw: float) -> np.ndarray:
    """Unit vector towards the sun (src/main.rs:2715-2722)."""
    return np.array(
        [
            math.cos(pitch) * math.sin(yaw),
            math.sin(pitch),
            math.cos(pitch) * math.cos(yaw),
        ],
        np.float32,
    )


@dataclasses.dataclass
class Camera:
    """Static camera pose (src/main.rs:514-518 start pose by default)."""

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 3.0, 1.0], np.float32)
    )
    yaw: float = 0.0
    pitch: float = math.radians(-15.0)

    def forward(self) -> np.ndarray:
        cp, sp = math.cos(self.pitch), math.sin(self.pitch)
        cy, sy = math.cos(self.yaw), math.sin(self.yaw)
        return np.array([-sy * cp, sp, -cy * cp], np.float32)

    def view_matrix(self) -> np.ndarray:
        return look_at_rh(self.position, self.position + self.forward(), [0, 1, 0])


@dataclasses.dataclass
class CameraRig:
    """Camera plus the sun controller's pitch/yaw (src/main.rs:531-534)."""

    camera: Camera = dataclasses.field(default_factory=Camera)
    sun_pitch: float = 1.1
    sun_yaw: float = 4.8

    def sun_dir(self) -> np.ndarray:
        return sun_normal(self.sun_pitch, self.sun_yaw)
