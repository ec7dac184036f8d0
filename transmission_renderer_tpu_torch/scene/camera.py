"""Camera: reversed-Z projection, look-at view, sun direction, camera rig.

Counterpart of ``transmission_renderer_tpu/scene/camera.py``
(perspective_matrix_reversed, look_at_rh, sun_normal, Camera, CameraRig).
Host NumPy math, copied so the port needs no JAX package import (the
reference's ``scene`` package imports ``jax.numpy``), the rig's
controls and smoothing (move_relative, rotate, update_sun, update)
included.
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
    """Smoothed WASD/mouse camera, approximating dolly's
    Position+YawPitch+Smooth rig (src/main.rs:514-518) with exponential
    position/rotation smoothing, and the arrow-key sun controller with
    velocity damping (src/main.rs:1198-1228)."""

    camera: Camera = dataclasses.field(default_factory=Camera)
    target_position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 3.0, 1.0], np.float32)
    )
    target_yaw: float = 0.0
    target_pitch: float = math.radians(-15.0)
    position_smoothing: float = 0.5
    rotation_smoothing: float = 0.25
    sun_pitch: float = 1.1  # src/main.rs:531-534
    sun_yaw: float = 4.8
    sun_velocity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(2, np.float32)
    )

    def move_relative(self, forwards: float, right: float, up: float, speed: float = 3.0):
        f = self.camera.forward()
        r = np.cross(f, np.array([0.0, 1.0, 0.0], np.float32))
        r /= max(np.linalg.norm(r), 1e-8)
        self.target_position = (
            self.target_position + (f * forwards + r * right) * speed
        ).astype(np.float32)
        self.target_position[1] += up * speed

    def rotate(self, d_yaw: float, d_pitch: float):
        self.target_yaw += d_yaw
        self.target_pitch = float(
            np.clip(self.target_pitch + d_pitch, -math.pi / 2 + 1e-3, math.pi / 2 - 1e-3)
        )

    def update_sun(self, up: bool, down: bool, cw: bool, ccw: bool, delta_time: float):
        """Arrow-key sun control with acceleration and damping
        (src/main.rs:1198-1228)."""
        acceleration = 0.05
        max_velocity = 0.05
        v = self.sun_velocity.copy()
        if up:
            v[1] += acceleration
        if down:
            v[1] -= acceleration
        if cw:
            v[0] += acceleration
        if ccw:
            v[0] -= acceleration
        magnitude = float(np.linalg.norm(v))
        if magnitude > max_velocity:
            v *= max_velocity / magnitude
        self.sun_yaw -= float(v[0])
        self.sun_pitch = float(np.clip(self.sun_pitch + v[1], 0.0, math.pi / 2))
        self.sun_velocity = v * 0.95

    def update(self, delta_time: float = 1.0 / 60.0):
        """Exponential smoothing toward the targets, as dolly's Smooth
        rig part: lerp factor 1 - exp(-ln(2) dt / (half_time / 4))."""
        def factor(half_time):
            if half_time <= 0.0:
                return 1.0
            return 1.0 - math.exp(-math.log(2.0) * delta_time / (half_time / 4.0))

        pf = factor(self.position_smoothing)
        rf = factor(self.rotation_smoothing)
        self.camera.position = (
            self.camera.position + (self.target_position - self.camera.position) * pf
        ).astype(np.float32)
        self.camera.yaw += (self.target_yaw - self.camera.yaw) * rf
        self.camera.pitch += (self.target_pitch - self.camera.pitch) * rf

    def sun_dir(self) -> np.ndarray:
        return sun_normal(self.sun_pitch, self.sun_yaw)
