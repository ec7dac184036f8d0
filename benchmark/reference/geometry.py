"""Camera, instance transforms and the vertex stage of the plain reference.

Host math in NumPy float32 and tensor math in plain PyTorch, in the
arithmetic order the renderer's equations are written in (each product
and sum rounded to float32 on its own; the similarity transform's
multiply-add rounded once, as a fused multiply-add). Imports nothing of
the program under test.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


# ---------------------------------------------------------------------------
# camera (reversed-Z projection, look-at view, smoothed rig, sun)
# ---------------------------------------------------------------------------

def perspective_reversed(width: int, height: int, vertical_fov: float, z_near: float,
                         z_far: float) -> np.ndarray:
    """Reversed-Z Vulkan-convention projection, row-major for clip = M @ [p, 1]."""
    focal = 1.0 / math.tan(vertical_fov / 2.0)
    a = z_near / (z_far - z_near)
    m = np.zeros((4, 4), np.float32)
    m[0, 0] = focal / (width / height)
    m[1, 1] = -focal
    m[2, 2] = a
    m[2, 3] = z_far * a
    m[3, 2] = -1.0
    return m


def look_at_rh(eye, center, up) -> np.ndarray:
    eye = np.asarray(eye, np.float32)
    f = np.asarray(center, np.float32) - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, np.float32))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float32)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3] = -s @ eye
    m[1, 3] = -u @ eye
    m[2, 3] = f @ eye
    return m


def sun_normal(pitch: float, yaw: float) -> np.ndarray:
    return np.array([math.cos(pitch) * math.sin(yaw), math.sin(pitch),
                     math.cos(pitch) * math.cos(yaw)], np.float32)


@dataclasses.dataclass
class Rig:
    """A smoothed yaw/pitch camera: each update moves position, yaw and
    pitch toward their targets by 1 - exp(-ln 2 dt / (half_time / 4))."""

    position: np.ndarray
    yaw: float
    pitch: float
    target_position: np.ndarray
    target_yaw: float
    target_pitch: float
    sun_pitch: float
    sun_yaw: float
    position_smoothing: float = 0.5
    rotation_smoothing: float = 0.25

    def update(self, dt: float) -> None:
        def factor(half_time):
            return 1.0 - math.exp(-math.log(2.0) * dt / (half_time / 4.0))

        pf, rf = factor(self.position_smoothing), factor(self.rotation_smoothing)
        self.position = (self.position + (self.target_position - self.position) * pf
                         ).astype(np.float32)
        self.yaw += (self.target_yaw - self.yaw) * rf
        self.pitch += (self.target_pitch - self.pitch) * rf

    def forward(self) -> np.ndarray:
        cp, sp = math.cos(self.pitch), math.sin(self.pitch)
        cy, sy = math.cos(self.yaw), math.sin(self.yaw)
        return np.array([-sy * cp, sp, -cy * cp], np.float32)

    def view_matrix(self) -> np.ndarray:
        return look_at_rh(self.position, self.position + self.forward(), [0, 1, 0])

    def sun_dir(self) -> np.ndarray:
        return sun_normal(self.sun_pitch, self.sun_yaw)


# ---------------------------------------------------------------------------
# quaternions and similarity transforms (xyzw)
# ---------------------------------------------------------------------------

def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a * b."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw,
                        aw * bw - ax * bx - ay * by - az * bz], dim=-1)


def quat_y(angle: float) -> np.ndarray:
    return np.array([0.0, np.sin(angle / 2.0), 0.0, np.cos(angle / 2.0)], np.float32)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    t = 2.0 * _cross(q[..., :3], v)
    return v + q[..., 3:4] * t + _cross(q[..., :3], t)


def similarity_apply(translation, scale, rotation, v) -> torch.Tensor:
    """translation + scale * (rotation * v), the multiply-add rounded once
    (the float32 product is exact in float64)."""
    r = quat_rotate(rotation, v)
    f64 = torch.float64
    return (scale[..., None].to(f64) * r.to(f64) + translation.to(f64)).to(torch.float32)


def mat_rows(points: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """[N, 4] @ mat.T with each row's dot product summed (p0 + p1) + (p2 + p3)."""
    p = points[:, :, None] * mat.T[None]
    return (p[:, 0] + p[:, 1]) + (p[:, 2] + p[:, 3])


# ---------------------------------------------------------------------------
# the draw list and the vertex stage
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Geometry:
    """Per-instance expanded geometry (instance order, then primitive
    order): triangle t of the frame is row t of every per-triangle array."""

    obj_pos: torch.Tensor  # [VV, 3] object space
    obj_nrm: torch.Tensor  # [VV, 3]
    uvs: torch.Tensor  # [VV, 2]
    vtx_inst: torch.Tensor  # [VV] int64
    tri_vtx: torch.Tensor  # [TT, 3] int64 into the expanded vertices
    tri_inst: torch.Tensor  # [TT] int64
    tri_bucket: torch.Tensor  # [TT] int64
    tri_material: torch.Tensor  # [TT] int64
    translation: torch.Tensor  # [I, 3]
    scale: torch.Tensor  # [I]
    rotation: torch.Tensor  # [I, 4] as built (the frame turns rows of it)


def expand(scene, device) -> Geometry:
    """Each instance's primitive, its vertices copied per instance."""
    pos, nrm, uv, vi, tv, ti, tb, tm = [], [], [], [], [], [], [], []
    offset = 0
    for k, inst in enumerate(scene.instances):
        p = scene.primitives[inst.primitive]
        pos.append(p.positions)
        nrm.append(p.normals)
        uv.append(p.uvs)
        vi.append(np.full(len(p.positions), k))
        tv.append(p.indices.astype(np.int64) + offset)
        n = len(p.indices)
        ti.append(np.full(n, k))
        tb.append(np.full(n, p.bucket))
        tm.append(np.full(n, inst.material))
        offset += len(p.positions)

    def t(parts, dtype):
        return torch.from_numpy(np.concatenate(parts).astype(dtype)).to(device)

    return Geometry(
        obj_pos=t(pos, np.float32), obj_nrm=t(nrm, np.float32), uvs=t(uv, np.float32),
        vtx_inst=t(vi, np.int64), tri_vtx=t(tv, np.int64), tri_inst=t(ti, np.int64),
        tri_bucket=t(tb, np.int64), tri_material=t(tm, np.int64),
        translation=torch.tensor(np.array([i.translation for i in scene.instances],
                                          np.float32), device=device),
        scale=torch.tensor(np.array([i.scale for i in scene.instances], np.float32),
                           device=device),
        rotation=torch.tensor(np.array([i.rotation for i in scene.instances], np.float32),
                              device=device),
    )


def vertex_stage(geo: Geometry, rotation: torch.Tensor, proj_view: torch.Tensor):
    """-> (world positions, world normals, clip positions) of every
    expanded vertex under the instances' transforms (``rotation`` [I, 4])."""
    vi = geo.vtx_inst
    q = rotation[vi]
    world = similarity_apply(geo.translation[vi], geo.scale[vi], q, geo.obj_pos)
    normal = quat_rotate(q, geo.obj_nrm)
    clip = mat_rows(torch.cat([world, torch.ones_like(world[:, :1])], dim=-1), proj_view)
    return world, normal, clip
