"""Scene data model on tensors: quaternion and ``Similarity`` math, the
material table and the frozen ``Scene``.

Counterpart of ``transmission_renderer_tpu/scene/types.py`` (quat_mul,
quat_rotate, quat_from_rotation_y, quat_from_axis_angle, Similarity,
similarity_identity, similarity_apply, similarity_mul,
similarity_to_mat4, MaterialsSoA, default_material, pack_materials,
Scene). Same fields, same arithmetic order; arrays are ``torch.Tensor``
and ``to_device`` moves a whole NamedTuple tree.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from transmission_renderer_tpu_torch.utils.platform import CARD, resolve_device


# --------------------------------------------------------------------------
# Quaternion helpers (xyzw layout, matching glam)
# --------------------------------------------------------------------------

def quat_identity() -> np.ndarray:
    return np.array([0.0, 0.0, 0.0, 1.0], np.float32)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a * b of quaternions [..., 4] (xyzw), the
    reference's term order."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_from_rotation_y(angle: float) -> np.ndarray:
    """Unit quaternion (xyzw) of a rotation by ``angle`` about +y."""
    return np.array([0.0, np.sin(angle / 2.0), 0.0, np.cos(angle / 2.0)], np.float32)


def quat_from_axis_angle(axis, angle: float) -> np.ndarray:
    """Unit quaternion (xyzw) of a rotation by ``angle`` about ``axis``."""
    axis = np.asarray(axis, np.float32)
    axis = axis / np.linalg.norm(axis)
    s = np.sin(angle / 2.0)
    return np.array([*(axis * s), np.cos(angle / 2.0)], np.float32)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.cross term order: (a1 b2 - a2 b1, a2 b0 - a0 b2, a0 b1 - a1 b0)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by quaternions q [..., 4] (xyzw)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


# --------------------------------------------------------------------------
# Similarity transforms (shared-structs/src/lib.rs:196-241)
# --------------------------------------------------------------------------

class Similarity(NamedTuple):
    """translation + uniform scale + rotation; batchable ([..., ] leading)."""

    translation: torch.Tensor  # [..., 3]
    scale: torch.Tensor  # [...]
    rotation: torch.Tensor  # [..., 4] xyzw


def similarity_apply(s: Similarity, v: torch.Tensor) -> torch.Tensor:
    """s * vector = translation + scale * (rotation * v), as one fused
    multiply-add, as the reference's compiler contracts it (the float32
    product is exact in float64, so one float64 add and one rounding give
    the fma): bit-equal world positions keep degenerate triangles'
    backface decisions, and with them the bins, the reference's."""
    f64 = torch.float64
    r = quat_rotate(s.rotation, v)
    return (s.scale[..., None].to(f64) * r.to(f64) + s.translation.to(f64)).to(r.dtype)


def similarity_identity(batch: tuple = (), device=CARD) -> Similarity:
    """The identity transform, batched over ``batch``."""
    device = resolve_device(device)
    return Similarity(
        translation=torch.zeros(batch + (3,), dtype=torch.float32, device=device),
        scale=torch.ones(batch, dtype=torch.float32, device=device),
        rotation=torch.tensor([0.0, 0.0, 0.0, 1.0], device=device).expand(batch + (4,)),
    )


def similarity_mul(a: Similarity, b: Similarity) -> Similarity:
    """Group product a * b (shared-structs/src/lib.rs:223-233)."""
    return Similarity(
        translation=similarity_apply(a, b.translation),
        scale=a.scale * b.scale,
        rotation=quat_mul(a.rotation, b.rotation),
    )


def similarity_to_mat4(s: Similarity) -> torch.Tensor:
    """As [..., 4, 4] matrices, M @ [p, 1] convention (shared-structs
    lib.rs:216-221)."""
    q = s.rotation
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rot = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)
    m = torch.zeros(s.scale.shape + (4, 4), dtype=torch.float32, device=q.device)
    m[..., :3, :3] = rot * s.scale[..., None, None]
    m[..., :3, 3] = s.translation
    m[..., 3, 3] = 1.0
    return m


# --------------------------------------------------------------------------
# Materials SoA (mirror of MaterialInfo, shared-structs/src/lib.rs:157-173)
# --------------------------------------------------------------------------

class MaterialsSoA(NamedTuple):
    """[M]-batched material table; ``tex_*`` are atlas texture refs,
    -1 = absent."""

    tex_diffuse: torch.Tensor  # [M] int32
    tex_metallic_roughness: torch.Tensor
    tex_normal_map: torch.Tensor
    tex_emissive: torch.Tensor
    tex_occlusion: torch.Tensor
    tex_transmission: torch.Tensor
    tex_thickness: torch.Tensor
    tex_specular: torch.Tensor
    tex_specular_colour: torch.Tensor
    metallic_factor: torch.Tensor  # [M]
    roughness_factor: torch.Tensor  # [M]
    alpha_clipping_cutoff: torch.Tensor  # [M]
    diffuse_factor: torch.Tensor  # [M, 4]
    emissive_factor: torch.Tensor  # [M, 3]
    normal_map_scale: torch.Tensor  # [M]
    occlusion_strength: torch.Tensor  # [M]
    index_of_refraction: torch.Tensor  # [M]
    transmission_factor: torch.Tensor  # [M]
    thickness_factor: torch.Tensor  # [M]
    attenuation_distance: torch.Tensor  # [M]
    attenuation_colour: torch.Tensor  # [M, 3]
    specular_factor: torch.Tensor  # [M]
    specular_colour_factor: torch.Tensor  # [M, 3]

    @property
    def num(self) -> int:
        return self.metallic_factor.shape[0]


def default_material(**overrides) -> dict:
    """glTF-default material row (src/model_loading.rs:293-333)."""
    row = dict(
        tex_diffuse=-1, tex_metallic_roughness=-1, tex_normal_map=-1,
        tex_emissive=-1, tex_occlusion=-1, tex_transmission=-1,
        tex_thickness=-1, tex_specular=-1, tex_specular_colour=-1,
        metallic_factor=1.0, roughness_factor=1.0, alpha_clipping_cutoff=0.5,
        diffuse_factor=(1.0, 1.0, 1.0, 1.0), emissive_factor=(0.0, 0.0, 0.0),
        normal_map_scale=0.0, occlusion_strength=1.0, index_of_refraction=1.5,
        transmission_factor=0.0, thickness_factor=0.0,
        attenuation_distance=np.inf, attenuation_colour=(1.0, 1.0, 1.0),
        specular_factor=1.0, specular_colour_factor=(1.0, 1.0, 1.0),
    )
    row.update(overrides)
    return row


def pack_materials(rows: list[dict]) -> MaterialsSoA:
    if not rows:
        rows = [default_material()]

    def col(key, dtype):
        return torch.from_numpy(
            np.stack([np.asarray(r[key], dtype) for r in rows])
        )

    kwargs = {
        k: col(k, np.int32 if k.startswith("tex_") else np.float32)
        for k in rows[0]
    }
    return MaterialsSoA(**kwargs)


# --------------------------------------------------------------------------
# Scene
# --------------------------------------------------------------------------

class Scene(NamedTuple):
    """Frozen scene tensors (ModelBuffers + descriptor tables,
    src/main.rs:2495-2588)."""

    positions: torch.Tensor  # [V, 3] f32 (object space)
    normals: torch.Tensor  # [V, 3] f32
    uvs: torch.Tensor  # [V, 2] f32
    indices: torch.Tensor  # [T, 3] int32 into the vertex pool
    prim_bounding_sphere: torch.Tensor  # [P, 4]
    prim_draw_bucket: torch.Tensor  # [P] int32
    prim_first_tri: torch.Tensor  # [P] int32
    prim_tri_count: torch.Tensor  # [P] int32
    inst_transform: Similarity  # [I]-batched
    inst_primitive_id: torch.Tensor  # [I] int32
    inst_material_id: torch.Tensor  # [I] int32
    materials: MaterialsSoA
    atlas_texels: torch.Tensor  # [R, row_elems] bfloat16 (scene/textures.py)
    atlas_meta: torch.Tensor  # [num_images, META_COLS + class tag] int32
    atlas_srgb: torch.Tensor  # [num_images] bool (informational)

    @property
    def num_instances(self) -> int:
        return self.inst_primitive_id.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]


def to_device(tree, device):
    """Move every tensor of a (nested) NamedTuple to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, device) for v in tree))
    return tree
