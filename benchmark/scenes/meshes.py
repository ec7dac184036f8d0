"""Scene arrays shared by the benchmark's generators, the port adapter and
the plain reference.

A ``SceneArrays`` is what a glTF loader would hand a renderer: RGBA8
images, full material rows, primitives (object-space vertices, indices,
draw bucket) and instances (primitive, material, similarity transform).
The mesh and texture helpers are a frozen copy of the procedural
analogues the port's bench scenes use, so the benchmark builds its
scenes without calling the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# draw buckets (alpha mode x transmission), as a glTF loader classifies them
BUCKET_OPAQUE = 0
BUCKET_ALPHA_CLIP = 1
BUCKET_TRANSMISSION = 2
BUCKET_TRANSMISSION_ALPHA_CLIP = 3

TEXTURE_SLOTS = (
    "tex_diffuse", "tex_metallic_roughness", "tex_normal_map", "tex_emissive",
    "tex_occlusion", "tex_transmission", "tex_thickness", "tex_specular",
    "tex_specular_colour",
)


def material(**overrides) -> dict:
    """A glTF-default material row with ``overrides`` (every field stated,
    so both sides read the same values)."""
    row = dict(
        **{slot: -1 for slot in TEXTURE_SLOTS},
        metallic_factor=1.0, roughness_factor=1.0, alpha_clipping_cutoff=0.5,
        diffuse_factor=(1.0, 1.0, 1.0, 1.0), emissive_factor=(0.0, 0.0, 0.0),
        normal_map_scale=0.0, occlusion_strength=1.0, index_of_refraction=1.5,
        transmission_factor=0.0, thickness_factor=0.0,
        attenuation_distance=np.inf, attenuation_colour=(1.0, 1.0, 1.0),
        specular_factor=1.0, specular_colour_factor=(1.0, 1.0, 1.0),
    )
    unknown = set(overrides) - set(row)
    if unknown:
        raise KeyError(f"unknown material fields {sorted(unknown)}")
    row.update(overrides)
    return row


@dataclasses.dataclass
class Primitive:
    positions: np.ndarray  # [V, 3] float32, object space
    normals: np.ndarray  # [V, 3] float32
    uvs: np.ndarray  # [V, 2] float32
    indices: np.ndarray  # [T, 3] uint32 into this primitive's vertices
    bucket: int


@dataclasses.dataclass
class Instance:
    primitive: int
    material: int
    translation: tuple = (0.0, 0.0, 0.0)
    scale: float = 1.0
    rotation: tuple = (0.0, 0.0, 0.0, 1.0)  # xyzw


@dataclasses.dataclass
class SceneArrays:
    textures: list = dataclasses.field(default_factory=list)  # (rgba uint8, srgb)
    materials: list = dataclasses.field(default_factory=list)
    primitives: list = dataclasses.field(default_factory=list)
    instances: list = dataclasses.field(default_factory=list)

    def add_texture(self, rgba: np.ndarray, srgb: bool) -> int:
        self.textures.append((np.ascontiguousarray(rgba, np.uint8), bool(srgb)))
        return len(self.textures) - 1

    def add_material(self, **overrides) -> int:
        self.materials.append(material(**overrides))
        return len(self.materials) - 1

    def add_primitive(self, positions, normals, uvs, indices, bucket: int) -> int:
        self.primitives.append(Primitive(
            np.asarray(positions, np.float32), np.asarray(normals, np.float32),
            np.asarray(uvs, np.float32), np.asarray(indices, np.uint32).reshape(-1, 3),
            int(bucket)))
        return len(self.primitives) - 1

    def add_instance(self, primitive: int, material_id: int, translation=(0.0, 0.0, 0.0),
                     scale: float = 1.0, rotation=(0.0, 0.0, 0.0, 1.0)) -> int:
        self.instances.append(Instance(
            primitive, material_id, tuple(float(t) for t in translation), float(scale),
            tuple(float(q) for q in np.asarray(rotation, np.float32))))
        return len(self.instances) - 1

    @property
    def num_triangles(self) -> int:
        return sum(len(self.primitives[i.primitive].indices) for i in self.instances)


def quat_from_axis_angle(axis, angle: float) -> np.ndarray:
    """Unit quaternion (xyzw) of a rotation by ``angle`` about ``axis``."""
    axis = np.asarray(axis, np.float32)
    axis = axis / np.linalg.norm(axis)
    s = np.sin(angle / 2.0)
    return np.array([*(axis * s), np.cos(angle / 2.0)], np.float32)


def sphere_mesh(stacks: int = 32, sectors: int = 64, radius: float = 1.0):
    """UV sphere -> (positions [V, 3], normals [V, 3], uvs [V, 2], indices [T, 3])."""
    phi = np.linspace(0.0, np.pi, stacks + 1)
    theta = np.linspace(0.0, 2.0 * np.pi, sectors + 1)
    pg, tg = np.meshgrid(phi, theta, indexing="ij")
    x = np.sin(pg) * np.cos(tg)
    y = np.cos(pg)
    z = np.sin(pg) * np.sin(tg)
    normals = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    positions = normals * radius
    uvs = np.stack([tg / (2 * np.pi), pg / np.pi], -1).reshape(-1, 2).astype(np.float32)
    cols = sectors + 1
    i, j = np.meshgrid(np.arange(stacks), np.arange(sectors), indexing="ij")
    a = (i * cols + j).reshape(-1)
    b = a + cols
    # per quad: (a, b, a+1) then (a+1, b, b+1), counter-clockwise from outside
    indices = np.stack(
        [np.stack([a, b, a + 1], -1), np.stack([a + 1, b, b + 1], -1)], 1
    ).reshape(-1, 3).astype(np.uint32)
    return positions, normals, uvs, indices


def box_mesh(half_extents=(1.0, 1.0, 1.0)):
    he = np.array(half_extents, np.float32)
    axes = [
        ((1, 0, 0), (0, 0, -1), (0, -1, 0)), ((-1, 0, 0), (0, 0, 1), (0, -1, 0)),
        ((0, 1, 0), (1, 0, 0), (0, 0, 1)), ((0, -1, 0), (1, 0, 0), (0, 0, -1)),
        ((0, 0, 1), (1, 0, 0), (0, -1, 0)), ((0, 0, -1), (-1, 0, 0), (0, -1, 0)),
    ]
    positions, normals, uvs, indices = [], [], [], []
    for n, tu, tv in axes:
        n, tu, tv = (np.array(a, np.float32) for a in (n, tu, tv))
        base = len(positions)
        for su, sv, uu, vv in [(-1, -1, 0, 0), (1, -1, 1, 0), (1, 1, 1, 1), (-1, 1, 0, 1)]:
            positions.append((n + tu * su + tv * sv) * he)
            normals.append(n)
            uvs.append([uu, vv])
        indices += [[base, base + 2, base + 1], [base, base + 3, base + 2]]
    return (np.array(positions, np.float32), np.array(normals, np.float32),
            np.array(uvs, np.float32), np.array(indices, np.uint32))


def plane_mesh(half_size: float = 10.0, y: float = 0.0, uv_scale: float = 4.0):
    positions = np.array([[-half_size, y, -half_size], [half_size, y, -half_size],
                          [half_size, y, half_size], [-half_size, y, half_size]], np.float32)
    normals = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (4, 1))
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) * uv_scale
    return positions, normals, uvs, np.array([[0, 2, 1], [0, 3, 2]], np.uint32)


def checkerboard(size: int = 256, cells: int = 8, c0: int = 200, c1: int = 60) -> np.ndarray:
    ys, xs = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    v = np.where(((xs * cells // size) + (ys * cells // size)) % 2 == 0, c0, c1).astype(np.uint8)
    return np.stack([v, v, v, np.full_like(v, 255)], -1)


def displaced_sphere(stacks: int, sectors: int, rng: np.random.Generator, amp: float):
    """A sphere displaced by five low-frequency sinusoids drawn from
    ``rng``, with smooth normals recomputed from the faces."""
    p, _, uvs, indices = sphere_mesh(stacks, sectors)
    disp = np.zeros(len(p), np.float32)
    for _ in range(5):
        k = rng.normal(size=3).astype(np.float32) * 2.0
        phase = rng.uniform(0, 2 * np.pi)
        disp += np.sin(p @ k + phase).astype(np.float32)
    positions = (p * (1.0 + amp * disp / 5.0)[:, None]).astype(np.float32)
    tri = positions[indices.astype(np.int64)]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    vn = np.zeros_like(positions)
    np.add.at(vn, indices.reshape(-1).astype(np.int64), np.repeat(fn, 3, axis=0))
    vn = vn / np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)
    return positions, vn.astype(np.float32), uvs, indices
