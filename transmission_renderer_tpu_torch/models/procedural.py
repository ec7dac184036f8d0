"""Procedural meshes and the flagship scene.

Counterpart of ``transmission_renderer_tpu/models/procedural.py``
(make_sphere_mesh, make_box_mesh, make_plane_mesh, checkerboard_texture,
_displaced_sphere, build_dragon_scene). Same NumPy construction, same
seeds, so both packages build identical geometry and textures; the
other scenes of the reference are later work.
"""

from __future__ import annotations

import numpy as np

from transmission_renderer_tpu_torch.config import BUCKET_OPAQUE, BUCKET_TRANSMISSION
from transmission_renderer_tpu_torch.scene.builder import SceneBuilder


def make_sphere_mesh(stacks: int = 32, sectors: int = 64, radius: float = 1.0):
    """UV sphere -> (positions [V,3], normals [V,3], uvs [V,2], indices [T,3])."""
    phi = np.linspace(0.0, np.pi, stacks + 1)
    theta = np.linspace(0.0, 2.0 * np.pi, sectors + 1)
    pg, tg = np.meshgrid(phi, theta, indexing="ij")
    x = np.sin(pg) * np.cos(tg)
    y = np.cos(pg)
    z = np.sin(pg) * np.sin(tg)
    normals = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    positions = normals * radius
    u = tg / (2 * np.pi)
    v = pg / np.pi
    uvs = np.stack([u, v], -1).reshape(-1, 2).astype(np.float32)

    cols = sectors + 1
    i, j = np.meshgrid(np.arange(stacks), np.arange(sectors), indexing="ij")
    a = (i * cols + j).reshape(-1)
    b = a + cols
    # per quad: (a, b, a+1) then (a+1, b, b+1), CCW seen from outside
    indices = np.stack(
        [np.stack([a, b, a + 1], -1), np.stack([a + 1, b, b + 1], -1)], 1
    ).reshape(-1, 3).astype(np.uint32)
    return positions, normals, uvs, indices


def make_box_mesh(half_extents=(1.0, 1.0, 1.0)):
    hx, hy, hz = half_extents
    axes = [
        ((1, 0, 0), (0, 0, -1), (0, -1, 0)),
        ((-1, 0, 0), (0, 0, 1), (0, -1, 0)),
        ((0, 1, 0), (1, 0, 0), (0, 0, 1)),
        ((0, -1, 0), (1, 0, 0), (0, 0, -1)),
        ((0, 0, 1), (1, 0, 0), (0, -1, 0)),
        ((0, 0, -1), (-1, 0, 0), (0, -1, 0)),
    ]
    he = np.array([hx, hy, hz], np.float32)
    positions, normals, uvs, indices = [], [], [], []
    for n, tu, tv in axes:
        n = np.array(n, np.float32)
        tu = np.array(tu, np.float32)
        tv = np.array(tv, np.float32)
        base = len(positions)
        for su, sv, uu, vv in [(-1, -1, 0, 0), (1, -1, 1, 0), (1, 1, 1, 1), (-1, 1, 0, 1)]:
            positions.append((n + tu * su + tv * sv) * he)
            normals.append(n)
            uvs.append([uu, vv])
        indices.append([base, base + 2, base + 1])
        indices.append([base, base + 3, base + 2])
    return (
        np.array(positions, np.float32),
        np.array(normals, np.float32),
        np.array(uvs, np.float32),
        np.array(indices, np.uint32),
    )


def make_plane_mesh(half_size: float = 10.0, y: float = 0.0, uv_scale: float = 4.0):
    positions = np.array(
        [
            [-half_size, y, -half_size],
            [half_size, y, -half_size],
            [half_size, y, half_size],
            [-half_size, y, half_size],
        ],
        np.float32,
    )
    normals = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (4, 1))
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) * uv_scale
    indices = np.array([[0, 2, 1], [0, 3, 2]], np.uint32)
    return positions, normals, uvs, indices


def checkerboard_texture(size: int = 256, cells: int = 8, c0=200, c1=60) -> np.ndarray:
    ys, xs = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    cell = ((xs * cells // size) + (ys * cells // size)) % 2
    v = np.where(cell == 0, c0, c1).astype(np.uint8)
    return np.stack([v, v, v, np.full_like(v, 255)], -1)


def _displaced_sphere(stacks: int, sectors: int, seed: int = 7, amp: float = 0.15):
    """Sphere displaced by a few low-frequency sinusoids, with smooth
    normals recomputed from the faces."""
    positions, normals, uvs, indices = make_sphere_mesh(stacks, sectors)
    rng = np.random.default_rng(seed)
    p = positions
    disp = np.zeros(len(p), np.float32)
    for _ in range(5):
        k = rng.normal(size=3).astype(np.float32) * 2.0
        phase = rng.uniform(0, 2 * np.pi)
        disp += np.sin(p @ k + phase).astype(np.float32)
    r = 1.0 + amp * disp / 5.0
    positions = (p * r[:, None]).astype(np.float32)
    tri = positions[indices.astype(np.int64)]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    vn = np.zeros_like(positions)
    np.add.at(vn, indices.reshape(-1).astype(np.int64), np.repeat(fn, 3, axis=0))
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    vn = vn / np.maximum(norm, 1e-12)
    return positions, vn.astype(np.float32), uvs, indices


def build_dragon_scene(
    stacks: int = 180, sectors: int = 360, roughness_override: float | None = 0.25
) -> SceneBuilder:
    """DragonAttenuation analogue: a ~130k-triangle displaced blob with
    KHR_materials_transmission + volume over a checkered backdrop."""
    b = SceneBuilder()
    checker = b.add_texture(checkerboard_texture(512, 12, 230, 40), srgb=True)
    floor_mat = b.add_material(tex_diffuse=checker, roughness_factor=0.7)
    wall_mat = b.add_material(
        diffuse_factor=(0.35, 0.5, 0.7, 1.0), roughness_factor=0.9
    )
    glass_mat = b.add_material(
        diffuse_factor=(1.0, 1.0, 1.0, 1.0),
        roughness_factor=0.25 if roughness_override is None else roughness_override,
        metallic_factor=0.0,
        transmission_factor=1.0,
        thickness_factor=0.6,
        attenuation_distance=1.0,
        attenuation_colour=(0.9, 0.4, 0.25),
        index_of_refraction=1.5,
    )
    p_floor = b.add_primitive(*make_plane_mesh(10.0), bucket=BUCKET_OPAQUE)
    p_wall = b.add_primitive(*make_box_mesh((6.0, 4.0, 0.2)), bucket=BUCKET_OPAQUE)
    p_dragon = b.add_primitive(
        *_displaced_sphere(stacks, sectors, amp=0.25), bucket=BUCKET_TRANSMISSION
    )
    p_prop = b.add_primitive(*make_sphere_mesh(24, 48), bucket=BUCKET_OPAQUE)
    b.add_instance(p_floor, floor_mat)
    b.add_instance(p_wall, wall_mat, translation=(0.0, 3.0, -7.0))
    b.add_instance(p_dragon, glass_mat, translation=(0.0, 1.6, -3.5), scale=1.2)
    b.add_instance(
        p_prop,
        b.add_material(diffuse_factor=(0.9, 0.2, 0.1, 1.0), roughness_factor=0.5),
        translation=(-2.4, 0.8, -4.6), scale=0.8,
    )
    b.add_instance(
        p_prop,
        b.add_material(diffuse_factor=(0.1, 0.7, 0.2, 1.0), roughness_factor=0.5),
        translation=(2.4, 0.8, -4.8), scale=0.8,
    )
    return b
