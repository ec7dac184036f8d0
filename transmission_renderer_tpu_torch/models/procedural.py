"""Procedural meshes and the bench's scenes.

Counterpart of ``transmission_renderer_tpu/models/procedural.py``
(make_sphere_mesh, make_box_mesh, make_plane_mesh, checkerboard_texture,
_displaced_sphere, build_test_scene, _helmet_texture_set,
build_opaque_scene, build_dragon_scene, build_stress_scene,
_pattern_texture, build_bindless_scene, bindless_lights,
build_attenuation_scene). Same NumPy construction, same seeds, so both
packages build identical geometry, textures and lights.
"""

from __future__ import annotations

import numpy as np

from transmission_renderer_tpu_torch.config import (
    BUCKET_ALPHA_CLIP,
    BUCKET_OPAQUE,
    BUCKET_TRANSMISSION,
)
from transmission_renderer_tpu_torch.pbr.lights import point_light, spot_light
from transmission_renderer_tpu_torch.scene.builder import SceneBuilder
from transmission_renderer_tpu_torch.scene.types import quat_from_axis_angle


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


def build_test_scene() -> SceneBuilder:
    """Tiny scene for fast tests: a checker floor, one sphere, one box."""
    b = SceneBuilder()
    checker = b.add_texture(checkerboard_texture(64, 8), srgb=True)
    floor_mat = b.add_material(
        tex_diffuse=checker, roughness_factor=0.8, metallic_factor=0.0
    )
    red_mat = b.add_material(
        diffuse_factor=(0.8, 0.1, 0.1, 1.0), roughness_factor=0.4, metallic_factor=0.0
    )
    metal_mat = b.add_material(
        diffuse_factor=(0.9, 0.85, 0.7, 1.0), roughness_factor=0.3, metallic_factor=1.0
    )
    p_floor = b.add_primitive(*make_plane_mesh(6.0), bucket=BUCKET_OPAQUE)
    p_sphere = b.add_primitive(*make_sphere_mesh(16, 32), bucket=BUCKET_OPAQUE)
    p_box = b.add_primitive(*make_box_mesh((0.6, 0.6, 0.6)), bucket=BUCKET_OPAQUE)
    b.add_instance(p_floor, floor_mat)
    b.add_instance(p_sphere, red_mat, translation=(-1.2, 1.0, -3.0))
    b.add_instance(
        p_box, metal_mat, translation=(1.2, 0.6, -3.0),
        rotation=quat_from_axis_angle([0, 1, 0], 0.5),
    )
    return b


def _helmet_texture_set(size: int = 512, seed: int = 3):
    """DamagedHelmet-style set of five same-size RGBA8 textures: diffuse
    (sRGB), metallic-roughness (G roughness, B metallic), a tangent-space
    normal map, emissive (sRGB) and occlusion (R; loaded, never sampled)."""
    ys, xs = np.meshgrid(
        np.arange(size, dtype=np.float32), np.arange(size, dtype=np.float32),
        indexing="ij",
    )
    u = xs / size
    v = ys / size

    def octaves(freqs, seed_off=0):
        acc = np.zeros((size, size), np.float32)
        r = np.random.default_rng(seed + seed_off)
        for f in freqs:
            px, py = r.uniform(0, 2 * np.pi, 2)
            acc += np.sin(2 * np.pi * f * u + px) * np.sin(
                2 * np.pi * f * v + py
            ) / len(freqs)
        return acc

    base = octaves((3, 7, 13), 1)
    panels = ((np.sin(2 * np.pi * 6 * u) > 0.97)
              | (np.sin(2 * np.pi * 6 * v) > 0.97))
    diffuse = np.zeros((size, size, 4), np.uint8)
    diffuse[..., 0] = np.clip(150 + 70 * base - 90 * panels, 0, 255)
    diffuse[..., 1] = np.clip(110 + 55 * octaves((5, 11), 2) - 80 * panels, 0, 255)
    diffuse[..., 2] = np.clip(80 + 40 * octaves((4, 9), 3) - 60 * panels, 0, 255)
    diffuse[..., 3] = 255

    mr = np.zeros((size, size, 4), np.uint8)
    mr[..., 1] = np.clip(140 + 80 * octaves((6, 14), 4), 20, 235)
    mr[..., 2] = np.where(octaves((3, 8), 5) > 0.15, 255, 30)
    mr[..., 3] = 255

    # the analytic slope of a bump field as unit-ish tangent normals
    bump = octaves((8, 17, 31), 6)
    gx = np.gradient(bump, axis=1) * size * 0.02
    gy = np.gradient(bump, axis=0) * size * 0.02
    inv = 1.0 / np.sqrt(gx * gx + gy * gy + 1.0)
    normal = np.zeros((size, size, 4), np.uint8)
    normal[..., 0] = np.clip(((-gx * inv) * 0.5 + 0.5) * 255, 0, 255)
    normal[..., 1] = np.clip(((-gy * inv) * 0.5 + 0.5) * 255, 0, 255)
    normal[..., 2] = np.clip((inv * 0.5 + 0.5) * 255, 0, 255)
    normal[..., 3] = 255

    glow = (np.sin(2 * np.pi * 2.0 * v + 0.7) > 0.995).astype(np.float32)
    emissive = np.zeros((size, size, 4), np.uint8)
    emissive[..., 0] = np.clip(glow * 255, 0, 255)
    emissive[..., 1] = np.clip(glow * 180, 0, 255)
    emissive[..., 2] = np.clip(glow * 60, 0, 255)
    emissive[..., 3] = 255

    occ = np.zeros((size, size, 4), np.uint8)
    occ[..., 0] = np.clip(200 + 55 * octaves((5, 9), 7), 0, 255)
    occ[..., 3] = 255
    return diffuse, mr, normal, emissive, occ


def build_opaque_scene(
    stacks: int = 64, sectors: int = 128, texture_size: int = 512,
) -> SceneBuilder:
    """DamagedHelmet analogue: one displaced sphere with the full
    five-texture material over a checker floor. The four sampled textures
    are one 4-layer atlas bundle (one material tap for the set); the
    occlusion image, never sampled, stands alone."""
    b = SceneBuilder()
    checker = b.add_texture(checkerboard_texture(512, 16), srgb=True)
    d, mr, nm, em, oc = _helmet_texture_set(texture_size)
    refs = b.add_texture_bundle(
        [(d, True), (mr, False), (nm, False), (em, True)]
    )
    occ_ref = b.add_texture(oc, srgb=False)
    floor_mat = b.add_material(tex_diffuse=checker, roughness_factor=0.9)
    helmet_mat = b.add_material(
        diffuse_factor=(1.0, 1.0, 1.0, 1.0),
        tex_diffuse=refs[0],
        tex_metallic_roughness=refs[1],
        tex_normal_map=refs[2],
        tex_emissive=refs[3],
        tex_occlusion=occ_ref,
        emissive_factor=(2.0, 2.0, 2.0),
        roughness_factor=1.0,
        metallic_factor=1.0,
    )
    p_floor = b.add_primitive(*make_plane_mesh(8.0), bucket=BUCKET_OPAQUE)
    p_obj = b.add_primitive(*_displaced_sphere(stacks, sectors), bucket=BUCKET_OPAQUE)
    b.add_instance(p_floor, floor_mat)
    b.add_instance(p_obj, helmet_mat, translation=(0.0, 1.4, -3.5))
    return b


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


def build_stress_scene(grid: int = 5, seed: int = 11) -> SceneBuilder:
    """Sponza-analogue stress scene: a checker floor and a grid of
    spheres, boxes and glass spheres, each with an alpha-clip leaf card
    (a 128^2 texture of round holes, cutoff 0.5) beside it: instancing,
    mixed draw buckets and two image sizes in one texture slot."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    checker = b.add_texture(checkerboard_texture(256, 16), srgb=True)
    size = 128
    ys, xs = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    leaf = np.zeros((size, size, 4), np.uint8)
    leaf[..., 1] = 140
    leaf[..., 0] = 40
    r = np.hypot((xs % 32) - 16, (ys % 32) - 16)
    leaf[..., 3] = np.where(r < 12, 255, 0).astype(np.uint8)
    leaf_tex = b.add_texture(leaf, srgb=True)

    floor_mat = b.add_material(tex_diffuse=checker, roughness_factor=0.85)
    leaf_mat = b.add_material(
        tex_diffuse=leaf_tex, alpha_clipping_cutoff=0.5,
        roughness_factor=0.8, metallic_factor=0.0,
    )
    p_floor = b.add_primitive(*make_plane_mesh(grid * 2.5), bucket=BUCKET_OPAQUE)
    p_sphere = b.add_primitive(*make_sphere_mesh(16, 32), bucket=BUCKET_OPAQUE)
    p_box = b.add_primitive(*make_box_mesh((0.5, 0.5, 0.5)), bucket=BUCKET_OPAQUE)
    p_leaf = b.add_primitive(
        *make_plane_mesh(0.8, y=0.0, uv_scale=1.0), bucket=BUCKET_ALPHA_CLIP
    )
    p_glass = b.add_primitive(*make_sphere_mesh(16, 32), bucket=BUCKET_TRANSMISSION)

    b.add_instance(p_floor, floor_mat)
    for i in range(grid):
        for j in range(grid):
            x = (i - grid / 2 + 0.5) * 4.0
            z = -(j + 1) * 4.0
            kind = (i + j) % 3
            if kind == 0:
                mat = b.add_material(
                    diffuse_factor=(*rng.uniform(0.2, 0.9, 3), 1.0),
                    roughness_factor=float(rng.uniform(0.2, 0.9)),
                    metallic_factor=float(rng.uniform(0, 1) > 0.7),
                )
                b.add_instance(p_sphere, mat, translation=(x, 1.0, z),
                               scale=float(rng.uniform(0.6, 1.2)))
            elif kind == 1:
                mat = b.add_material(
                    diffuse_factor=(*rng.uniform(0.2, 0.9, 3), 1.0),
                    roughness_factor=0.6,
                )
                b.add_instance(
                    p_box, mat, translation=(x, 0.5, z),
                    rotation=quat_from_axis_angle([0, 1, 0], float(rng.uniform(0, 3))),
                )
            else:
                glass = b.add_material(
                    transmission_factor=1.0, metallic_factor=0.0,
                    roughness_factor=float(rng.uniform(0.0, 0.4)),
                    thickness_factor=0.5, attenuation_distance=1.5,
                    attenuation_colour=tuple(rng.uniform(0.3, 0.95, 3)),
                )
                b.add_instance(p_glass, glass, translation=(x, 1.0, z), scale=0.8)
            # a leaf card beside every object
            b.add_instance(
                p_leaf, leaf_mat, translation=(x + 1.2, 1.0, z),
                rotation=quat_from_axis_angle([1, 0, 0], 1.57),
            )
    return b


def _pattern_texture(size: int, kind: int, seed: int) -> np.ndarray:
    """A small RGBA8 pattern (stripes, rings, noise blobs or a checker),
    one image per (kind, seed)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(
        np.arange(size, dtype=np.float32), np.arange(size, dtype=np.float32),
        indexing="ij",
    )
    u, v = xs / size, ys / size
    base = rng.uniform(60, 200, 3)
    if kind == 0:
        f = rng.integers(2, 9)
        m = 0.5 + 0.5 * np.sin(2 * np.pi * f * u + rng.uniform(0, 6.0))
    elif kind == 1:
        r = np.hypot(u - 0.5, v - 0.5)
        m = 0.5 + 0.5 * np.sin(2 * np.pi * rng.integers(3, 9) * r)
    elif kind == 2:
        m = np.zeros((size, size), np.float32)
        for _ in range(4):
            k = rng.normal(size=2).astype(np.float32) * rng.uniform(3, 9)
            m += np.sin(u * 2 * np.pi * k[0] + v * 2 * np.pi * k[1])
        m = 0.5 + m / 8.0
    else:
        cells = int(rng.integers(3, 9))
        m = (((xs * cells // size) + (ys * cells // size)) % 2).astype(
            np.float32
        )
    rgba = np.zeros((size, size, 4), np.uint8)
    for c in range(3):
        rgba[..., c] = np.clip(base[c] * (0.4 + 0.6 * m), 0, 255)
    rgba[..., 3] = 255
    return rgba


def build_bindless_scene(
    grid: int = 9, n_images: int = 72, seed: int = 23
) -> SceneBuilder:
    """Bindless-texture-scale scene: ``n_images`` single images of mixed
    sizes (32 to 192 px, 48 / 96 / 192 not a power of two) and one
    material per grid object, most reading a second, different image
    through the emissive or metallic-roughness slot, so no slot bundle
    groups them (compute_slot_bundles gives ()) and each slot taps alone.
    The bench lights it with bindless_lights(48)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    sizes = (32, 48, 64, 96, 128, 192)
    tex = [
        b.add_texture(
            _pattern_texture(sizes[i % len(sizes)], i % 4, seed + i),
            srgb=(i % 3 != 2),
        )
        for i in range(n_images)
    ]
    floor_mat = b.add_material(tex_diffuse=tex[0], roughness_factor=0.85)
    p_floor = b.add_primitive(
        *make_plane_mesh(grid * 1.6), bucket=BUCKET_OPAQUE
    )
    p_sphere = b.add_primitive(*make_sphere_mesh(12, 24), bucket=BUCKET_OPAQUE)
    p_box = b.add_primitive(*make_box_mesh((0.45, 0.45, 0.45)),
                            bucket=BUCKET_OPAQUE)
    b.add_instance(p_floor, floor_mat)
    for i in range(grid):
        for j in range(grid):
            n = i * grid + j
            kw = dict(
                tex_diffuse=tex[(n + 1) % n_images],
                roughness_factor=float(rng.uniform(0.2, 0.9)),
                metallic_factor=float(rng.uniform(0.0, 1.0)),
            )
            if n % 3 == 0:
                kw["tex_emissive"] = tex[(n + 29) % n_images]
                kw["emissive_factor"] = (0.6, 0.5, 0.4)
            elif n % 3 == 1:
                kw["tex_metallic_roughness"] = tex[(n + 41) % n_images]
            mat = b.add_material(**kw)
            x = (i - grid / 2 + 0.5) * 2.4
            z = -(j + 1) * 2.4
            if n % 2:
                b.add_instance(p_sphere, mat, translation=(x, 0.9, z),
                               scale=float(rng.uniform(0.5, 0.9)))
            else:
                b.add_instance(
                    p_box, mat, translation=(x, 0.45, z),
                    rotation=quat_from_axis_angle(
                        [0, 1, 0], float(rng.uniform(0, 3.1))
                    ),
                )
    return b


def bindless_lights(n: int = 48, seed: int = 5) -> list:
    """The bindless scene's light rig: a grid of n - 4 coloured point
    lights and 4 spot lights pointing down."""
    rng = np.random.default_rng(seed)
    lights = []
    side = int(np.ceil(np.sqrt(n)))
    for k in range(n - 4):
        i, j = divmod(k, side)
        x = (i - side / 2 + 0.5) * 3.0
        z = -(j + 1) * 3.0
        lights.append(
            point_light(
                [x, float(rng.uniform(0.8, 2.5)), z],
                list(rng.uniform(0.2, 1.0, 3)),
                float(rng.uniform(2.0, 8.0)),
            )
        )
    for k in range(4):
        lights.append(
            spot_light(
                [(k - 1.5) * 4.0, 4.0, -6.0],
                list(rng.uniform(0.3, 1.0, 3)), 12.0,
                [0.0, -1.0, 0.0], 0.3, 0.8,
            )
        )
    return lights


def build_attenuation_scene() -> SceneBuilder:
    """AttenuationTest analogue: four glass boxes of growing thickness
    with Beer's-law attenuation, roughness 0 and no UVs (the missing-UV
    path), before a wall on a checker floor."""
    b = SceneBuilder()
    checker = b.add_texture(checkerboard_texture(256, 16), srgb=True)
    floor_mat = b.add_material(tex_diffuse=checker, roughness_factor=0.8)
    wall_mat = b.add_material(
        diffuse_factor=(0.8, 0.65, 0.45, 1.0), roughness_factor=0.9
    )
    p_floor = b.add_primitive(*make_plane_mesh(8.0), bucket=BUCKET_OPAQUE)
    p_wall = b.add_primitive(*make_box_mesh((8.0, 4.0, 0.2)), bucket=BUCKET_OPAQUE)
    b.add_instance(p_floor, floor_mat)
    b.add_instance(p_wall, wall_mat, translation=(0.0, 2.0, -6.5))
    for i, thickness in enumerate([0.2, 0.6, 1.2, 2.0]):
        mat = b.add_material(
            transmission_factor=1.0,
            metallic_factor=0.0,
            roughness_factor=0.0,
            thickness_factor=thickness,
            attenuation_distance=0.8,
            attenuation_colour=(0.3, 0.7, 0.9),
        )
        pos, nrm, _, idx = make_box_mesh((0.5, 0.5, 0.5))
        prim = b.add_primitive(pos, nrm, None, idx, bucket=BUCKET_TRANSMISSION)
        b.add_instance(prim, mat, translation=(-3.0 + 2.0 * i, 0.8, -4.0))
    return b
