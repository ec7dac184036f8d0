"""The Sponza-foliage analogue: a checkered floor and a grid of spheres,
boxes and glass spheres, each with an alpha-clip leaf card (a 128^2
image of round holes, cutoff 0.5) beside it (the port's
``build_stress_scene``, frozen here). The objects' colours, scales,
roughness and box turns come from the run's seed; the grid, the leaf
cards and the buckets come from the configuration."""

from __future__ import annotations

import numpy as np

from benchmark.scenes.meshes import (
    BUCKET_ALPHA_CLIP,
    BUCKET_OPAQUE,
    BUCKET_TRANSMISSION,
    SceneArrays,
    box_mesh,
    checkerboard,
    plane_mesh,
    quat_from_axis_angle,
    sphere_mesh,
)


def leaf_image(size: int = 128) -> np.ndarray:
    ys, xs = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    leaf = np.zeros((size, size, 4), np.uint8)
    leaf[..., 0] = 40
    leaf[..., 1] = 140
    r = np.hypot((xs % 32) - 16, (ys % 32) - 16)
    leaf[..., 3] = np.where(r < 12, 255, 0).astype(np.uint8)
    return leaf


def build(p: dict, rng: np.random.Generator) -> SceneArrays:
    grid = p["grid"]
    s = SceneArrays()
    checker = s.add_texture(checkerboard(256, 16), srgb=True)
    leaf_tex = s.add_texture(leaf_image(), srgb=True)
    floor_mat = s.add_material(tex_diffuse=checker, roughness_factor=0.85)
    leaf_mat = s.add_material(tex_diffuse=leaf_tex, alpha_clipping_cutoff=p["alpha_cutoff"],
                              roughness_factor=0.8, metallic_factor=0.0)
    p_floor = s.add_primitive(*plane_mesh(grid * 2.5), bucket=BUCKET_OPAQUE)
    p_sphere = s.add_primitive(*sphere_mesh(16, 32), bucket=BUCKET_OPAQUE)
    p_box = s.add_primitive(*box_mesh((0.5, 0.5, 0.5)), bucket=BUCKET_OPAQUE)
    p_leaf = s.add_primitive(*plane_mesh(0.8, y=0.0, uv_scale=1.0), bucket=BUCKET_ALPHA_CLIP)
    p_glass = s.add_primitive(*sphere_mesh(16, 32), bucket=BUCKET_TRANSMISSION)
    s.add_instance(p_floor, floor_mat)
    for i in range(grid):
        for j in range(grid):
            x = (i - grid / 2 + 0.5) * 4.0
            z = -(j + 1) * 4.0
            kind = (i + j) % 3
            if kind == 0:
                mat = s.add_material(
                    diffuse_factor=(*rng.uniform(0.2, 0.9, 3), 1.0),
                    roughness_factor=float(rng.uniform(0.2, 0.9)),
                    metallic_factor=float(rng.uniform(0, 1) > 0.7))
                s.add_instance(p_sphere, mat, translation=(x, 1.0, z),
                               scale=float(rng.uniform(0.6, 1.2)))
            elif kind == 1:
                mat = s.add_material(diffuse_factor=(*rng.uniform(0.2, 0.9, 3), 1.0),
                                     roughness_factor=0.6)
                s.add_instance(p_box, mat, translation=(x, 0.5, z),
                               rotation=quat_from_axis_angle([0, 1, 0],
                                                             float(rng.uniform(0, 3))))
            else:
                glass = s.add_material(
                    transmission_factor=1.0, metallic_factor=0.0,
                    roughness_factor=float(rng.uniform(0.0, 0.4)),
                    thickness_factor=0.5, attenuation_distance=1.5,
                    attenuation_colour=tuple(rng.uniform(0.3, 0.95, 3)))
                s.add_instance(p_glass, glass, translation=(x, 1.0, z), scale=0.8)
            # a leaf card beside every object
            s.add_instance(p_leaf, leaf_mat, translation=(x + 1.2, 1.0, z),
                           rotation=quat_from_axis_angle([1, 0, 0], 1.57))
    return s
