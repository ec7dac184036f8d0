"""The DragonAttenuation analogue: a displaced glass blob with
transmission and volume attenuation over a checkered floor, a back wall
and two opaque props (the port's ``build_dragon_scene``, frozen here).
The blob's five displacement waves come from the run's seed; its
triangle count, materials and placement come from the configuration."""

from __future__ import annotations

import numpy as np

from benchmark.scenes.meshes import (
    BUCKET_OPAQUE,
    BUCKET_TRANSMISSION,
    SceneArrays,
    box_mesh,
    checkerboard,
    displaced_sphere,
    plane_mesh,
    sphere_mesh,
)


def build(p: dict, rng: np.random.Generator) -> SceneArrays:
    s = SceneArrays()
    checker = s.add_texture(checkerboard(*p["floor_checker"]), srgb=True)
    floor_mat = s.add_material(tex_diffuse=checker, roughness_factor=0.7)
    wall_mat = s.add_material(diffuse_factor=(0.35, 0.5, 0.7, 1.0), roughness_factor=0.9)
    glass = p["glass"]
    glass_mat = s.add_material(
        diffuse_factor=(1.0, 1.0, 1.0, 1.0), roughness_factor=glass["roughness"],
        metallic_factor=0.0, transmission_factor=1.0, thickness_factor=glass["thickness"],
        attenuation_distance=glass["attenuation_distance"],
        attenuation_colour=tuple(glass["attenuation_colour"]),
        index_of_refraction=glass["ior"])
    p_floor = s.add_primitive(*plane_mesh(10.0), bucket=BUCKET_OPAQUE)
    p_wall = s.add_primitive(*box_mesh((6.0, 4.0, 0.2)), bucket=BUCKET_OPAQUE)
    p_blob = s.add_primitive(*displaced_sphere(p["stacks"], p["sectors"], rng, p["amp"]),
                             bucket=BUCKET_TRANSMISSION)
    p_prop = s.add_primitive(*sphere_mesh(24, 48), bucket=BUCKET_OPAQUE)
    s.add_instance(p_floor, floor_mat)
    s.add_instance(p_wall, wall_mat, translation=(0.0, 3.0, -7.0))
    s.add_instance(p_blob, glass_mat, translation=(0.0, 1.6, -3.5), scale=1.2)
    s.add_instance(p_prop, s.add_material(diffuse_factor=(0.9, 0.2, 0.1, 1.0),
                                          roughness_factor=0.5),
                   translation=(-2.4, 0.8, -4.6), scale=0.8)
    s.add_instance(p_prop, s.add_material(diffuse_factor=(0.1, 0.7, 0.2, 1.0),
                                          roughness_factor=0.5),
                   translation=(2.4, 0.8, -4.8), scale=0.8)
    return s
