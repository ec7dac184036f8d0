"""Procedural scenes (counterpart of ``transmission_renderer_tpu/models``)."""

from transmission_renderer_tpu_torch.models.procedural import (  # noqa: F401
    bindless_lights,
    build_attenuation_scene,
    build_bindless_scene,
    build_dragon_scene,
    build_opaque_scene,
    build_stress_scene,
    build_test_scene,
    checkerboard_texture,
    make_box_mesh,
    make_plane_mesh,
    make_sphere_mesh,
)
