"""Procedural scenes (counterpart of ``transmission_renderer_tpu/models``)."""

from transmission_renderer_tpu_torch.models.procedural import (  # noqa: F401
    build_dragon_scene,
    checkerboard_texture,
    make_box_mesh,
    make_plane_mesh,
    make_sphere_mesh,
)
