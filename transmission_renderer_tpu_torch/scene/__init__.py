"""Scene layer: types, texture atlas, builder, camera (counterpart of
``transmission_renderer_tpu/scene``, with its names; JAX-free)."""

from transmission_renderer_tpu_torch.scene.types import (  # noqa: F401
    MaterialsSoA,
    Scene,
    Similarity,
    quat_from_rotation_y,
    quat_mul,
    quat_rotate,
    similarity_apply,
    similarity_identity,
    similarity_mul,
    similarity_to_mat4,
)
from transmission_renderer_tpu_torch.scene.camera import (  # noqa: F401
    Camera,
    CameraRig,
    look_at_rh,
    perspective_matrix_reversed,
    sun_normal,
)
