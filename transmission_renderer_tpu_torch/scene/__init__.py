"""Scene layer: types, texture atlas, builder, camera (counterpart of
``transmission_renderer_tpu/scene``; JAX-free)."""
