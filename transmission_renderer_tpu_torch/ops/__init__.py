"""Array operators: culling, binning, the G-buffer raster, texture and
pyramid sampling, the BVH (counterpart of ``transmission_renderer_tpu/ops``)."""

from transmission_renderer_tpu_torch.ops.bvh import (  # noqa: F401
    BVH,
    build_bvh,
    refit_bvh,
    trace_shadow_bfs,
)
