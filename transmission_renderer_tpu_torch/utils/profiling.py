"""Per-pass profiler ranges.

Counterpart of ``transmission_renderer_tpu/utils/profiling.py::pass_scope``:
there a pass is a ``jax.named_scope``; here it is a
``torch.profiler.record_function`` range (which ``torch.profiler`` shows
on the host and, with CUDA activity, against the kernels it launched)
plus an NVTX range when a CUDA device is present. The pass names are the
JAX package's, so a per-pass table reads the same in both.
"""

from __future__ import annotations

import contextlib

import torch

# the render_frame passes, in frame order (shadow_rays_transmission runs
# inside shade_transmission)
PASS_NAMES = (
    "geometry", "binning", "payload", "raster_opaque", "clustering",
    "shadow_rays_opaque", "shade_opaque", "mip_pyramid",
    "raster_transmission", "shade_transmission", "shadow_rays_transmission",
    "tonemap",
)
# the alpha-clip depth peel's ranges, inside each raster_clip_peel (after
# raster_opaque and after raster_transmission): its alpha tests and its
# re-race rounds (clip_round_1 .. clip_round_{alpha_clip_rounds - 1})
CLIP_PASS_NAMES = ("raster_clip_peel", "clip_alpha_test")


@contextlib.contextmanager
def pass_scope(name: str):
    """Named range for one render pass."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
