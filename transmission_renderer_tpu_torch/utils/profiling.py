"""Per-pass profiler ranges, the trace capture and a frame timer.

Counterpart of ``transmission_renderer_tpu/utils/profiling.py``
(``pass_scope``, ``trace``, ``device_sync``, ``FrameTimer``): there a
pass is a ``jax.named_scope``, a trace is ``jax.profiler``'s and a sync
is a 4-byte readback; here a pass is a
``torch.profiler.record_function`` range (which ``torch.profiler`` shows
on the host and, with CUDA activity, against the kernels it launched)
plus an NVTX range when a CUDA device is present, and ``trace`` writes a
``torch.profiler`` Chrome trace. The pass names are the JAX package's, so
a per-pass table reads the same in both, and ``device_sync`` waits with
``torch.cuda.synchronize`` for a CUDA tensor (a CPU tensor is ready).
"""

from __future__ import annotations

import contextlib
import os
import time

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


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace of the block into ``log_dir/trace.json``
    (Chrome trace format: open in Perfetto or chrome://tracing): host
    activity, and the card's kernels when a CUDA device is present. The
    pass ranges appear under their PASS_NAMES."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_sync(x) -> None:
    """Wait for the work behind ``x`` (a tensor, or a tuple / list /
    NamedTuple tree of them; its first tensor decides): the card is
    synchronised for a CUDA tensor, and a CPU tensor is already there."""
    while isinstance(x, (tuple, list)):
        x = x[0]
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


class FrameTimer:
    """Rolling frame-time statistics with a true device sync."""

    def __init__(self, window: int = 60):
        self.window = window
        self.samples: list[float] = []
        self._t0 = None

    def begin(self):
        self._t0 = time.perf_counter()

    def end(self, frame_output) -> float:
        device_sync(frame_output)
        dt = time.perf_counter() - self._t0
        self.samples.append(dt)
        if len(self.samples) > self.window:
            self.samples.pop(0)
        return dt

    @property
    def mean_ms(self) -> float:
        return 1000.0 * sum(self.samples) / max(len(self.samples), 1)

    @property
    def fps(self) -> float:
        mean = sum(self.samples) / max(len(self.samples), 1)
        return 1.0 / max(mean, 1e-9)
