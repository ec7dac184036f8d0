"""Per-pass ranges, the frame tracer, the profiler's trace capture and a
device sync.

Counterpart of ``transmission_renderer_tpu/utils/profiling.py``
(``pass_scope``, ``trace``, ``device_sync``): there a pass is a
``jax.named_scope``, a trace is ``jax.profiler``'s and a sync is a 4-byte
readback; here a pass is a ``torch.profiler.record_function`` range
(which ``torch.profiler`` shows on the host and, with CUDA activity,
against the kernels it launched) plus an NVTX range when a CUDA device
is present, and ``trace`` writes a ``torch.profiler`` Chrome trace. The
pass names are the JAX package's, so a per-pass table reads the same in
both, and ``device_sync`` waits with ``torch.cuda.synchronize`` for a
CUDA tensor (a CPU tensor is ready).

The frame tracer is the port's own record of its passes, off by default.
``tracing(FrameTracer(device))`` installs one for a block; while it is
installed every ``pass_scope`` range is also a ``Span``, kept in memory
until ``FrameTracer.read`` (called after the caller's sync) resolves and
hands back the closed ones. ``render_frame`` opens the outermost span,
``render_frame`` (``FRAME_SPAN``), and the tracer numbers those frames.
Host times are read on the profiler's own clock (Unix time: a
``torch.profiler`` Chrome trace holds it less its ``baseTimeNanoseconds``),
so a span and the profiler's ranges and kernels lie on one time axis.
Device times come from CUDA events taken from a pool the tracer reuses,
put on that axis through the anchor event each outermost span records at
its open: the caller's previous sync has left the device idle there, so
the anchor fires at its host time and an event ``e`` of that frame fires
at ``anchor host time + anchor.elapsed_time(e)``. The tracer adds no
host sync; on the CPU the host clock stands in for the device's.

In counting mode (``FrameTracer(counting=True)``, which slows the host,
so its frames are never the timed ones) each span also counts what ran
inside it: the aten ops dispatched on the tracer's device, the launches
of every ``kernels.KernelHandle`` and the host syncs (see ``Span``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

from transmission_renderer_tpu_torch import kernels

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
# re-race rounds (one clip_rounds range around every round)
CLIP_PASS_NAMES = ("raster_clip_peel", "clip_alpha_test", "clip_rounds")
# the range render_frame opens around a whole frame: one span per frame,
# each numbered by the tracer
FRAME_SPAN = "render_frame"
# CUDA events a timing tracer makes up front: a frame's ~45 spans take two
# each, and a read after each frame's sync hands them back
EVENT_POOL = 256
# the text of torch's warning in sync debug mode "warn"
SYNC_WARNING = "called a synchronizing CUDA operation"

_TRACER = None  # the FrameTracer that ``tracing`` installed, or None


@contextlib.contextmanager
def pass_scope(name: str):
    """Named range for one render pass (and a span of the installed tracer)."""
    tracer = _TRACER
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        if tracer is None:
            with torch.profiler.record_function(name):
                yield
        else:
            # the span lies inside the profiler's range: its times leave
            # the range's own enter and exit out
            with torch.profiler.record_function(name):
                span = tracer.open(name)
                try:
                    yield
                finally:
                    tracer.close(span)
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def current_tracer():
    """The installed FrameTracer, or None."""
    return _TRACER


class Span:
    """One ``pass_scope`` range under a FrameTracer.

    ``frame`` is the id of the enclosing ``render_frame`` span (None
    outside one), ``parent`` the enclosing span's ``id`` (None for an
    outermost one). Times are ns on the profiler's clock: ``host_open`` /
    ``host_close`` where the host entered and left the range,
    ``device_open`` / ``device_close`` where the device reached the
    range's start and finished its last operation (None when the tracer
    does not time; the host's times on the CPU). ``self_host_ms`` and
    ``self_device_ms`` leave out what the child spans cover.

    ``counters`` (counting mode; inclusive of the children): ``ops``, the
    aten ops that reached the dispatcher below autograd (a composite op
    counts as the ops it decomposes into) with a tensor argument or result
    on the tracer's device, views excluded (``OpOverload.is_view``: an
    output aliasing an input it does not write, as view, reshape of a
    contiguous tensor, slice, select, t, expand, lift_fresh); ``launches``,
    the summed rise of every KernelHandle's ``launches`` (``kernels`` has
    each kernel's); ``syncs``, the synchronising calls torch reports in
    sync debug mode "warn" (on the card; none on the CPU).
    ``diagnostics``: what the frame attached, read after the sync
    (render_frame: FrameDiagnostics.demands()).
    """

    __slots__ = ("id", "name", "frame", "parent", "host_open", "host_close",
                 "device_open", "device_close", "self_host_ms", "self_device_ms",
                 "counters", "kernels", "diagnostics", "_events", "_anchor", "_marks")

    def __init__(self, id_: int, name: str, frame, parent):
        self.id, self.name, self.frame, self.parent = id_, name, frame, parent
        self.host_open = self.host_close = None
        self.device_open = self.device_close = None
        self.self_host_ms = self.self_device_ms = None
        self.counters, self.kernels, self.diagnostics = {}, {}, None
        self._events, self._anchor, self._marks = None, None, None

    @property
    def host_ms(self) -> float:
        return (self.host_close - self.host_open) * 1e-6

    @property
    def device_ms(self) -> float | None:
        return None if self.device_open is None else (self.device_close - self.device_open) * 1e-6

    @property
    def queue_open_ms(self) -> float | None:
        """Device open less host open: near 0 where the device had drained
        and waited on the host's code; the backlog it still ran otherwise."""
        return None if self.device_open is None else (self.device_open - self.host_open) * 1e-6

    @property
    def queue_close_ms(self) -> float | None:
        """Device close less host close: how long the device still worked
        through the range after the host had left it."""
        return None if self.device_open is None else (self.device_close - self.host_close) * 1e-6


class FrameTracer:
    """Spans of the ``pass_scope`` ranges run while it is installed.

    ``timing``: record CUDA events at each span's open and close (from a
    pool of EVENT_POOL, grown only when the spans between two ``read``
    calls need more). ``counting``: count ops, launches and syncs per span
    (a TorchDispatchMode and torch's sync debug mode while installed)."""

    def __init__(self, device="cpu", timing: bool = True, counting: bool = False):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.cuda = device.type == "cuda"
        self.timing, self.counting = timing, counting
        self.frames = 0  # render_frame spans opened so far (the next frame's id)
        self.ops = self.syncs = 0  # running totals of counting mode
        self._handles = list(kernels.HANDLES) if counting else []
        self._pool = ([torch.cuda.Event(enable_timing=True) for _ in range(EVENT_POOL)]
                      if self.cuda and timing else [])
        self._spans, self._stack, self._anchor = [], [], None
        # the profiler's clock (Unix ns) from the monotonic one
        self._offset = time.time_ns() - time.perf_counter_ns()

    def _event(self):
        e = self._pool.pop() if self._pool else torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _marks(self):
        return self.ops, self.syncs, [h.launches for h in self._handles]

    def open(self, name: str) -> Span:
        parent = self._stack[-1] if self._stack else None
        frame = parent.frame if parent is not None else None
        if name == FRAME_SPAN:
            frame, self.frames = self.frames, self.frames + 1
        span = Span(len(self._spans), name, frame, None if parent is None else parent.id)
        if self.counting:
            span._marks = self._marks()
        span.host_open = time.perf_counter_ns() + self._offset
        if self.cuda and self.timing:
            opened = self._event()
            if parent is None:
                self._anchor = (opened, span.host_open)
            span._events = [opened, None]
        span._anchor = self._anchor
        self._spans.append(span)
        self._stack.append(span)
        return span

    def close(self, span: Span) -> None:
        if span._events is not None:
            span._events[1] = self._event()
        span.host_close = time.perf_counter_ns() + self._offset
        if self.counting:
            span._marks = (span._marks, self._marks())
        self._stack.pop()

    def attach(self, read) -> None:
        """Hand the innermost open span a callable to run at ``read``, after
        the caller's sync (render_frame: its diagnostics' demands)."""
        if self._stack:
            self._stack[-1].diagnostics = read

    def read(self) -> list:
        """The closed spans since the last read, resolved (call after the
        device work behind them is done, e.g. after a sync); their events
        go back to the pool."""
        if self._stack:
            raise RuntimeError(f"spans still open: {[s.name for s in self._stack]}")
        spans, self._spans, self._anchor = self._spans, [], None
        for s in spans:
            if s._events is not None:
                anchor, at = s._anchor
                s.device_open, s.device_close = (
                    at + round(anchor.elapsed_time(e) * 1e6) for e in s._events)
                self._pool.extend(s._events)
            elif not self.cuda:
                s.device_open, s.device_close = s.host_open, s.host_close
            if s._marks is not None:
                (ops0, syncs0, l0), (ops1, syncs1, l1) = s._marks
                s.kernels = {h.name: b - a for h, a, b in zip(self._handles, l0, l1) if b > a}
                s.counters = {"ops": ops1 - ops0, "launches": sum(s.kernels.values()),
                              "syncs": syncs1 - syncs0}
            if callable(s.diagnostics):
                s.diagnostics = s.diagnostics()
            s._events = s._anchor = s._marks = None
        children = {}
        for s in spans:
            if s.parent is not None:
                children.setdefault(s.parent, []).append(s)
        for s in spans:
            kids = children.get(s.id, [])
            s.self_host_ms = s.host_ms - _covered(
                s.host_open, s.host_close, [(k.host_open, k.host_close) for k in kids]) * 1e-6
            if s.device_open is not None:
                s.self_device_ms = s.device_ms - _covered(
                    s.device_open, s.device_close,
                    [(k.device_open, k.device_close) for k in kids]) * 1e-6
        return spans


def _covered(lo: int, hi: int, intervals) -> int:
    """Length of the union of ``intervals`` within [lo, hi]."""
    total, end = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


class _OpCounter(TorchDispatchMode):
    """Counts the ops Span.counters["ops"] describes into tracer.ops."""

    def __init__(self, tracer: FrameTracer):
        super().__init__()
        self.tracer = tracer

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            dev = self.tracer.device
            if any(isinstance(t, torch.Tensor) and t.device == dev
                   for t in tree_leaves((args, kwargs, out))):
                self.tracer.ops += 1
        return out


@contextlib.contextmanager
def _counting_syncs(tracer: FrameTracer):
    """Count torch's sync warnings into tracer.syncs (sync debug mode
    "warn" on the card); other warnings show as before."""
    shown = warnings.showwarning

    def show(message, category, *args, **kwargs):
        if SYNC_WARNING in str(message):
            tracer.syncs += 1
        else:
            shown(message, category, *args, **kwargs)

    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=SYNC_WARNING)
        warnings.showwarning = show
        mode = torch.cuda.get_sync_debug_mode() if tracer.cuda else None
        if tracer.cuda:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            if tracer.cuda:
                torch.cuda.set_sync_debug_mode(mode)


@contextlib.contextmanager
def tracing(tracer: FrameTracer):
    """Install ``tracer`` for the block (one at a time)."""
    global _TRACER
    if _TRACER is not None:
        raise RuntimeError("a FrameTracer is already installed")
    with contextlib.ExitStack() as stack:
        if tracer.counting:
            stack.enter_context(_counting_syncs(tracer))
            stack.enter_context(_OpCounter(tracer))
        _TRACER = tracer
        try:
            yield tracer
        finally:
            _TRACER = None


def write_chrome_trace(spans: list, path: str) -> None:
    """Spans as a Chrome trace (Perfetto, chrome://tracing): host and
    device as two tracks on the profiler's clock (``ts`` in Unix us), each
    span's frame, self time, queue and counters in its arguments."""
    events = [{"ph": "M", "name": "thread_name", "pid": 0, "tid": tid, "args": {"name": n}}
              for tid, n in ((0, "host"), (1, "device"))]
    for s in spans:
        args = {"frame": s.frame, "parent": s.parent, "self_ms": s.self_host_ms,
                **s.counters}
        events.append({"ph": "X", "name": s.name, "pid": 0, "tid": 0, "ts": s.host_open / 1e3,
                       "dur": (s.host_close - s.host_open) / 1e3, "args": args})
        if s.device_open is not None:
            args = {"frame": s.frame, "self_ms": s.self_device_ms,
                    "queue_open_ms": s.queue_open_ms, "queue_close_ms": s.queue_close_ms}
            events.append({"ph": "X", "name": s.name, "pid": 0, "tid": 1,
                           "ts": s.device_open / 1e3,
                           "dur": (s.device_close - s.device_open) / 1e3, "args": args})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


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
