"""The passes' spans on the device timeline, read without a profiler.

While a stretch of frames runs, the program's ``pass_scope`` (the named
range it opens around each pass) is wrapped so that each range also
records a CUDA event where it opens and one where it closes. The time
between the two is the range's span on the device timeline: from the
moment the work queued before the pass is done (or, on an idle device,
the pass opens) to the end of the pass's last operation, waits on the
host included. Event records cost the host microseconds where a
profiler's CPU activity costs it half the frame, so a launch-bound pass
reads its own time. On the CPU the host clock stands in.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from collections import defaultdict

import torch

# the program's modules that open pass ranges through ``pass_scope``
MODULES = ("transmission_renderer_tpu_torch.render.frame",
           "transmission_renderer_tpu_torch.render.shading")


class EventSpans:
    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []  # (name, opened, closed)

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    @contextlib.contextmanager
    def _scope(self, original, name: str):
        opened = self._mark()
        try:
            with original(name):
                yield
        finally:
            self.marks.append((name, opened, self._mark()))

    @contextlib.contextmanager
    def recording(self):
        """Wrap the program's ``pass_scope`` for the block."""
        mods = [importlib.import_module(m) for m in MODULES]
        saved = [m.pass_scope for m in mods]
        for m, original in zip(mods, saved):
            m.pass_scope = lambda name, _o=original: self._scope(_o, name)
        try:
            yield self
        finally:
            for m, original in zip(mods, saved):
                m.pass_scope = original

    def ms_by_name(self) -> dict:
        """Summed span of each range name, in ms (after a sync)."""
        out = defaultdict(float)
        for name, opened, closed in self.marks:
            out[name] += opened.elapsed_time(closed) if self.cuda else (closed - opened) * 1e3
        return dict(out)
