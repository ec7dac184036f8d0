"""The traced run's reduction: a profiler trace of a bounded stretch of
frames -> device activity, kernel time by name, and the host's share of
what the device waited on; beside it what the run read without the
profiler: the window's host times and the passes' event-timed spans.

The profiled stretch is ``frames`` consecutive frames after the window,
each wrapped in a ``bench_frame`` range from this harness.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

FRAME_RANGE = "bench_frame"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# a templated kernel's name runs to hundreds of characters: its head names it
NAME_CHARS = 160


class Trace:
    """What the per-layer metric readers read (``metrics/<name>.py``)."""

    def __init__(self, trace_path: str, frames: int, enqueue_ms: list, frame_ms: float,
                 spans_ms: dict, work: dict):
        self.frames = frames
        # the window's, which no profiler slowed: host ms of render_frame's
        # call per frame, and its wall time over its frames
        self.enqueue_ms = enqueue_ms
        self.frame_ms = frame_ms
        # range name -> ms per frame on the device timeline (core/spans.py)
        self.spans_ms = spans_ms
        self.work = work  # kernel name -> (bytes, operations) of each recorded call
        with open(trace_path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        frame_ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                              if e.get("cat") == "user_annotation" and e["name"] == FRAME_RANGE)
        if len(frame_ranges) != frames:
            raise RuntimeError(f"the trace holds {len(frame_ranges)} frames, not {frames}")
        self.t0, self.t1 = frame_ranges[0][0], frame_ranges[-1][1]
        self.device = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                             if e.get("cat") in DEVICE_CATS and self.t0 <= e["ts"] <= self.t1)
        self.ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                             if e.get("cat") == "user_annotation" and e["name"] != FRAME_RANGE
                             and self.t0 <= e["ts"] <= self.t1)
        self.ops = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                          if e.get("cat") == "cpu_op" and self.t0 <= e["ts"] <= self.t1)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> list:
        """The union of device operations' intervals in the window."""
        out = []
        for s, e, _ in self.device:
            e = min(e, self.t1)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def span_ms(self, names) -> float | None:
        """Summed event-timed span of the ranges named ``names`` per frame
        (None when no such range opened)."""
        found = [self.spans_ms[n] for n in names if n in self.spans_ms]
        return sum(found) if found else None

    def kernel_seconds(self, substrings) -> float:
        return sum(e - s for s, e, n in self.device if any(k in n for k in substrings)) * 1e-6

    def breakdown(self) -> dict:
        """The device operations that took most time, and the device's
        idle time by the innermost host range open when each gap began."""
        ops = defaultdict(float)
        for s, e, n in self.device:
            ops[n] += (e - s) * 1e-6
        gaps = defaultdict(float)
        prev = self.t0
        for s, e in self.busy_intervals() + [[self.t1, self.t1]]:
            if s > prev:
                gaps[self._host_label(prev)] += (s - prev) * 1e-6
            prev = max(prev, e)
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:NAME_CHARS], v] for n, v in top],
                "idle_gaps": [[n, v] for n, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]}

    def _host_label(self, t: float) -> str:
        """"pass / op": the innermost host range and operator open at t."""
        def innermost(items, starts):
            i = bisect.bisect_right(starts, t) - 1
            for j in range(i, max(i - 64, -1), -1):
                if items[j][1] > t:
                    return items[j][2]
            return None

        if not hasattr(self, "_starts"):
            self._starts = ([r[0] for r in self.ranges], [o[0] for o in self.ops])
        where = innermost(self.ranges, self._starts[0]) or "outside the passes"
        op = innermost(self.ops, self._starts[1])
        return f"{where} / {op}" if op else where
