"""The program's own spans and counters over stretches of a cell's frames.

The port records its passes itself (``FrameTracer`` in
``transmission_renderer_tpu_torch/utils/profiling.py``): a span per
``pass_scope`` range with host and device times on one clock, and in a
counting mode the ops, kernel launches and host syncs of each pass.
``timed_stretch`` runs frames under a timing tracer, beside
``core/spans.py``'s event wrapper so both read the same frames;
``counted_stretch`` runs frames under a counting one (which slows the
host, so its frames are never timed). ``ProgramSpans`` reduces them per
frame for the readers that take them from ``trace.program``:
``clip_alpha_test.span_ms``, ``clip_peel.host_ms`` and
``render_frame.dispatched_ops`` (benchmark/metrics/).

As a script it measures what the tracer reads on one cell and what it
costs, on the card it is started on, and prints one JSON line:

    python3 -m benchmark.core.program_spans --workload foliage.orbit --seed <n> [--pairs 3]

Set-up and warm-up as a run of the cell (``core/cell.py``) and
``--warm-seconds`` of frames back to back (as a run's window precedes its
traced stretches), then ``--pairs`` rounds of four stretches in turns: bare frames, the event
wrapper alone, the wrapper and the tracer, the tracer alone (the
tracer's cost: each frame's time from its camera update to the sync
after ``render_frame``); then two counting stretches, timing off then on
(the syncs must not differ). The per-pass table goes to standard error.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

from benchmark.core.registry import ROOT  # noqa: E402
from benchmark.core.spans import EventSpans  # noqa: E402
from transmission_renderer_tpu_torch.utils.profiling import (  # noqa: E402
    FRAME_SPAN,
    FrameTracer,
    tracing,
)

# frames of a counting stretch: the frame's shapes are static, so its
# counts repeat frame after frame
COUNT_FRAMES = 3


def timed_stretch(v, render, sync, device, frames: int, traced: bool = True,
                  events: bool = True):
    """``frames`` frames of the viewer's path, under core/spans.py's event
    wrapper when ``events`` and the program's timing tracer when
    ``traced`` -> (the tracer's spans, the wrapper's {range name: summed
    ms}, each frame's ms from its camera update to the sync after
    render_frame)."""
    rec, spans, times = EventSpans(device), [], []
    tracer = FrameTracer(device) if traced else None
    with (rec.recording() if events else contextlib.nullcontext()), \
            (tracing(tracer) if traced else contextlib.nullcontext()):
        for _ in range(frames):
            t0 = time.perf_counter()
            render(v, v.step())
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            if traced:
                spans += tracer.read()  # after the sync, outside the frame's time
    return spans, rec.ms_by_name(), times


def counted_stretch(v, render, sync, device, frames: int = COUNT_FRAMES,
                    timing: bool = False) -> list:
    """``frames`` frames under a counting tracer (and its events when
    ``timing``) -> the tracer's spans."""
    tracer, spans = FrameTracer(device, timing=timing, counting=True), []
    with tracing(tracer):
        for _ in range(frames):
            render(v, v.step())
            sync()
            spans += tracer.read()
    return spans


class ProgramSpans:
    """Spans of timed frames and of counted frames, reduced per frame."""

    def __init__(self, timed: list, counted: list):
        self.timed, self.counted = timed, counted

    @staticmethod
    def _frames(spans) -> int:
        """Frames among ``spans`` (each stretch's tracer numbers its own)."""
        return sum(s.name == FRAME_SPAN for s in spans)

    def span_ms(self, name: str, clock: str = "device") -> float | None:
        """Summed duration of the spans named ``name`` per timed frame, on
        the device's clock or the host's (None when none opened)."""
        found = [s for s in self.timed if s.name == name and s.frame is not None]
        if not found:
            return None
        ms = sum(s.device_ms if clock == "device" else s.host_ms for s in found)
        return ms / self._frames(self.timed)

    def frame_counters(self) -> list:
        """Each counted frame's frame-span counters."""
        return [s.counters for s in self.counted if s.name == FRAME_SPAN]

    def dispatched_ops(self) -> list:
        """Each counted frame's dispatched ops plus kernel launches."""
        return [c["ops"] + c["launches"] for c in self.frame_counters()]

    def passes(self) -> list:
        """One row per span name, in first-open order, per frame: host,
        device and self ms and queue at open and close (means over the
        spans of timed frames), counts summed per counted frame."""
        rows = {}
        n_t = max(self._frames(self.timed), 1)
        n_c = max(self._frames(self.counted), 1)
        for s in self.timed:
            r = rows.setdefault(s.name, defaultdict(float))
            r["n"] += 1
            for key, value in (("host_ms", s.host_ms), ("device_ms", s.device_ms),
                               ("self_ms", s.self_device_ms),
                               ("queue_open_ms", s.queue_open_ms),
                               ("queue_close_ms", s.queue_close_ms)):
                r[key] += 0.0 if value is None else value
        for s in self.counted:
            r = rows.setdefault(s.name, defaultdict(float))
            for key in ("ops", "launches", "syncs"):
                r[key] += s.counters.get(key, 0) / n_c
        out = []
        for name, r in rows.items():
            n = r.pop("n", 0)
            row = {"pass": name, "per_frame": n / n_t}
            for key in ("host_ms", "device_ms", "self_ms"):
                row[key] = r[key] / n_t
            for key in ("queue_open_ms", "queue_close_ms"):
                row[key] = r[key] / n if n else None
            for key in ("ops", "launches", "syncs"):
                row[key] = r[key]
            out.append(row)
        return out

    def round_demand(self) -> list:
        """The peel's failing tiles per round beside the rounds' caps, per
        timed frame (the frame span's diagnostics)."""
        return [s.diagnostics["clip_round_demand"] for s in self.timed
                if s.name == FRAME_SPAN and s.diagnostics]

    def round_range(self) -> list:
        """Per re-race round: (fewest, most) failing tiles over the timed
        frames, and the round's cap."""
        rounds = self.round_demand()
        return [(min(d[k] for d, _ in rounds), max(d[k] for d, _ in rounds), cap)
                for k, cap in enumerate(rounds[0][1])] if rounds else []


def print_passes(program: ProgramSpans, out=sys.stderr) -> None:
    print(f"{'pass':24s} {'/frame':>6s} {'host ms':>9s} {'device ms':>9s} {'self ms':>9s} "
          f"{'queue open':>10s} {'queue close':>11s} {'ops':>8s} {'launches':>8s} {'syncs':>6s}",
          file=out)
    for r in program.passes():
        q = ["-" if r[k] is None else f"{r[k]:.3f}" for k in ("queue_open_ms", "queue_close_ms")]
        print(f"{r['pass']:24s} {r['per_frame']:6.1f} {r['host_ms']:9.3f} {r['device_ms']:9.3f} "
              f"{r['self_ms']:9.3f} {q[0]:>10s} {q[1]:>11s} {r['ops']:8.1f} "
              f"{r['launches']:8.1f} {r['syncs']:6.1f}", file=out)
    for k, (lo, hi, cap) in enumerate(program.round_range(), 1):
        print(f"clip_round_{k}: {lo}-{hi} failing tiles a peel over the timed frames "
              f"(cap {cap})", file=out)


def viewer(bench: dict, cell_name: str, seed: int, device, root: Path = ROOT):
    """The cell's viewer after its warm-up frames, as core/cell.py makes it."""
    from benchmark.core import program, registry, traffic

    cell = registry.find_cell(bench, cell_name)
    cfg = registry.load_config(bench, cell["config"], root)
    path = traffic.make_path(registry.load_traffic(cell["traffic"], root), seed)
    arrays = registry.scene_generator(cfg["generator"], root)(
        cfg["scene"], traffic.rng(seed, traffic.SCENE_STREAM))
    config = program.render_config(cfg, ray_traced_shadows=path.ray_traced_shadows)
    scene, dl, flags, bvh = program.build_scene(arrays, device, path.ray_traced_shadows)
    v = program.Viewer(cfg, path, scene, dl, flags, program.make_lights(cfg, device), config,
                       bvh, device)
    for _ in range(path.warmup_frames):
        v.render(v.step())
    return v


def measure(bench: dict, cell_name: str, seed: int, device, pairs: int, frames: int,
            warm_seconds: float) -> dict:
    v = viewer(bench, cell_name, seed, device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def render(v, params):
        return v.render(params)

    # frames back to back first, as a run's window runs before its stretches
    deadline = time.perf_counter() + warm_seconds
    while time.perf_counter() < deadline:
        render(v, v.step())
        sync()
    # per pair, in turns: bare, events alone, events and tracer, tracer alone
    kinds = {"bare": (False, False), "events": (False, True), "events_tracer": (True, True),
             "tracer": (True, False)}
    medians, timed, agree = defaultdict(list), [], []
    for _ in range(pairs):
        for kind, (traced, events) in kinds.items():
            spans, by_name, times = timed_stretch(v, render, sync, device, frames, traced,
                                                  events)
            medians[kind].append(statistics.median(times))
            if kind == "events_tracer":
                timed += spans
                one = ProgramSpans(spans, [])
                agree.append({name: [one.span_ms(name), by_name.get(name, 0.0) / frames]
                              for name in ("binning", "raster_clip_peel", "clip_alpha_test")})
    counted = counted_stretch(v, render, sync, device)
    counted_timing = counted_stretch(v, render, sync, device, timing=True)
    program = ProgramSpans(timed, counted)
    print_passes(program)
    return {
        "workload": cell_name, "seed": seed, "frames_per_stretch": frames,
        "clip_alpha_test.span_ms": program.span_ms("clip_alpha_test"),
        "clip_peel.host_ms": program.span_ms("raster_clip_peel", "host"),
        "clip_peel.device_ms": program.span_ms("raster_clip_peel"),
        "binning.device_ms": program.span_ms("binning"),
        "render_frame.dispatched_ops": program.dispatched_ops(),
        "render_frame.counters": program.frame_counters(),
        "render_frame.counters_timing_on": ProgramSpans([], counted_timing).frame_counters(),
        "frame_ms_medians": dict(medians),
        "span_ms_program_vs_events": agree,
        "round_demand": program.round_range(),
        "passes": program.passes(),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--warm-seconds", type=float, default=10.0)
    p.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = p.parse_args(argv)
    from benchmark.core import registry

    if not torch.cuda.is_available():
        print("error: needs a CUDA card", file=sys.stderr)
        return 2
    result = measure(registry.load_benchmark(), args.workload, args.seed & (2**64 - 1),
                     torch.device("cuda", 0), args.pairs, args.frames, args.warm_seconds)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
