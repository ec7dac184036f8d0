"""One run of one cell: set-up, warm-up, the measured window, the traced
stretch, the check against the plain reference, and the result line.

The loop is closed: one viewer, frames back to back with one in flight.
A frame is timed on the host clock from the start of its camera update
to the return of ``torch.cuda.synchronize()`` after ``render_frame``.
The window starts frames until ``seconds`` have passed and the frames
it checks are in; ``frame_ms`` is its wall time over the frames it
completed and ``frame_p95_ms`` the 95th percentile of their times. A
frame fails when it raises or when its diagnostics report an overflow
(read after the window, so no frame waits on them). The window runs
alike with and without ``--trace``: a traced run times its passes with
CUDA events over a stretch of frames, and then profiles a second stretch,
only once the window has closed, so the host readings of its window (the
enqueue time, the frame time the idle share is read against) come from
frames that no profiler slowed.
"""

from __future__ import annotations

import os
import statistics
import sys
import time
from pathlib import Path

import torch

from benchmark.core import check, program, registry, traffic
from benchmark.core.spans import EventSpans
from benchmark.core.trace import FRAME_RANGE, Trace
from benchmark.work import counts
from transmission_renderer_tpu_torch.ops import bvh_packet, raster_gbuf

# the kernels whose calls the traced run records, for their work
RECORDED = {"raster_gbuf": raster_gbuf.KERNEL, "bvh_occlusion": bvh_packet.KERNEL}

OUT = registry.ROOT / "benchmark" / "_out"
# frames of each of the traced run's stretches, after its window
TRACE_FRAMES = 12


def _quantile(values: list, q: float) -> float:
    """The q-quantile of ``values`` (linear between order statistics)."""
    v = sorted(values)
    pos = (len(v) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def run(bench: dict, cell_name: str, seed: int, seconds: float, traced: bool, device,
        t_start: float, root: Path = registry.ROOT, render_hook=None) -> dict:
    """-> the result line's dict. ``render_hook(viewer, params)`` stands in
    for the frame's call (the tests' broken frames)."""
    cell = registry.find_cell(bench, cell_name)
    cfg = registry.load_config(bench, cell["config"], root)
    mix = registry.load_traffic(cell["traffic"], root)
    path = traffic.make_path(mix, seed)
    arrays = registry.scene_generator(cfg["generator"], root)(
        cfg["scene"], traffic.rng(seed, traffic.SCENE_STREAM))
    config = program.render_config(cfg, ray_traced_shadows=path.ray_traced_shadows)
    scene, dl, flags, bvh = program.build_scene(arrays, device, path.ray_traced_shadows)
    lights = program.make_lights(cfg, device)

    def viewer():
        return program.Viewer(cfg, path, scene, dl, flags, lights, config, bvh, device)

    render = render_hook or (lambda v, p: v.render(p))
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    # warm-up: the first frames of the path, then the window starts over
    v = viewer()
    for _ in range(path.warmup_frames):
        render(v, v.step())
    sync()
    v = viewer()
    setup_s = time.time() - t_start

    times, enqueue, diags, kept = [], [], [], {}
    failed = attempted = 0
    # the window runs on until the checked frames are in
    last = max(path.checked)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        k = v.frame
        attempted += 1
        ta = time.perf_counter()
        try:
            params = v.step()
            tc = time.perf_counter()
            image, diag = render(v, params)
            t_ret = time.perf_counter()
            sync()
        except Exception as exc:  # a frame that raises is a failed frame
            print(f"frame {k} raised {type(exc).__name__}: {exc}", flush=True)
            failed += 1
            v.frame = k + 1
            if time.perf_counter() >= deadline and k >= last:
                break
            continue
        tb = time.perf_counter()
        times.append(tb - ta)
        enqueue.append((t_ret - tc) * 1e3)
        diags.append(diag)
        if k in path.checked:
            kept[k] = image
        if tb >= deadline and k >= last:
            break
    window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed += sum(bool(d.overflowed()) for d in diags)
    completed = len(times)
    frame_ms = window * 1e3 / max(completed, 1)
    spans = _span_stretch(v, render, sync, device) if traced else {}
    calls = _profiled_stretch(v, render, sync) if traced else {}

    result = {"correct": None, "attempted": attempted, "failed": failed}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    metrics = {}
    if traced:
        OUT.mkdir(parents=True, exist_ok=True)
        trace_path = OUT / f"{cell_name}.trace.json"
        calls.pop("profiler").export_chrome_trace(str(trace_path))
        work = {name: [counts.kernel_work(name, call) for call in recorded]
                for name, recorded in calls.items()}
        try:
            tr = Trace(str(trace_path), TRACE_FRAMES, enqueue, frame_ms, spans, work)
        finally:
            trace_path.unlink()
        for m in registry.cell_metrics(bench, cell_name, "per_layer"):
            value = registry.metric_reader(m["name"], root)(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    else:
        p95 = _quantile([t * 1e3 for t in times], 0.95)
        values = {"frame_ms": frame_ms, "frame_p95_ms": p95, "setup_s": setup_s}
        for m in registry.cell_metrics(bench, cell_name, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    print(f"window: {completed} frames in {window:.3f} s, frame ms median "
          f"{statistics.median(times) * 1e3 if times else float('nan'):.3f}, set-up "
          f"{setup_s:.3f} s, checked frames {sorted(kept)}", flush=True)

    # the check: the program's state goes first, then the reference runs
    limits = cfg["check"]
    del v, scene, dl, bvh, diags, calls
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = _check(arrays, cfg, path, kept, device, limits)
    result["correct"] = bool(kept) and all(n["value"] <= n["limit"] for n in numbers.values())
    result["metrics"] = metrics
    result["device"] = dev_info
    result["checks"] = numbers
    return result


def _check(arrays, cfg, path, kept: dict, device, limits: dict) -> dict:
    """The largest of each compared number over the checked frames, with its limit."""
    worst = {}
    if kept:
        refs = check.reference_frames(arrays, cfg, path, sorted(kept), device)
        for k, image in kept.items():
            for name, value in check.compare(image, refs[k]).items():
                worst[name] = max(worst.get(name, 0.0), value)
    return {name: {"value": worst.get(name, float("inf")), "limit": limit}
            for name, limit in limits.items()}


def _span_stretch(v, render, sync, device) -> dict:
    """TRACE_FRAMES more frames of the viewer's path with the passes'
    ranges timed by CUDA events (benchmark/core/spans.py) -> {range name:
    ms per frame}."""
    rec = EventSpans(device)
    with rec.recording():
        for _ in range(TRACE_FRAMES):
            render(v, v.step())
            sync()
    return {name: ms / TRACE_FRAMES for name, ms in rec.ms_by_name().items()}


def _profiled_stretch(v, render, sync) -> dict:
    """TRACE_FRAMES more frames of the viewer's path under the profiler
    (CPU and CUDA activity), each in a FRAME_RANGE range, with the
    recorded kernels' calls -> {kernel name: calls, "profiler": profile}.
    A frame that fails here leaves no trace to read, and the run fails."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    for h in RECORDED.values():
        h.recorder = []
    prof.start()
    try:
        for _ in range(TRACE_FRAMES):
            with torch.profiler.record_function(FRAME_RANGE):
                _, diag = render(v, v.step())
                sync()
            if diag.overflowed():
                raise RuntimeError(f"frame {v.frame - 1} of the profiled stretch overflowed")
    finally:
        prof.stop()
        calls = {name: h.recorder for name, h in RECORDED.items()}
        for h in RECORDED.values():
            h.recorder = None
    calls["profiler"] = prof
    return calls


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process,
    compared by whole top-level name."""
    banned = {"jax", "jaxlib", "flax", "transmission_renderer_tpu"}
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in banned})


def clean_environment() -> None:
    """The program reads TRTPU_GGX_LUT for an external GGX table; the
    benchmark renders with the table it bakes, as the reference does."""
    os.environ.pop("TRTPU_GGX_LUT", None)
