#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's flagship frame once on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back):

1. device: a CUDA device must be present; prints the card's name and
   power limit (nvidia-smi) and torch.cuda.get_device_name().
2. build: compiles the four CUDA kernels (transmission_renderer_tpu_torch/
   csrc) with nvcc into the package's _build/ directory.
3. scene: the flagship exactly as tests/golden_defs.py::render_hd_golden
   builds it: the procedural DragonAttenuation analogue (roughness 0.25,
   default detail), 1920x1080, camera (0, 2.2, 1.5) pitch -0.25, sun yaw
   4.8, the two point lights of bench.py.
4. kernel parity: every kernel's inputs are captured from one frame and
   replayed through the kernel and its plain PyTorch version on the card:
   raster tri/material equal, depth <= 1e-7, attributes atol 1e-4 /
   rtol 1e-3; material tap <= 1e-6; shade <= 1e-5 on all but <= 0.05% of
   the pixels; transmission fetch <= 1e-6.
5. frame: one frame with the launch counts reset first; it must launch
   raster 2, tap 1, shade 2, fetch 1 times, give a finite image in
   [0, 1], report no capacity overflow, and match the stored golden
   tests/goldens/dragon_hd.png at sRGB RMSE < 4e-3 outside the few tiles
   where the golden's own raster path dropped triangles (see
   GOLDEN_DROPPED_TILES; the whole-frame RMSE is printed too).
6. timing: 3 warm-up frames, then 20 frames timed with CUDA events
   (median ms/frame, fps), per-pass ms from the profiler ranges, and each
   kernel's ms per frame beside its plain version's.

The second-to-last lines are the kernels JSON object and the card's name
and power limit; the last line is the result JSON object.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of fn() over reps runs (CUDA events, one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# parity: kernel vs plain version on the same captured inputs
# ---------------------------------------------------------------------------

def _diff(got, ref):
    """(max abs difference, [(|got - ref|, ref) per plane]), NaN on both
    sides counting as equal."""
    import torch

    if isinstance(got, dict):
        got, ref = [got[k] for k in ref], [ref[k] for k in ref]
    out = []
    for g, r in zip(got, ref):
        d = (g.to(torch.float64) - r.to(torch.float64)).abs()
        out.append((torch.where(torch.isnan(g) & torch.isnan(r), 0.0, d), r))
    return max(float(d.max()) for d, _ in out), out


def parity(name, got, ref):
    """(max_abs_err, differing count, within tolerance) for one call."""
    err, diffs = _diff(got, ref)
    if name == "raster_gbuf":
        # tri/material exact, depth 1e-7, attributes atol 1e-4 / rtol 1e-3
        from transmission_renderer_tpu_torch.ops.raster_gbuf import INT_CHANNELS

        bad = 0
        for key, (d, r) in zip(ref, diffs):
            tol = (0.0 if key in INT_CHANNELS else 1e-7 if key == "depth"
                   else 1e-4 + 1e-3 * r.abs())
            bad += int((d > tol).sum())
        return err, bad, bad == 0
    if name == "shade":
        # 1e-5 on all but 0.05% of the pixels (log2f/cosf ulps can move a
        # cluster-boundary pixel to its neighbouring z-slice)
        import torch

        over = torch.stack([d for d, _ in diffs]) > 1e-5
        bad_px = int(over.any(dim=0).sum())
        return err, bad_px, bad_px <= 5e-4 * over.shape[1]
    bad = sum(int((d > 1e-6).sum()) for d, _ in diffs)  # tap and fetch
    return err, bad, bad == 0


# Tiles (row-major ids on the 15 x 135 grid of 128x8 tiles) whose bins
# the reference's pure-JAX raster path overflows on this frame.
# tests/goldens/dragon_hd.png was rendered by that path, which keeps at
# most max_tris_per_tile = 2048 triangles of a pass per tile and drops the
# rest. The list is the reference's own: bin_triangles of
# transmission_renderer_tpu/ops/raster.py at the golden's config gives
# the transmission pass raw counts 5456, 4160, 2443, 5145, 2409 there (no
# opaque tile overflows), and these are exactly the tiles where the golden
# differs from the same reference rendered with the cap raised to 8192.
# The G-buffer-kernel path the port follows has no such cap.
GOLDEN_DROPPED_TILES = (277, 292, 1192, 1207, 1222)


def golden_keep_mask(cfg):
    """[H, W] bool: False on the pixels of GOLDEN_DROPPED_TILES."""
    keep = np.ones(cfg.tiles_x * cfg.tiles_y, bool)
    keep[list(GOLDEN_DROPPED_TILES)] = False
    keep = keep.reshape(cfg.tiles_y, 1, cfg.tiles_x, 1)
    keep = np.broadcast_to(keep, (cfg.tiles_y, cfg.tile_h, cfg.tiles_x, cfg.tile_w))
    return keep.reshape(cfg.tiles_y * cfg.tile_h, -1)[: cfg.height, : cfg.width]


def main() -> int:
    import torch

    # ---- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = card_line()
    device_name = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch.cuda.get_device_name: {device_name}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    from transmission_renderer_tpu_torch import kernels
    from transmission_renderer_tpu_torch.config import RenderConfig
    from transmission_renderer_tpu_torch.models.procedural import build_dragon_scene
    from transmission_renderer_tpu_torch.ops import raster_gbuf, tap_finish
    from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
    from transmission_renderer_tpu_torch.render import shade_kernel
    from transmission_renderer_tpu_torch.render.frame import make_frame_params, render_frame
    from transmission_renderer_tpu_torch.scene.camera import CameraRig
    from transmission_renderer_tpu_torch.scene.textures import linear_to_srgb
    from transmission_renderer_tpu_torch.utils.png import read_png
    from transmission_renderer_tpu_torch.utils.profiling import PASS_NAMES

    # ---- 2. build ------------------------------------------------------------
    info = kernels.build()
    log(f"build: {'compiled' if info.built else 'up to date'} in "
        f"{info.seconds:.2f} s -> {os.path.relpath(info.path, ROOT)}")
    for line in info.log.splitlines():
        if "registers" in line or "error" in line.lower() or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 3. scene --------------------------------------------------------------
    t0 = time.perf_counter()
    scene, dl, flags = build_dragon_scene(roughness_override=0.25).finish_bundle(device=dev)
    cfg = RenderConfig(width=1920, height=1080)
    rig = CameraRig()
    rig.camera.position = np.array([0.0, 2.2, 1.5], np.float32)
    rig.camera.pitch = -0.25
    rig.sun_yaw = 4.8
    params = make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                               rig.sun_dir(), device=dev)
    lights = pack_lights([
        point_light([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0),
        point_light([8.0, 0.8, 0.0], [0.0, 1.0, 0.0], 10.0),
    ], device=dev)
    n_tris = int(dl.tri_vtx.shape[0])
    log(f"scene: dragon {n_tris} triangles, {cfg.width}x{cfg.height}, built in "
        f"{time.perf_counter() - t0:.2f} s, flags {flags}")

    def frame(**kw):
        return render_frame(scene, dl, params, lights, cfg, flags, **kw)

    handles = (raster_gbuf.KERNEL, tap_finish.TAP_KERNEL, shade_kernel.KERNEL,
               tap_finish.FETCH_KERNEL)

    # ---- 4. kernel parity at the path's own shapes -----------------------------
    for h in handles:
        h.recorder = []
    frame()
    torch.cuda.synchronize()
    calls = {h.name: h.recorder for h in handles}
    for h in handles:
        h.recorder = None
    max_err = {}
    for h in handles:
        require(len(calls[h.name]) > 0, f"{h.name}: the frame never called it")
        worst, ok_all = 0.0, True
        for i, call in enumerate(calls[h.name]):
            err, bad, ok = parity(h.name, h.replay(call, True), h.replay(call, False))
            torch.cuda.synchronize()
            log(f"parity {h.name}[{i}]: max_abs_err {err:.3e}, differing {bad}, "
                f"{'ok' if ok else 'FAIL'}")
            worst = max(worst, err)
            ok_all &= ok
        max_err[h.name] = worst
        require(ok_all, f"{h.name}: kernel disagrees with its plain version")

    # ---- 5. one frame through the kernels ------------------------------------
    for h in handles:
        h.launches = 0
    img, diag = frame(return_diagnostics=True)
    torch.cuda.synchronize()
    launches = {h.name: h.launches for h in handles}
    log(f"launches per frame: {launches}")
    expect = {"raster_gbuf": 2, "tap_finish": 1, "shade": 2, "transmission_fetch": 1}
    require(launches == expect, f"launch counts {launches}, expected {expect}")
    require(tuple(img.shape) == (1080, 1920, 3), f"image shape {tuple(img.shape)}")
    require(bool(torch.isfinite(img).all()), "image has non-finite values")
    lo, hi = float(img.min()), float(img.max())
    require(0.0 <= lo and hi <= 1.0, f"image outside [0, 1]: [{lo}, {hi}]")
    require(not diag.overflowed(), f"capacity overflow: {diag}")
    log(f"diagnostics: transmission tiles {int(diag.transmission_tiles)}/"
        f"{diag.transmission_tile_capacity}, transmission blocks "
        f"{int(diag.transmission_blocks)}/{diag.transmission_block_capacity}, "
        f"giant-tier demand {int(diag.big_tri_count)}/{diag.big_tri_capacity}, "
        f"tier overflow {int(diag.tier_overflow)}")
    golden = read_png(os.path.join(ROOT, "tests", "goldens", "dragon_hd.png"))[..., :3] / 255.0
    srgb = linear_to_srgb(img.cpu().numpy())
    keep = golden_keep_mask(cfg)
    rmse_full = float(np.sqrt(np.mean((srgb - golden) ** 2)))
    rmse = float(np.sqrt(np.mean((srgb[keep] - golden[keep]) ** 2)))
    excluded = int(keep.size - keep.sum())
    log(f"golden dragon_hd.png: sRGB RMSE {rmse:.6f} (limit 4e-3) outside the "
        f"{excluded} pixels of the tiles where the golden's raster path dropped "
        f"triangles (bin overflow); {rmse_full:.6f} over the whole frame")
    require(excluded <= 0.01 * keep.size,
            f"{excluded} pixels excluded: more than 1% of the frame")
    require(rmse < 4e-3, f"sRGB RMSE {rmse} vs golden")

    # ---- 6. timing ---------------------------------------------------------------
    for _ in range(3):
        frame()
    torch.cuda.synchronize()
    times = []
    for _ in range(20):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        frame()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    med = statistics.median(times)
    log(f"frame 1920x1080 on [{card}]: median {med:.3f} ms/frame "
        f"({1000.0 / med:.2f} fps), min {min(times):.3f}, max {max(times):.3f}")

    from torch.profiler import ProfilerActivity, profile

    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s.record()
        frame()
        e.record()
        torch.cuda.synchronize()
    span_ms = s.elapsed_time(e)
    # a pass name appears twice: its host range and its span on the GPU
    # timeline; kernel (self) device time, summed, is the busy time
    host_us = dict.fromkeys(PASS_NAMES, 0.0)
    dev_us = dict.fromkeys(PASS_NAMES, 0.0)
    busy_us = 0.0
    for ev in prof.key_averages():
        if ev.key in host_us:
            host_us[ev.key] = max(host_us[ev.key], ev.cpu_time_total)
            dev_us[ev.key] = max(dev_us[ev.key], ev.device_time_total)
        elif str(ev.device_type).endswith("CUDA"):  # kernels, copies, sets
            busy_us += ev.self_device_time_total
    log(f"per-pass ms on [{card}] (profiled frame, {span_ms:.3f} ms; profiler "
        f"ranges: span on the GPU timeline, host time):")
    for name in PASS_NAMES:
        log(f"  {name:20s} device {dev_us[name] / 1000.0:9.3f} ms   host "
            f"{host_us[name] / 1000.0:9.3f} ms")
    log(f"device busy (sum of kernel time) {busy_us / 1000.0:.3f} ms of the "
        f"{span_ms:.3f} ms profiled frame: idle share "
        f"{1.0 - busy_us / 1000.0 / span_ms:.3f} on [{card}]")

    kernel_rows = []
    for h in handles:
        k_ms = p_ms = 0.0
        for call in calls[h.name]:
            k_ms += cuda_ms(lambda: h.replay(call, True), 20)
            p_ms += cuda_ms(lambda: h.replay(call, False), 3)
        log(f"kernel {h.name} on [{card}]: {k_ms:.3f} ms/frame, plain "
            f"{p_ms:.3f} ms/frame ({len(calls[h.name])} call(s) per frame)")
        kernel_rows.append({
            "name": h.name, "route": "cuda", "source": h.source,
            "replaces": h.replaces, "launches": launches[h.name],
            "max_abs_err": max_err[h.name], "ms": k_ms, "plain_ms": p_ms,
        })

    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
