#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's flagship frames once on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back):

1. device: a CUDA device must be present; prints the card's name and
   power limit (nvidia-smi) and torch.cuda.get_device_name().
2. build: compiles the six CUDA kernels (transmission_renderer_tpu_torch/
   csrc), one nvcc per source in parallel, into the package's _build/.
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
7. ray-traced shadows: the same scene and camera with
   RenderConfig(width=1920, height=1080, ray_traced_shadows=True) and the
   scene's BVH. (a) the occlusion kernel's hit set equals its plain walk's
   exactly on both of the frame's calls; (b) every other kernel, the shade
   kernel now reading shadow factors, holds phase 4's tolerance on the
   frame's own inputs; (c) with the counts reset, the frame launches
   raster 2, tap 1, shade 2, fetch 1, bvh_occlusion 2; (d) its image is
   finite, in [0, 1], without overflow; its HDR image is nowhere brighter
   than the phase-5 frame's (shadows only remove light) and darker
   somewhere. The tonemapped image can brighten a channel where a
   coloured light is shadowed (the Lottes curve scales by the max
   channel), so that is printed, not held; (e) median ms/frame over 10 frames
   after 2 warm-ups, per-pass ms, each kernel's ms per frame beside its
   plain version's (the occlusion walk's plain version replayed once) and
   its bound, the ray counts, and the occlusion kernel timed on the
   frame's rays in their swizzled order and in row-major pixel order (in
   turns; the hits must agree); (f) the half_res_shadow_rays frame
   through the same checks: its two occlusion calls exact, the opaque
   shade reading fractional (upsampled) factors, every other kernel
   within phase 4's tolerance, the launches as in (c), a finite image
   within RMSE 0.03 of the full-res one (the bound of
   tests/test_rt_shadows.py), and its median ms/frame.
8. the visibility-buffer frame: the same scene and camera with
   RenderConfig(width=1920, height=1080, use_pallas_raster=False), the
   branch of the reference that rendered dragon_hd.png (materialised bins
   capped at 2048 triangles a tile, the visibility raster, the tensor
   shade). (a) kernel 6's two calls of the frame through the kernel and
   its plain version, in the frame's XLA-raster order and again in
   kernel-6 order: triangle ids equal, depth <= 1e-7, barycentrics
   <= 1e-6; (b) with the counts reset, the frame launches raster_vis 2
   and no other kernel; (c) its image is finite and in [0, 1], and its
   FrameDiagnostics equal the reference's for this frame
   (HD_VIS_DIAGNOSTICS: the busiest bin holds 5456 triangles against 2048,
   so overflowed() is true); (d) sRGB RMSE < 4e-3 against dragon_hd.png
   over the whole frame, the RMSE inside GOLDEN_DROPPED_TILES printed
   beside it; (e) median ms/frame over 10 frames after 2 warm-ups,
   per-pass ms, and kernel 6's ms per frame beside its plain version's
   (replayed once) and its bound.

The kernels JSON object reports every kernel on the widest path that
launches it: kernels 1-5 on the ray-traced frame (phase 7), kernel 6 on
the visibility-buffer frame (phase 8): launches, worst parity error over
every frame checked, ms per frame of the kernel and of its plain version,
and the least time the card could take (bound_ms, from the bytes and
operations of the frame's own calls, see kernel_work) with what bounds
it. library_ms is null: no single PyTorch call computes any of these
functions (PERF.md gives the reason for each).

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

# published peaks of one H100 SXM at its 700 W limit. Its 67 TFLOP/s of
# float32 outside the tensor cores counts a fused multiply-add as two
# operations; the kernels build with --fmad=false, so every operation that
# kernel_work counts (add, mul, min/max, compare) issues on its own, at
# half that rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2


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


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean device ms of fn() over reps runs (CUDA events; one warm-up
    unless told otherwise)."""
    import torch

    if warmup:
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


def timed_frames(frame, warmups: int, reps: int) -> list:
    """Per-frame device ms (CUDA events) after warm-ups."""
    import torch

    for _ in range(warmups):
        frame()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        frame()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return times


def profile_passes(frame, card: str, pass_names) -> None:
    """Per-pass device and host ms of one profiled frame, and the device's
    idle share over it."""
    import torch
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
    host_us = dict.fromkeys(pass_names, 0.0)
    dev_us = dict.fromkeys(pass_names, 0.0)
    busy_us = 0.0
    for ev in prof.key_averages():
        if ev.key in host_us:
            host_us[ev.key] = max(host_us[ev.key], ev.cpu_time_total)
            dev_us[ev.key] = max(dev_us[ev.key], ev.device_time_total)
        elif str(ev.device_type).endswith("CUDA"):  # kernels, copies, sets
            busy_us += ev.self_device_time_total
    log(f"per-pass ms on [{card}] (profiled frame, {span_ms:.3f} ms; profiler "
        f"ranges: span on the GPU timeline, host time):")
    for name in pass_names:
        log(f"  {name:24s} device {dev_us[name] / 1000.0:9.3f} ms   host "
            f"{host_us[name] / 1000.0:9.3f} ms")
    log(f"device busy (sum of kernel time) {busy_us / 1000.0:.3f} ms of the "
        f"{span_ms:.3f} ms profiled frame: idle share "
        f"{1.0 - busy_us / 1000.0 / span_ms:.3f} on [{card}]")


# ---------------------------------------------------------------------------
# the least time the card could take for a kernel call
# ---------------------------------------------------------------------------

def kernel_work(name: str, call, pops=None) -> tuple:
    """(bytes, operations) that one recorded call must move and compute:
    each input byte it needs read once, each output byte written once;
    operations counted from the kernel's arithmetic on this call's own
    data (records per tile, lights per pixel, the walk's pops)."""
    import torch

    args, kwargs = call
    if name == "raster_gbuf":
        from transmission_renderer_tpu_torch.ops.raster_gbuf import (
            TILE_H, TILE_W, active_channels)

        _, tile_ids, tile_start, _, width, height = args
        tiles = -(-width // TILE_W) * -(-height // TILE_H)
        nc = (tile_start.numel() - 1) // tiles
        pc = kwargs.get("pass_class")
        base = tile_ids.long() * nc
        lo = tile_start[base + (0 if pc is None else pc)]
        hi = tile_start[base + (nc if pc is None else pc + 1)]
        recs = int((hi - lo).sum())
        px = tile_ids.numel() * TILE_H * TILE_W
        planes = len(active_channels(kwargs.get("pos_derivs", True),
                                     kwargs.get("uv_channels", True)))
        seeds = 1 + (kwargs.get("max_depth_tiles") is not None)
        # 42 of a record's 64 floats are read; per pixel and record three
        # edge functions, the 1/w and z sums, a divide and 8 tests
        nbytes = recs * 42 * 4 + tile_ids.numel() * 12 + px * 4 * (seeds + planes)
        return nbytes, recs * TILE_H * TILE_W * 31
    if name == "tap_finish":
        quads, rows, uv, lod, _, classes = args
        m, lmax = uv.shape[0], max(classes)
        # the atlas read once; trilinear: 8 weighted taps of 4 channels
        nbytes = quads.nbytes + rows.nbytes + uv.nbytes + lod.nbytes + 4 * lmax * m * 4
        return nbytes, m * lmax * 4 * 8 * 2
    if name == "shade":
        from transmission_renderer_tpu_torch.render.shade_kernel import (
            N_TRANS_OUT, pixel_clusters)

        inp, spec = args
        m = inp.mid.shape[0]
        nbytes = sum(t.nbytes for t in inp if isinstance(t, torch.Tensor))
        nbytes += (N_TRANS_OUT if spec.transmission else 3) * m * 4
        blk = torch.arange(m, device=inp.mid.device) // 128
        lane = (torch.arange(m, device=inp.mid.device) % 128).to(torch.float32)
        cl = pixel_clusters(spec, inp.pix[6], inp.block_px0[blk].to(torch.float32) + lane,
                            inp.block_py[blk].to(torch.float32)).long()
        lights = int(torch.clamp(inp.counts[cl], max=inp.indices.shape[1]).sum())
        # ~200 flops of material and view set-up per pixel and ~250 per
        # light (the sun included) through basic_brdf; transmission adds
        # the BTDF and the refraction ray (~350 + ~400 per light)
        base, per = (350, 400) if spec.transmission else (200, 250)
        return nbytes, m * base + (m + lights) * per
    if name == "transmission_fetch":
        pyramid, level_set, uv_x = args[0], args[1], args[2]
        m = uv_x.shape[0]
        levels = sum(pyramid.levels[k].nbytes for k in level_set)
        # 5 planes in, 5 out; two tent-weighted bilinear level taps of 3
        # channels and a bilinear LUT tap of 2
        return 5 * m * 4 + levels + args[7].nbytes + 5 * m * 4, m * 80
    if name == "raster_vis":
        recs, big, tile_ids, _, run_count, big_count, _, _, tile_w, tile_h = args
        k, px = tile_ids.numel(), tile_ids.numel() * tile_w * tile_h
        runs, nbig = int(run_count.sum()), int(big_count[0])
        seeded = kwargs.get("init_depth_tiles") is not None
        # each walked record (16 floats) read once, the tile list, the seed
        # depth, and the four [K, th, tw] outputs; per pixel and record
        # three edge functions, the w and z sums, a divide and 8 tests
        nbytes = (runs + nbig) * 64 + k * 12 + 4 + px * 4 * (seeded + 4)
        return nbytes, (runs + k * nbig) * tile_w * tile_h * 31
    if name == "bvh_occlusion":
        _, table, rays, _ = args
        inner, leaf = pops
        # a slab test: 6 sub, 6 mul, 10 min/max, 3 compares; a
        # Moller-Trumbore test ~55 (the plain walk tests the whole leaf)
        return table.nbytes + rays.nbytes + rays.shape[1], inner * 8 * 25 + leaf * 16 * 55
    raise KeyError(name)


def bound_of(works) -> tuple:
    """(least ms summed over the calls, "bytes" or "operations": what
    bounds the larger part of it)."""
    total, by = 0.0, {"bytes": 0.0, "operations": 0.0}
    for nbytes, ops in works:
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
        total += max(t_b, t_o)
        by["bytes" if t_b >= t_o else "operations"] += max(t_b, t_o)
    return total, max(by, key=by.get)


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
    if name == "raster_vis":
        # tri ids equal, depth 1e-7, barycentrics 1e-6
        bad = sum(int((d > tol).sum()) for (d, _), tol in zip(diffs, (0.0, 1e-7, 1e-6, 1e-6)))
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


def check_parity(handles, calls, max_err, tag: str) -> None:
    """Replay every recorded call through the kernel and the plain
    version; raise on a disagreement."""
    import torch

    for h in handles:
        require(len(calls[h.name]) > 0, f"{h.name}: the frame never called it")
        for i, call in enumerate(calls[h.name]):
            err, bad, ok = parity(h.name, h.replay(call, True), h.replay(call, False))
            torch.cuda.synchronize()
            log(f"parity {tag}{h.name}[{i}]: max_abs_err {err:.3e}, differing {bad}, "
                f"{'ok' if ok else 'FAIL'}")
            max_err[h.name] = max(max_err.get(h.name, 0.0), err)
            require(ok, f"{h.name}: kernel disagrees with its plain version")


def check_occlusion(calls, n_kinds: int, tag: str) -> list:
    """Replay each recorded occlusion call through the kernel and the plain
    walk; raise unless the hit sets are equal. -> per call (inner pops,
    leaf pops, rays, live rays, sun rays hit); the sun's rays come first."""
    import torch
    from transmission_renderer_tpu_torch.ops import bvh_packet
    from transmission_renderer_tpu_torch.ops.bvh import occlusion_walk

    require(len(calls) == 2, f"bvh_occlusion: {len(calls)} calls, expected 2")
    rows = []
    for i, call in enumerate(calls):
        tree, table, rays, t_min = call[0]
        got = bvh_packet.KERNEL.replay(call, True)
        ref, inner, leaf = occlusion_walk(tree, table, rays, t_min)
        torch.cuda.synchronize()
        bad = int((got != ref).sum())
        n = rays.shape[1]
        rows.append((int(inner.sum()), int(leaf.sum()), n, int((rays[9] > t_min).sum()),
                     int(got[: n // n_kinds].sum())))
        log(f"parity {tag}bvh_occlusion[{i}]: {n} rays ({rows[-1][3]} live), hits "
            f"{int(got.sum())}, differing {bad}, inner pops {rows[-1][0]}, leaf pops "
            f"{rows[-1][1]}, {'ok' if bad == 0 else 'FAIL'}")
        require(bad == 0, "bvh_occlusion: the kernel's hit set differs from its plain walk")
    return rows


def row_major(call, shape: tuple, mode: str, n_kinds: int):
    """(the recorded occlusion call with its rays put back from the
    frame's swizzled order into row-major pixel order, [n] lane of each
    row-major pixel in the swizzled order)."""
    import torch
    from transmission_renderer_tpu_torch.render.raytrace import _packet_swizzle_fns

    (tree, table, rays, t_min), kw = call
    n = rays.shape[1] // n_kinds
    swz, _ = _packet_swizzle_fns(shape, mode)
    lane_px = swz(torch.arange(n, device=rays.device).reshape(shape)).reshape(-1)
    lane = torch.empty_like(lane_px)
    lane[lane_px] = torch.arange(n, device=rays.device)
    rays_rm = rays.reshape(10, n_kinds, n)[:, :, lane].reshape(10, -1).contiguous()
    return ((tree, table, rays_rm, t_min), kw), lane


def capture(handles, frame) -> dict:
    """{kernel name: recorded calls} of one frame."""
    import torch

    for h in handles:
        h.recorder = []
    frame()
    torch.cuda.synchronize()
    calls = {h.name: h.recorder for h in handles}
    for h in handles:
        h.recorder = None
    return calls


def count_launches(handles, frame, **kw):
    """(frame's result, {kernel name: launches}) with the counts reset
    just before the frame."""
    import torch

    for h in handles:
        h.launches = 0
    out = frame(**kw)
    torch.cuda.synchronize()
    return out, {h.name: h.launches for h in handles}


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


# FrameDiagnostics of the reference's visibility-buffer frame at the
# golden's config (render_frame(golden_defs.CFG_HD) on the CPU, the branch
# that rendered dragon_hd.png), read once from the reference and pinned:
# the transmission pass's busiest bin holds 5456 triangles against the
# 2048 the bins keep, so overflowed() is true. tests/test_torch_frame.py
# and tests/test_torch_vis_frame.py recompute the binning-decided fields.
HD_VIS_DIAGNOSTICS = {
    "max_bin_count": 5456, "bin_capacity": 2048, "big_tri_count": 4,
    "big_tri_capacity": 256, "opaque_blocks": 0, "opaque_block_capacity": 0,
    "transmission_blocks": 2156, "transmission_block_capacity": 4050,
    "clip_unresolved": 0, "mid_tri_count": 0, "mid_tri_capacity": 0,
    "transmission_tiles": 0, "transmission_tile_capacity": 0, "clip_tiles": 0,
    "clip_tile_capacity": 0, "tier_overflow": 0, "clip_round_demand": (),
    "clip_round_caps": (), "pair_demand": 0, "pair_capacity": 0,
}


def diagnostics_dict(diag) -> dict:
    """FrameDiagnostics -> {field: int, or tuple of ints}."""
    return {f: tuple(int(x) for x in v) if isinstance(v, tuple) else int(v)
            for f, v in zip(diag._fields, diag)}


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
    from transmission_renderer_tpu_torch.ops import bvh_packet, raster_gbuf, raster_vis, tap_finish
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
    builder = build_dragon_scene(roughness_override=0.25)
    scene, dl, flags = builder.finish_bundle(device=dev)
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
    calls = capture(handles, frame)
    max_err = {}
    check_parity(handles, calls, max_err, "")

    # ---- 5. one frame through the kernels ------------------------------------
    (img, hdr, diag), launches = count_launches(handles, frame, return_hdr=True,
                                                return_diagnostics=True)
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
    times = timed_frames(frame, 3, 20)
    med = statistics.median(times)
    log(f"frame 1920x1080 on [{card}]: median {med:.3f} ms/frame "
        f"({1000.0 / med:.2f} fps), min {min(times):.3f}, max {max(times):.3f}")
    profile_passes(frame, card, PASS_NAMES)
    for h in handles:
        k_ms = p_ms = 0.0
        for call in calls[h.name]:
            k_ms += cuda_ms(lambda: h.replay(call, True), 20)
            p_ms += cuda_ms(lambda: h.replay(call, False), 3)
        log(f"kernel {h.name} on [{card}]: {k_ms:.3f} ms/frame, plain "
            f"{p_ms:.3f} ms/frame ({len(calls[h.name])} call(s) per frame)")

    # ---- 7. ray-traced shadows ---------------------------------------------------
    cfg_rt = RenderConfig(width=1920, height=1080, ray_traced_shadows=True)
    t0 = time.perf_counter()
    bvh = builder.build_rt_bvh(device=dev)
    log(f"rt: BVH over {bvh.num_tris} triangles, {bvh.num_leaves} leaves, levels "
        f"{bvh.level_counts}, built in {time.perf_counter() - t0:.2f} s")

    def rt_frame(**kw):
        return render_frame(scene, dl, params, lights, cfg_rt, flags, bvh=bvh, **kw)

    rt_handles = handles + (bvh_packet.KERNEL,)
    # (a) the occlusion kernel's hit set, exactly; the plain walk also
    # counts the pops that the bound's operations come from
    n_kinds = 1 + lights.num  # the sun and each light
    rt_calls = capture(rt_handles, rt_frame)
    occl = check_occlusion(rt_calls["bvh_occlusion"], n_kinds, "rt ")
    pops = [(r[0], r[1]) for r in occl]
    max_err["bvh_occlusion"] = 0.0
    log(f"rt rays: {sum(r[2] for r in occl)} traced, {sum(r[3] for r in occl)} live "
        f"(the rest are invalid pixels and cluster-gated lights); shadowed sun rays: "
        f"opaque pass {occl[0][4]}, transmission pass {occl[1][4]}")
    # (b) every other kernel on the ray-traced frame's inputs
    require(all(c[0][0].sun_f is not None and c[0][0].light_f is not None
                for c in rt_calls["shade"]), "shade: the rt frame passed no shadow factors")
    check_parity(handles, rt_calls, max_err, "rt ")

    # (c) + (d) one ray-traced frame through the kernels
    (img_rt, hdr_rt, diag), rt_launches = count_launches(
        rt_handles, rt_frame, return_hdr=True, return_diagnostics=True)
    log(f"rt launches per frame: {rt_launches}")
    expect = {"raster_gbuf": 2, "tap_finish": 1, "shade": 2, "transmission_fetch": 1,
              "bvh_occlusion": 2}
    require(rt_launches == expect, f"rt launch counts {rt_launches}, expected {expect}")
    require(tuple(img_rt.shape) == (1080, 1920, 3), f"rt image shape {tuple(img_rt.shape)}")
    require(bool(torch.isfinite(img_rt).all()), "rt image has non-finite values")
    lo, hi = float(img_rt.min()), float(img_rt.max())
    require(0.0 <= lo and hi <= 1.0, f"rt image outside [0, 1]: [{lo}, {hi}]")
    require(not diag.overflowed(), f"rt capacity overflow: {diag}")
    brighter = float((hdr_rt - hdr).max())
    darker = int(((hdr - hdr_rt).amax(dim=-1) > 0.05).sum())
    log(f"rt HDR image vs the phase-5 frame's: at most {brighter:.3e} brighter; "
        f"{darker} pixels darker by more than 0.05; tonemapped, at most "
        f"{float((img_rt - img).max()):.3e} brighter in a channel")
    require(brighter <= 1e-5, f"shadows brightened an HDR pixel by {brighter}")
    require(darker > 0, "no pixel darkened by the shadows")

    # (e) timing
    times = timed_frames(rt_frame, 2, 10)
    med = statistics.median(times)
    log(f"rt frame 1920x1080 on [{card}]: median {med:.3f} ms/frame "
        f"({1000.0 / med:.2f} fps), min {min(times):.3f}, max {max(times):.3f}")
    profile_passes(rt_frame, card, PASS_NAMES)
    kernel_rows = []
    for h in rt_handles:
        k_ms = p_ms = 0.0
        for call in rt_calls[h.name]:
            k_ms += cuda_ms(lambda: h.replay(call, True), 20)
            if h.name == "bvh_occlusion":  # the plain walk takes seconds
                p_ms += cuda_ms(lambda: h.replay(call, False), 1, warmup=False)
            else:
                p_ms += cuda_ms(lambda: h.replay(call, False), 3)
        per_call = pops if h.name == "bvh_occlusion" else [None] * len(rt_calls[h.name])
        works = [kernel_work(h.name, c, p) for c, p in zip(rt_calls[h.name], per_call)]
        b_ms, b_by = bound_of(works)
        log(f"rt kernel {h.name} on [{card}]: {k_ms:.3f} ms/frame, plain {p_ms:.3f} "
            f"ms/frame, bound {b_ms:.4f} ms by {b_by} ({sum(w[0] for w in works)} "
            f"bytes, {sum(w[1] for w in works)} operations), {b_ms / k_ms:.4f} of "
            f"the bound reached, {len(rt_calls[h.name])} call(s) per frame")
        kernel_rows.append({
            "name": h.name, "route": "cuda", "source": h.source,
            "replaces": h.replaces, "launches": rt_launches[h.name],
            "max_abs_err": None, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })

    # the ray order: the swizzled order the frame traces in ("2d" opaque,
    # "tiles" transmission) against row-major pixel order, in turns
    occl_calls = rt_calls["bvh_occlusion"]
    shapes = [(cfg_rt.height, cfg_rt.width),
              (occl_calls[1][0][2].shape[1] // n_kinds,)]
    sw_ms = rm_ms = 0.0
    for call, shape, mode in zip(occl_calls, shapes, ("2d", "tiles")):
        call_rm, lane = row_major(call, shape, mode, n_kinds)
        got_sw = bvh_packet.KERNEL.replay(call, True).reshape(n_kinds, -1)[:, lane]
        got_rm = bvh_packet.KERNEL.replay(call_rm, True).reshape(n_kinds, -1)
        require(torch.equal(got_sw, got_rm), f"bvh_occlusion: the {mode} order changed a hit")
        turns = [cuda_ms(lambda c=c: bvh_packet.KERNEL.replay(c, True), 10)
                 for c in (call, call_rm, call_rm, call)]
        sw_ms += (turns[0] + turns[3]) / 2
        rm_ms += (turns[1] + turns[2]) / 2
    log(f"rt kernel bvh_occlusion ray order on [{card}]: swizzled {sw_ms:.3f} ms/frame, "
        f"row-major {rm_ms:.3f} ms/frame (same hits)")

    # (f) the half-res shadow-ray variant, through the same checks
    cfg_half = RenderConfig(width=1920, height=1080, ray_traced_shadows=True,
                            half_res_shadow_rays=True)

    def half_frame(**kw):
        return render_frame(scene, dl, params, lights, cfg_half, flags, bvh=bvh, **kw)

    half_calls = capture(rt_handles, half_frame)
    occl_h = check_occlusion(half_calls["bvh_occlusion"], n_kinds, "half-res ")
    log(f"half-res rays: {sum(r[2] for r in occl_h)} traced, "
        f"{sum(r[3] for r in occl_h)} live")
    # the opaque shade reads the upsampled factors: 0.25, 0.5 and 0.75
    # along shadow edges
    inp_o = half_calls["shade"][0][0][0]
    frac = [int(((f > 0.0) & (f < 1.0)).sum()) for f in (inp_o.sun_f, inp_o.light_f)]
    log(f"half-res opaque shade: {frac[0]} fractional sun factors, {frac[1]} "
        f"fractional light factors")
    require(frac[0] > 0, "half-res: the opaque shade read no fractional sun factor")
    check_parity(handles, half_calls, max_err, "half-res ")
    half, half_launches = count_launches(rt_handles, half_frame)
    log(f"half-res launches per frame: {half_launches}")
    require(half_launches == expect,
            f"half-res launch counts {half_launches}, expected {expect}")
    require(bool(torch.isfinite(half).all()), "half-res rt image has non-finite values")
    rmse = float(((half - img_rt) ** 2).mean().sqrt())
    log(f"rt half-res shadow rays: RMSE {rmse:.6f} against the full-res rt frame "
        f"(limit 0.03)")
    require(rmse < 0.03, f"half-res rt RMSE {rmse}")
    times = timed_frames(half_frame, 2, 10)
    med = statistics.median(times)
    log(f"rt half-res frame 1920x1080 on [{card}]: median {med:.3f} ms/frame "
        f"({1000.0 / med:.2f} fps), min {min(times):.3f}, max {max(times):.3f}")

    # ---- 8. the visibility-buffer frame ------------------------------------------
    cfg_vis = RenderConfig(width=1920, height=1080, use_pallas_raster=False)

    def vis_frame(**kw):
        return render_frame(scene, dl, params, lights, cfg_vis, flags, **kw)

    vis_handles = rt_handles + (raster_vis.KERNEL,)
    # (a) kernel 6 on the frame's own inputs, in both orders
    vis_calls = capture((raster_vis.KERNEL,), vis_frame)
    require(len(vis_calls["raster_vis"]) == 2,
            f"raster_vis: {len(vis_calls['raster_vis'])} calls, expected 2")
    check_parity((raster_vis.KERNEL,), vis_calls, max_err, "vis ")
    k6_calls = {"raster_vis": [(a, dict(kw, xla_order=False))
                               for a, kw in vis_calls["raster_vis"]]}
    check_parity((raster_vis.KERNEL,), k6_calls, max_err, "vis kernel-6 order ")

    # (b) + (c) one frame with the counts reset
    (img_vis, diag), vis_launches = count_launches(vis_handles, vis_frame,
                                                   return_diagnostics=True)
    log(f"vis launches per frame: {vis_launches}")
    expect = dict.fromkeys(vis_launches, 0)
    expect["raster_vis"] = 2
    require(vis_launches == expect, f"vis launch counts {vis_launches}, expected {expect}")
    require(tuple(img_vis.shape) == (1080, 1920, 3), f"vis image shape {tuple(img_vis.shape)}")
    require(bool(torch.isfinite(img_vis).all()), "vis image has non-finite values")
    lo, hi = float(img_vis.min()), float(img_vis.max())
    require(0.0 <= lo and hi <= 1.0, f"vis image outside [0, 1]: [{lo}, {hi}]")
    got_diag = diagnostics_dict(diag)
    log(f"vis diagnostics: {got_diag}, overflowed {diag.overflowed()}")
    bad = {f: (v, HD_VIS_DIAGNOSTICS[f]) for f, v in got_diag.items()
           if v != HD_VIS_DIAGNOSTICS[f]}
    require(not bad, f"vis diagnostics differ from the reference's (got, expected): {bad}")
    require(diag.overflowed(), "vis: the reference's bins overflow on this frame")

    # (d) the golden, whole frame
    srgb = linear_to_srgb(img_vis.cpu().numpy())
    rmse_full = float(np.sqrt(np.mean((srgb - golden) ** 2)))
    rmse_in = float(np.sqrt(np.mean((srgb[~keep] - golden[~keep]) ** 2)))
    rmse_out = float(np.sqrt(np.mean((srgb[keep] - golden[keep]) ** 2)))
    log(f"vis golden dragon_hd.png: sRGB RMSE {rmse_full:.6f} over the whole frame "
        f"(limit 4e-3); {rmse_in:.6f} inside the {excluded} pixels of "
        f"GOLDEN_DROPPED_TILES, {rmse_out:.6f} outside them")
    require(rmse_full < 4e-3, f"vis sRGB RMSE {rmse_full} vs golden")

    # (e) timing
    times = timed_frames(vis_frame, 2, 10)
    med = statistics.median(times)
    log(f"vis frame 1920x1080 on [{card}]: median {med:.3f} ms/frame "
        f"({1000.0 / med:.2f} fps), min {min(times):.3f}, max {max(times):.3f}")
    profile_passes(vis_frame, card, PASS_NAMES)
    h = raster_vis.KERNEL
    k_ms = p_ms = 0.0
    for call in vis_calls[h.name]:
        k_ms += cuda_ms(lambda: h.replay(call, True), 20)
        p_ms += cuda_ms(lambda: h.replay(call, False), 1, warmup=False)
    works = [kernel_work(h.name, c) for c in vis_calls[h.name]]
    b_ms, b_by = bound_of(works)
    log(f"vis kernel {h.name} on [{card}]: {k_ms:.3f} ms/frame, plain {p_ms:.3f} "
        f"ms/frame, bound {b_ms:.4f} ms by {b_by} ({sum(w[0] for w in works)} bytes, "
        f"{sum(w[1] for w in works)} operations), {b_ms / k_ms:.4f} of the bound "
        f"reached, {len(vis_calls[h.name])} call(s) per frame")
    kernel_rows.append({
        "name": h.name, "route": "cuda", "source": h.source, "replaces": h.replaces,
        "launches": vis_launches[h.name], "max_abs_err": None, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    })

    for row in kernel_rows:  # the worst over every frame checked
        row["max_abs_err"] = max_err[row["name"]]
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
