#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's frames of the bench's scenes once on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times

The second form only builds the kernels, captures every kernel's calls
on the widest frame that launches it (kernels 1-5 on phase 7's
ray-traced frame, kernel 6 on phase 8's visibility-buffer frame) and
prints one JSON line of their ms per frame: run beside another tree's
package (a copy of this script in that tree's root), it times that
tree's kernels on the same inputs, so two versions can be timed in turns
in one call.

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
   the raster's channels equal bit for bit (tri, material, max abs error
   0 on every float plane); material tap <= 1e-6; shade <= 1e-5 on all
   but <= 0.05% of the pixels; transmission fetch <= 1e-6. Per raster
   call it prints the tiles, the records, the mean run and the busiest
   tile's run (what kernel 1's work list spreads over the card); per
   shade call the valid pixels, the lights per valid pixel and the share
   of the warps holding a valid pixel whose valid pixels share one
   cluster (the warps a warp-shared light list would serve).
5. frame: one frame with the launch counts reset first; it must launch
   raster 2, tap 1, shade 2, fetch 1 times, give a finite image in
   [0, 1], report no capacity overflow, and match the stored golden
   tests/goldens/dragon_hd.png at sRGB RMSE < 4e-3 outside the few tiles
   where the golden's own raster path dropped triangles (see
   GOLDEN_DROPPED_TILES; the whole-frame RMSE is printed too).
6. timing: 3 warm-up frames, then 20 frames timed with CUDA events
   (median ms/frame, fps), per-pass ms from the profiler ranges, and each
   kernel's ms per frame (device, and the host's enqueue time) beside
   its plain version's (kernel 1's replayed once).
7. ray-traced shadows: the same scene and camera with
   RenderConfig(width=1920, height=1080, ray_traced_shadows=True) and the
   scene's BVH. (a) the occlusion kernel's hit set equals exactly, on
   both of the frame's calls, its plain walk's over the kernel's own
   table and over the packet table built apart from it from the frame's
   triangles (the two walks count the same pops and triangle tests), and
   from the plain walk's pop counts the mean pops per live ray and the
   mean over the 32-ray warps (in the frame's ray order) that hold a live
   ray of the warp's largest pop count, whose ratio bounds what
   divergence costs one ray per thread; (b) every other kernel, the shade
   kernel now reading shadow factors, holds phase 4's tolerance on the
   frame's own inputs; (c) with the counts reset, the frame launches
   raster 2, tap 1, shade 2, fetch 1, bvh_occlusion 2; (d) its image is
   finite, in [0, 1], without overflow; its HDR image is nowhere brighter
   than the phase-5 frame's (shadows only remove light) and darker
   somewhere. The tonemapped image can brighten a channel where a
   coloured light is shadowed (the Lottes curve scales by the max
   channel), so that is printed, not held; (e) median ms/frame over 10 frames
   after 2 warm-ups, per-pass ms, each kernel's ms per frame beside its
   plain version's (kernel 1's and the occlusion walk's replayed once) and
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
   kernel-6 order: triangle ids, depth and barycentrics equal bit for
   bit (max abs error 0), and per call the tiles, the records, the mean
   run and the busiest run; (b) with the counts reset, the frame
   launches raster_vis 2 and no other kernel; (c) its image is finite
   and in [0, 1], and its
   FrameDiagnostics equal the reference's for this frame
   (HD_VIS_DIAGNOSTICS: the busiest bin holds 5456 triangles against 2048,
   so overflowed() is true); (d) sRGB RMSE < 4e-3 against dragon_hd.png
   over the whole frame, the RMSE inside GOLDEN_DROPPED_TILES printed
   beside it; (e) median ms/frame over 10 frames after 2 warm-ups,
   per-pass ms, and kernel 6's ms per frame beside its plain version's
   (replayed once) and its bound; (f) kernel 1 replayed over the frame's
   own materialised bins (rasterize_gbuffer_pallas on each pass, every
   tile walking the big list before its run, as the reference's kernel
   does): bit for bit against its plain version.
9. the stress frame: the stress scene (build_stress_scene(), default
   size) at the bench's config RenderConfig(width=1920, height=1080,
   opaque_block_cap_frac=0.8125), camera and two lights, on the kernel
   branch: alpha-clip depth peeling, the block-sparse opaque shade and the
   non-fused sparse transmissive raster. (a) every kernel call of the
   frame through the kernel and its plain version (kernel 1 bit for bit
   on its ten calls, the peel's max_depth calls included; the others as
   phase 4); (b) with the counts reset, the frame launches raster 10
   (opaque, the class-2 peel's first round and 3 re-races, transmission,
   the class-3 peel's first round and 3 re-races), tap 1, shade 2, fetch
   1; (c) FrameDiagnostics at the bench's camera (yaw 0) and at its
   sweep's far end (the bench's smoothed rig after target yaw 0.18,
   bench_rig): the clip caps [608, 162, 41], no capacity overflow but the
   peel's, the clip diagnostics printed beside the reference's
   (STRESS_REFERENCE, BENCH_r05.json); (d) a finite image in [0, 1], and
   with the peel run to convergence (8 rounds, full re-race caps: no
   unresolved pixel) sRGB RMSE < 4e-3 against tests/goldens/stress_hd.png
   (the reference's 1080p frame, rendered on the CPU by its
   visibility-buffer branch); at the bench config the RMSE over the frame
   and outside the tiles holding unresolved pixels is printed; (e) median
   ms/frame over 10 frames after 2 warm-ups, per-pass ms (the peel's
   ranges too) and kernel 1's ms over the frame's calls beside its plain
   version's and its bound. Its launch counts are printed on a line of
   their own before the kernels line.
10. the bench's other scenes (bench.py:275-293; BENCH_SCENES): the
   helmet (build_opaque_scene, opaque_block_cap_frac 0.625), the smooth
   glass dragon (roughness 0), attenuation and bindless
   (build_bindless_scene under bindless_lights(48), cap 0.8125), each at
   1920x1080 with the bench's camera and lights on the kernel branch.
   Per scene: (a) every kernel call of the frame through the kernel and
   its plain version at phase 4's tolerances, printing per tap call its
   meta block, pixels, layer classes and image sizes, per shade call its
   materials, lights and slot blocks, then its valid pixels and lights
   per valid pixel; (b) with the counts reset, the launches the frame
   must make (expected_launches: kernel 1 and kernel 3 per pass, kernel 2
   per meta block a pass taps, kernel 4 with a transmissive pass); (c) a
   finite image in [0, 1] and no capacity overflow at the bench's first
   camera and at its sweep's far end, bindless's opaque_blocks printed
   beside BENCH_r05.json's; (d) sRGB RMSE < 4e-3 against
   tests/goldens/<scene>_hd.png (the reference's 1080p frame) outside
   the tiles where that golden's raster dropped triangles (BENCH_HD), the
   whole-frame RMSE beside it, and the scene's small golden at 128x72
   (8x128 tiles) under 4e-3; (e) the median ms/frame over 10 frames
   after 2 warm-ups and per-pass ms; (f) on the helmet and bindless
   frames, kernels 2 and 3 against their bound. The bench scenes' kernel
   figures and launch counts are printed on lines of their own before
   the kernels line.

The kernels JSON object reports every kernel on the widest path that
launches it, named in its "frame" key: kernels 1-5 on the ray-traced
frame ("rt", phase 7), kernel 6 on the visibility-buffer frame ("vis",
phase 8; the bindless frame, with 48 lights, is kernel 3's busiest,
reported in phase 10(f)): launches, worst parity error over
every frame checked, ms per frame of the kernel (the card's time for
the frame's calls, CUDA events queued behind a spin kernel so that they
do not read the host's enqueue time, see device_ms; the host's time is
printed beside it) and of its plain version, and the least time the card
could take (bound_ms, from the bytes and operations of the frame's own
calls, see kernel_work: the rasters' depth tests counted only where the
record covers the pixel, the walk's triangle tests only up to a leaf's
first hit and each up to where it leaves, the shade's work only on
valid pixels and the lights each evaluates) with what bounds it.
library_ms is null: no single PyTorch call computes any of these
functions (PERF.md gives the reason for each).

The lines before the last are the bench scenes' kernel figures, the
stress frame's and the bench scenes' launch counts, the kernels JSON
object and the card's name and power limit; the last line is the result
JSON object.
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


def host_ms(fn, reps: int) -> float:
    """Mean host ms that fn() takes to return (to enqueue its work) over
    reps runs, the device idle before each."""
    import torch

    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total * 1e3 / reps


def device_ms(fn, reps: int) -> float:
    """Mean device ms of fn() over reps runs, each between two CUDA events
    queued behind a spin kernel that outlasts the host's enqueue of fn():
    the events then span the card's work and not the host's (after a
    warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    # twice fn()'s whole time (enqueue and run) at up to 2e9 cycles a second
    cycles = int(4e9 * (time.perf_counter() - t0)) + 1_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def kernel_ms(h, calls) -> tuple:
    """(device ms, host ms) per frame of a kernel's recorded calls: the
    card's time for the calls (device_ms, 20 runs) and the time the host
    takes to enqueue them."""
    def frame_calls():
        for c in calls:
            h.replay(c, True)

    return device_ms(frame_calls, 20), host_ms(frame_calls, 20)


# plain versions that take seconds a frame: replayed once, no warm-up
SLOW_PLAIN = ("raster_gbuf", "bvh_occlusion", "raster_vis")


def plain_ms(h, calls) -> float:
    """ms per frame of a kernel's plain version on its recorded calls."""
    if h.name in SLOW_PLAIN:
        return sum(cuda_ms(lambda: h.replay(c, False), 1, warmup=False) for c in calls)
    return sum(cuda_ms(lambda: h.replay(c, False), 3) for c in calls)


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

def kernel_work(name: str, call, data=None) -> tuple:
    """(bytes, operations) that one recorded call must move and compute:
    each input byte it needs read once, each output byte written once;
    operations counted from the kernel's arithmetic on this call's own
    data (records per tile, the pixel-record pairs where the record covers
    and the pixels with a winner; lights per pixel; the walk's inner pops
    and its triangle tests up to each leaf's first hit: ``data`` carries
    the counts of the raster and of the walk)."""
    import torch

    args, kwargs = call
    if name == "raster_gbuf":
        from transmission_renderer_tpu_torch.ops.raster_gbuf import (
            TILE_H, TILE_W, _num_classes, active_channels)

        _, tile_ids, tile_start, big_count, width, height = args
        nc = _num_classes(tile_start, width, height)
        pc = None if nc == 1 else kwargs.get("pass_class")
        base = tile_ids.long() * nc
        lo = tile_start[base + (0 if pc is None else pc)]
        hi = tile_start[base + (nc if pc is None else pc + 1)]
        runs, nbig = int((hi - lo).sum()), int(big_count)
        px = tile_ids.numel() * TILE_H * TILE_W
        planes = len(active_channels(kwargs.get("pos_derivs", True),
                                     kwargs.get("uv_channels", True)))
        seeds = 1 + (kwargs.get("max_depth_tiles") is not None)
        uv, pd = kwargs.get("uv_channels", True), kwargs.get("pos_derivs", True)
        # 42 of a record's 64 floats are read; per pixel and record three
        # edge functions and their coverage tests (15 operations), and
        # where the record covers the pixel (data[0] such pairs) the w and
        # z sums, a divide and 5 tests more (31 in all); per pixel with a
        # winner (data[1]) its interpolation once: 11 operations of set-up
        # (edge and coefficient sums, 1/D, the 2/(w D^2) scales), 6 per
        # interpolated value (pos, nrm, uv) and 18 more per derivative
        # pair (pos with pos_derivs, uv)
        covered, winners = data
        nbytes = (runs + nbig) * 42 * 4 + tile_ids.numel() * 12 + px * 4 * (seeds + planes)
        interp = 11 + 6 * (6 + 2 * uv) + 18 * (2 * uv + 3 * pd)
        # every tile tests its run and the big list
        pairs = (runs + tile_ids.numel() * nbig) * TILE_H * TILE_W
        return nbytes, (pairs - covered) * 15 + covered * 31 + winners * interp
    if name == "tap_finish":
        quads, rows, uv, lod, _, classes = args
        m, lmax = uv.shape[0], max(classes)
        # the atlas read once; trilinear: 8 weighted taps of 4 channels
        nbytes = quads.nbytes + rows.nbytes + uv.nbytes + lod.nbytes + 4 * lmax * m * 4
        return nbytes, m * lmax * 4 * 8 * 2
    if name == "shade":
        from transmission_renderer_tpu_torch.render.shade_kernel import shade_work

        # counted on the call's own data: the planes each pixel needs, the
        # set-up of valid pixels and the lights each one evaluates (only
        # zeros written for the rest)
        w = shade_work(*args)
        return w.nbytes, w.ops
    if name == "transmission_fetch":
        pyramid, level_set, uv_x = args[0], args[1], args[2]
        m = uv_x.shape[0]
        levels = sum(pyramid.levels[k].nbytes for k in level_set)
        # 5 planes in, 5 out; two tent-weighted bilinear level taps of 3
        # channels and a bilinear LUT tap of 2
        return 5 * m * 4 + levels + args[7].nbytes + 5 * m * 4, m * 80
    if name == "raster_vis":
        _, tile_ids, _, run_count, big_count, _, _, tile_w, tile_h = args
        k, px = tile_ids.numel(), tile_ids.numel() * tile_w * tile_h
        runs, nbig = int(run_count.sum()), int(big_count[0])
        seeded = kwargs.get("init_depth_tiles") is not None
        # each walked record (16 floats) read once, the tile list, the seed
        # depth, and the four [K, th, tw] outputs; per pixel and record
        # (each tile's run and the big list) three edge functions and their
        # coverage tests (15 operations), and where the record covers the
        # pixel (data[0] such pairs) the w and z sums, a divide and 5 tests
        # more (31 in all); per pixel with a winner (data[1]) its resolve
        # once: the edge functions, the w and z sums, the depth's divide,
        # the edge sum and the two barycentrics (28)
        covered, winners = data
        nbytes = (runs + nbig) * 64 + k * 12 + 4 + px * 4 * (seeded + 4)
        pairs = (runs + k * nbig) * tile_w * tile_h
        return nbytes, (pairs - covered) * 15 + covered * 31 + winners * 28
    if name == "bvh_occlusion":
        _, table, rays, _ = args
        inner, tests = data
        # the table (node planes, triangles as v0 / e1 / e2) once; a slab
        # test: 6 sub, 6 mul, 10 min/max, 3 compares; the triangle tests a
        # leaf runs up to its first hit, each up to where it leaves
        # (tests[s]: those leaving at stage s): at the determinant 16
        # operations (a cross product of 9, a dot of 5, |det| and its
        # test), at u 28 (1/det, origin - v0, a dot and its scale, two
        # tests), at v 46 (a cross product, a dot, its scale, u + v, two
        # tests), the whole test 54 (t's dot and scale, two tests)
        nbytes = sum(t.nbytes for t in table) + rays.nbytes + rays.shape[1]
        return nbytes, inner * 8 * 25 + sum(n * c for n, c in zip(tests, (16, 28, 46, 54)))
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
        # every channel exact: tri, material and each float plane equal
        # (NaN where both are NaN), so the max abs error is 0
        bad = sum(int((~((got[k] == r) | (got[k].isnan() & r.isnan()))).sum())
                  for k, r in ref.items() if r.is_floating_point())
        bad += sum(int((got[k] != r).sum()) for k, r in ref.items()
                   if not r.is_floating_point())
        return err, bad, bad == 0 and err == 0.0
    if name == "raster_vis":
        # tri ids, depth and both barycentrics equal (NaN where both are)
        bad = sum(int((~((g == r) | (g.isnan() & r.isnan()))).sum()) for g, r in zip(got, ref))
        return err, bad, bad == 0 and err == 0.0
    if name == "shade":
        # 1e-5 on all but 0.05% of the pixels (log2f/cosf ulps can move a
        # cluster-boundary pixel to its neighbouring z-slice)
        import torch

        over = torch.stack([d for d, _ in diffs]) > 1e-5
        bad_px = int(over.any(dim=0).sum())
        return err, bad_px, bad_px <= 5e-4 * over.shape[1]
    bad = sum(int((d > 1e-6).sum()) for d, _ in diffs)  # tap and fetch
    return err, bad, bad == 0


def raster_runs(name: str, call) -> tuple:
    """(tiles, records, mean run, busiest tile's run) of a raster call:
    the run of each listed tile in its pass (kernel 1), or the run each
    tile walks besides the big list (kernel 6)."""
    from transmission_renderer_tpu_torch.ops.raster_gbuf import _num_classes, _tile_runs

    args, kwargs = call
    if name == "raster_vis":
        count = args[3]
    else:
        _, tile_ids, tile_start, _, width, height = args
        count = _tile_runs(tile_start, tile_ids, _num_classes(tile_start, width, height),
                           kwargs.get("pass_class"))[1]
    tile_ids = args[1]
    recs = int(count.sum())
    return tile_ids.numel(), recs, recs / max(tile_ids.numel(), 1), int(count.max())


def gbuf_counts(calls) -> list:
    """Per kernel-1 call (the pixel-record pairs where the record covers
    the pixel, the pixels with a winner): the counts of its bound."""
    from transmission_renderer_tpu_torch.ops import raster_gbuf

    return [(raster_gbuf.covered_pairs(*a[:3], *a[4:6], kw.get("pass_class"),
                                       big_count=a[3]),
             int((raster_gbuf.KERNEL.replay((a, kw), True)["tri"] >= 0).sum()))
            for a, kw in calls]


def check_parity(handles, calls, max_err, tag: str) -> None:
    """Replay every recorded call through the kernel and the plain
    version; raise on a disagreement."""
    import torch
    from transmission_renderer_tpu_torch.render.shade_kernel import shade_work

    for h in handles:
        require(len(calls[h.name]) > 0, f"{h.name}: the frame never called it")
        for i, call in enumerate(calls[h.name]):
            err, bad, ok = parity(h.name, h.replay(call, True), h.replay(call, False))
            torch.cuda.synchronize()
            log(f"parity {tag}{h.name}[{i}]: max_abs_err {err:.3e}, differing {bad}, "
                f"{'ok' if ok else 'FAIL'}")
            max_err[h.name] = max(max_err.get(h.name, 0.0), err)
            require(ok, f"{h.name}: kernel disagrees with its plain version")
            if h.name in ("raster_gbuf", "raster_vis"):
                tiles, recs, mean, busiest = raster_runs(h.name, call)
                log(f"  runs {tag}{h.name}[{i}]: {tiles} tiles, {recs} records, mean "
                    f"{mean:.1f} a tile, busiest tile {busiest}")
            if h.name == "shade":
                w = shade_work(*call[0])
                log(f"  pixels {tag}shade[{i}]: {w.valid} valid of {call[0][0].mid.numel()}, "
                    f"{w.lights / max(w.valid, 1):.3f} lights per valid pixel, "
                    f"{w.uniform_warps} of {w.warps} warps holding a valid pixel share one "
                    f"cluster ({w.uniform_warps / max(w.warps, 1):.3f})")


def check_occlusion(calls, n_kinds: int, tag: str, tri_vertices, positions) -> list:
    """Replay each recorded occlusion call through the kernel and the plain
    walk, over the kernel's own table and over the packet table built
    apart from it from the frame's triangles (``tri_vertices`` into the
    world ``positions``); raise unless all three hit sets are equal and
    the two walks count alike. -> per call (inner pops, leaf pops, rays,
    live rays, sun rays hit, triangle tests by exit stage [4]); the sun's
    rays come first."""
    import torch
    from transmission_renderer_tpu_torch.ops import bvh_packet
    from transmission_renderer_tpu_torch.ops.bvh import occlusion_walk

    require(len(calls) == 2, f"bvh_occlusion: {len(calls)} calls, expected 2")
    rows = []
    for i, call in enumerate(calls):
        tree, table, rays, t_min = call[0]
        got = bvh_packet.KERNEL.replay(call, True)
        ref, inner, leaf, tests = occlusion_walk(tree, table, rays, t_min)
        packet = bvh_packet.packet_walk_table(tree, tri_vertices, positions)
        walk_p = occlusion_walk(tree, packet, rays, t_min)
        torch.cuda.synchronize()
        bad = int((got != ref).sum())
        bad_p = int((got != walk_p[0]).sum())
        alike = all(torch.equal(a, b) for a, b in zip((ref, inner, leaf, tests), walk_p))
        n = rays.shape[1]
        stages = [int(s) for s in tests.sum(dim=0)]
        rows.append((int(inner.sum()), int(leaf.sum()), n, int((rays[9] > t_min).sum()),
                     int(got[: n // n_kinds].sum()), stages))
        ok = bad == 0 and bad_p == 0 and alike
        log(f"parity {tag}bvh_occlusion[{i}]: {n} rays ({rows[-1][3]} live), hits "
            f"{int(got.sum())}, differing {bad} from the walk over the kernel's table, "
            f"{bad_p} over the packet table (walks count alike: {alike}), inner pops "
            f"{rows[-1][0]}, leaf pops {rows[-1][1]}, triangle tests to the first hit "
            f"{sum(stages)} (leaving at the determinant, u, v, end: {stages}), "
            f"{'ok' if ok else 'FAIL'}")
        # divergence: a warp of 32 consecutive rays, one per thread, takes
        # as many steps as its longest walk; over the warps that hold a
        # live ray, the mean of that longest walk against the mean walk
        pad = -n % 32
        pops = torch.cat([inner + leaf, inner.new_zeros(pad)]).reshape(-1, 32)
        live = torch.cat([rays[9] > t_min,
                          torch.zeros(pad, dtype=torch.bool, device=rays.device)]).reshape(-1, 32)
        busy = live.any(dim=1)
        mean_live = float(pops[live].double().mean()) if bool(busy.any()) else 0.0
        mean_warp = float(pops.amax(dim=1)[busy].double().mean()) if bool(busy.any()) else 0.0
        log(f"  pops {tag}bvh_occlusion[{i}]: {mean_live:.3f} per live ray, mean over the "
            f"{int(busy.sum())} warps holding a live ray of the warp's largest "
            f"{mean_warp:.3f}, ratio {mean_warp / max(mean_live, 1e-9):.3f}")
        require(bad == 0, "bvh_occlusion: the kernel's hit set differs from its plain walk")
        require(bad_p == 0 and alike, "bvh_occlusion: the walk over the packet table differs")
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


def golden_keep_mask(cfg, tiles=GOLDEN_DROPPED_TILES):
    """[H, W] bool: False on the pixels of ``tiles`` (8x128 tile ids)."""
    keep = np.ones(cfg.tiles_x * cfg.tiles_y, bool)
    keep[list(tiles)] = False
    keep = keep.reshape(cfg.tiles_y, 1, cfg.tiles_x, 1)
    keep = np.broadcast_to(keep, (cfg.tiles_y, cfg.tile_h, cfg.tiles_x, cfg.tile_w))
    return keep.reshape(cfg.tiles_y * cfg.tile_h, -1)[: cfg.height, : cfg.width]


def flagship_scene(dev):
    """The flagship scene, camera and lights (tests/golden_defs.py::
    render_hd_golden) on ``dev`` -> (builder, scene, draw list, flags,
    1080p frame params, lights)."""
    from transmission_renderer_tpu_torch.config import RenderConfig
    from transmission_renderer_tpu_torch.models.procedural import build_dragon_scene
    from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
    from transmission_renderer_tpu_torch.render.frame import make_frame_params
    from transmission_renderer_tpu_torch.scene.camera import CameraRig

    builder = build_dragon_scene(roughness_override=0.25)
    scene, dl, flags = builder.finish_bundle(device=dev)
    rig = CameraRig()
    rig.camera.position = np.array([0.0, 2.2, 1.5], np.float32)
    rig.camera.pitch = -0.25
    rig.sun_yaw = 4.8
    params = make_frame_params(RenderConfig(width=1920, height=1080), rig.camera.view_matrix(),
                               rig.camera.position, rig.sun_dir(), device=dev)
    lights = pack_lights([
        point_light([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0),
        point_light([8.0, 0.8, 0.0], [0.0, 1.0, 0.0], 10.0),
    ], device=dev)
    return builder, scene, dl, flags, params, lights


def gbuf_on_materialised_bins(scene, dl, params, cfg) -> dict:
    """{"raster_gbuf": the kernel-1 calls of the visibility-buffer frame's
    two passes rasterised by rasterize_gbuffer_pallas over that frame's
    own materialised bins (their big list included): the opaque pass,
    then the transmissive pass seeded with its depth}."""
    from transmission_renderer_tpu_torch.config import (
        BUCKET_ALPHA_CLIP, BUCKET_OPAQUE, BUCKET_TRANSMISSION, BUCKET_TRANSMISSION_ALPHA_CLIP)
    from transmission_renderer_tpu_torch.ops import raster_gbuf
    from transmission_renderer_tpu_torch.ops.cull import (
        bucket_triangle_masks, cull_instances, transform_vertices)
    from transmission_renderer_tpu_torch.ops.raster import (
        bin_triangles_materialized, setup_triangles)

    def frame():
        world_pos, world_nrm, uvs, clip, tri_scale = transform_vertices(
            scene, dl, params.proj_view)
        visible = cull_instances(scene, params.view, params.frustum_x_xz,
                                 params.frustum_y_yz, cfg.z_near)
        depth = None
        for buckets in ((BUCKET_OPAQUE, BUCKET_ALPHA_CLIP),
                        (BUCKET_TRANSMISSION, BUCKET_TRANSMISSION_ALPHA_CLIP)):
            mask = bucket_triangle_masks(dl.tri_inst, dl.tri_bucket, visible, buckets)
            setup = setup_triangles(clip, dl.tri_vtx, mask, cfg.width, cfg.height,
                                    cfg.tile_w, cfg.tile_h)
            bins = bin_triangles_materialized(setup, cfg.tiles_x, cfg.tiles_y,
                                              cfg.max_tiles_per_tri, cfg.max_tris_per_tile,
                                              cfg.max_big_tris)
            records = raster_gbuf.pack_gbuf_payload(setup, dl.tri_vtx, dl.tri_material,
                                                    tri_scale, world_pos, world_nrm, uvs)
            g = raster_gbuf.rasterize_gbuffer_pallas(records, bins, cfg.width, cfg.height,
                                                     init_depth=depth)
            depth = g.depth if depth is None else depth

    calls = capture((raster_gbuf.KERNEL,), frame)
    require(len(calls["raster_gbuf"]) == 2 and any(int(a[3][0]) > 0
                                                   for a, _ in calls["raster_gbuf"]),
            "the materialised-bin replay must walk a non-empty big list")
    return calls


# The bench's stress cell (bench.py:276, 284-286): the stress scene at its
# default size, RenderConfig(1920, 1080, opaque_block_cap_frac=0.8125).
# Its camera is bench.py::make_rig's, which smooths toward CameraRig's
# targets on every update (reference scene/camera.py:151-165): the sweep
# sets target yaw 0.02 i and updates once a frame for 10 frames, and the
# diagnostics guard updates once more at target yaw 0.18 (bench.py:147-149,
# 206-216). BENCH_r05.json (the reference on a TPU) printed for that guard:
STRESS_REFERENCE = {"clip_unresolved": 196, "clip_round_demand": (510, 156, 26),
                    "clip_round_caps": (608, 162, 41)}


def bench_rig(sweep_updates: int):
    """bench.py::make_rig's CameraRig after ``sweep_updates`` of the bench
    sweep's smoothed updates (the reference's CameraRig.update at dt 1/60:
    position half-time 0.5, rotation 0.25, toward target position
    (0, 3, 1), pitch -15 degrees and the sweep's target yaw; update n
    aims at yaw 0.02 min(n, 9))."""
    import math

    from transmission_renderer_tpu_torch.scene.camera import CameraRig

    rig = CameraRig()
    rig.camera.position = np.array([0.0, 2.2, 1.5], np.float32)
    rig.camera.pitch = -0.25
    target_pos = np.array([0.0, 3.0, 1.0], np.float32)
    target_pitch = math.radians(-15.0)

    def factor(half_time):
        return 1.0 - math.exp(-math.log(2.0) * (1.0 / 60.0) / (half_time / 4.0))

    pf, rf = factor(0.5), factor(0.25)
    for n in range(sweep_updates):
        target_yaw = 0.02 * min(n, 9)
        rig.camera.position = (rig.camera.position
                               + (target_pos - rig.camera.position) * pf).astype(np.float32)
        rig.camera.yaw += (target_yaw - rig.camera.yaw) * rf
        rig.camera.pitch += (target_pitch - rig.camera.pitch) * rf
    return rig


def make_params(cfg, rig, dev):
    """The frame params of a CameraRig's camera and sun at ``cfg``."""
    from transmission_renderer_tpu_torch.render.frame import make_frame_params

    return make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                             rig.sun_dir(), device=dev)


def stress_phase(card: str, max_err: dict) -> dict:
    """Phase 9, the stress frame: kernel parity on every call of the
    frame, the launches, the clip diagnostics at both ends of the bench's
    sweep, the golden, the timing. -> the frame's launch counts."""
    import torch
    from transmission_renderer_tpu_torch.config import RenderConfig
    from transmission_renderer_tpu_torch.models.procedural import build_stress_scene
    from transmission_renderer_tpu_torch.ops import raster_gbuf
    from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
    from transmission_renderer_tpu_torch.render import frame as frame_mod
    from transmission_renderer_tpu_torch.render.frame import render_frame
    from transmission_renderer_tpu_torch.scene.textures import linear_to_srgb
    from transmission_renderer_tpu_torch.utils.png import read_png
    from transmission_renderer_tpu_torch.utils.profiling import CLIP_PASS_NAMES, PASS_NAMES

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    scene, dl, flags = build_stress_scene().finish_bundle(device=dev)
    cfg = RenderConfig(width=1920, height=1080, opaque_block_cap_frac=0.8125)
    lights = pack_lights([
        point_light([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0),
        point_light([8.0, 0.8, 0.0], [0.0, 1.0, 0.0], 10.0),
    ], device=dev)

    params = make_params(cfg, bench_rig(0), dev)
    far = bench_rig(11)
    params_far = make_params(cfg, far, dev)
    log(f"stress: {int(dl.tri_vtx.shape[0])} triangles, {cfg.width}x{cfg.height}, "
        f"opaque_block_cap_frac {cfg.opaque_block_cap_frac}, built in "
        f"{time.perf_counter() - t0:.2f} s, flags {flags}; sweep's far end: camera at "
        f"{far.camera.position.tolist()}, yaw {far.camera.yaw:.6f}, pitch "
        f"{far.camera.pitch:.6f}")

    def frame(p=params, c=cfg, **kw):
        return render_frame(scene, dl, p, lights, c, flags, **kw)

    handles = port_handles()[:4]
    # (a) every kernel call of the frame through the kernel and its plain
    # version: kernel 1 bit for bit on all ten, the peel bounds included
    calls = capture(handles, frame)
    for i, (a, kw) in enumerate(calls["raster_gbuf"]):
        log(f"stress raster_gbuf[{i}]: pass_class {kw.get('pass_class')}, "
            f"max_depth {kw.get('max_depth_tiles') is not None}, "
            f"seeded {kw.get('init_depth_tiles') is not None}")
    check_parity(handles, calls, max_err, "stress ")

    # (b) one frame with the counts reset: the reference's call sequence
    # (frame.py:1186-1197, 1417-1456): kernel 1 for the opaque raster, the
    # class-2 peel's first round and 3 re-races, the sparse transmissive
    # raster, the class-3 peel's first round and 3 re-races (the scene has
    # no class-3 triangle; the reference peels whenever alpha clip is on);
    # the diffuse tap once (the glass samples no texture), two shades, one
    # refraction fetch
    (img, diag), launches = count_launches(handles, frame, return_diagnostics=True)
    log(f"stress launches per frame: {launches}")
    expect = {"raster_gbuf": 10, "tap_finish": 1, "shade": 2, "transmission_fetch": 1}
    require(launches == expect, f"stress launch counts {launches}, expected {expect}")

    # (c) the diagnostics at both ends of the bench's sweep, the unresolved
    # pixels' mask recorded from the peel
    masks = []
    peel = frame_mod._rasterize_clip_peeled

    def recording_peel(*args, **kwargs):
        out = peel(*args, **kwargs)
        masks.append(out[4])
        return out

    frame_mod._rasterize_clip_peeled = recording_peel
    try:
        diags = {}
        for tag, p in (("yaw 0", params), ("sweep end", params_far)):
            masks.clear()
            img_p, d = frame(p, return_diagnostics=True)
            diags[tag] = (img_p, d, masks[0] | masks[1])
    finally:
        frame_mod._rasterize_clip_peeled = peel
    for tag, (_, d, _) in diags.items():
        got = diagnostics_dict(d)
        log(f"stress diagnostics at {tag}: clip_unresolved {got['clip_unresolved']}, "
            f"clip_tiles {got['clip_tiles']}/{got['clip_tile_capacity']}, round demand "
            f"{list(got['clip_round_demand'])}, caps {list(got['clip_round_caps'])}, "
            f"opaque_blocks {got['opaque_blocks']}/{got['opaque_block_capacity']}, "
            f"transmission tiles {got['transmission_tiles']}/"
            f"{got['transmission_tile_capacity']}, transmission blocks "
            f"{got['transmission_blocks']}/{got['transmission_block_capacity']}; all {got}")
        require(got["clip_round_caps"] == STRESS_REFERENCE["clip_round_caps"],
                f"stress caps {got['clip_round_caps']}")
        require(got["clip_tile_capacity"] == 1013, "clip tile cap: ceil(2025 * 0.5)")
        # nothing else may drop work: only the peel's caps bind
        others = d._replace(clip_unresolved=0)
        require(not others.overflowed(), f"stress capacity overflow at {tag}: {d}")
    log(f"stress reference (BENCH_r05.json, on a TPU, the bench's guard at the sweep's "
        f"end): clip_unresolved {STRESS_REFERENCE['clip_unresolved']}, round demand "
        f"{list(STRESS_REFERENCE['clip_round_demand'])}, caps "
        f"{list(STRESS_REFERENCE['clip_round_caps'])}")

    # (d) the image, and the golden with the peel run to convergence
    require(tuple(img.shape) == (1080, 1920, 3), f"stress image shape {tuple(img.shape)}")
    require(bool(torch.isfinite(img).all()), "stress image has non-finite values")
    lo, hi = float(img.min()), float(img.max())
    require(0.0 <= lo and hi <= 1.0, f"stress image outside [0, 1]: [{lo}, {hi}]")
    golden = read_png(os.path.join(ROOT, "tests", "goldens", "stress_hd.png"))[..., :3] / 255.0
    cfg_conv = RenderConfig(width=1920, height=1080, opaque_block_cap_frac=0.8125,
                            alpha_clip_rounds=8, clip_retile_cap_frac=1.0)
    img_conv, d_conv = frame(params, cfg_conv, return_diagnostics=True)
    log(f"stress converged (alpha_clip_rounds 8, clip_retile_cap_frac 1.0): diagnostics "
        f"{diagnostics_dict(d_conv)}")
    require(int(d_conv.clip_unresolved) == 0 and not d_conv.overflowed(),
            "stress: the converged peel left pixels unresolved or overflowed")
    rmse_conv = float(np.sqrt(np.mean((linear_to_srgb(img_conv.cpu().numpy()) - golden) ** 2)))
    srgb = linear_to_srgb(diags["yaw 0"][0].cpu().numpy())
    rmse = float(np.sqrt(np.mean((srgb - golden) ** 2)))
    # the 8x128 tiles holding an unresolved pixel of either peel
    bad = diags["yaw 0"][2].cpu().numpy().reshape(135, 8, 15, 128).any(axis=(1, 3))
    keep = ~np.repeat(np.repeat(bad, 8, axis=0), 128, axis=1)
    rmse_keep = float(np.sqrt(np.mean((srgb[keep] - golden[keep]) ** 2)))
    log(f"stress golden stress_hd.png: sRGB RMSE {rmse_conv:.6f} converged (limit 4e-3); "
        f"at the bench config {rmse:.6f} over the whole frame, {rmse_keep:.6f} outside "
        f"the {int(bad.sum())} tiles holding unresolved pixels")
    require(rmse_conv < 4e-3, f"stress sRGB RMSE {rmse_conv} vs golden")

    # (e) timing, passes, kernel 1 against its bound
    times = timed_frames(frame, 2, 10)
    med = statistics.median(times)
    log(f"stress frame 1920x1080 on [{card}]: median {med:.3f} ms/frame "
        f"({1000.0 / med:.2f} fps), min {min(times):.3f}, max {max(times):.3f}")
    rounds = tuple(f"clip_round_{r}" for r in range(1, cfg.alpha_clip_rounds))
    profile_passes(frame, card, PASS_NAMES + CLIP_PASS_NAMES + rounds)
    h = raster_gbuf.KERNEL
    k_ms, h_ms = kernel_ms(h, calls[h.name])
    p_ms = plain_ms(h, calls[h.name])
    per_call = gbuf_counts(calls[h.name])
    works = [kernel_work(h.name, c, pc) for c, pc in zip(calls[h.name], per_call)]
    b_ms, b_by = bound_of(works)
    log(f"stress kernel raster_gbuf on [{card}]: {k_ms:.3f} ms/frame on the device (host "
        f"{h_ms:.3f}), plain {p_ms:.3f} ms/frame, bound {b_ms:.4f} ms by {b_by} "
        f"({sum(w[0] for w in works)} bytes, {sum(w[1] for w in works)} operations), "
        f"{b_ms / k_ms:.4f} of the bound reached, {len(calls[h.name])} calls per frame; "
        f"covering pairs {[c[0] for c in per_call]}, pixels with a winner "
        f"{[c[1] for c in per_call]}")
    return launches


# The bench's other scenes (bench.py:275-293), each at its bench config,
# the bench's first camera (bench_rig(0): bench.py::make_rig, the
# CameraRig's default sun) and lights (bench.py:93-99; bindless_lights(48)
# for bindless), on the kernel branch. "small" is the scene's small golden
# (tests/golden_defs.py GOLDENS: builder arguments, camera, pitch, its
# lights, at sun yaw 0.5) at 128x72, with the config changes the CPU tests
# of tests/test_torch_scenes_bench.py use there: the bench's block caps
# overflow at 72 blocks, so the block-sparse shade takes every block, and
# the transmissive raster keeps the fused sparse path; the smooth dragon
# has no small golden.
BENCH_SCENES = {
    "helmet": {"builder": "build_opaque_scene", "args": {},
               "config": {"opaque_block_cap_frac": 0.625},
               "small": ({"stacks": 32, "sectors": 64}, (0.0, 2.2, 1.5), -0.25,
                         {"opaque_block_cap_frac": 1.0})},
    "smooth": {"builder": "build_dragon_scene", "args": {"roughness_override": 0.0},
               "config": {}, "small": None},
    "attenuation": {"builder": "build_attenuation_scene", "args": {}, "config": {},
                    "small": ({}, (0.0, 5.0, 3.0), -0.75,
                              {"sparse_raster_tile_floor": 1,
                               "transmission_tile_cap_frac": 0.85})},
    "bindless": {"builder": "build_bindless_scene", "args": {},
                 "config": {"opaque_block_cap_frac": 0.8125},
                 "small": ({"grid": 5, "n_images": 48}, (0.0, 4.0, 3.0), -0.6,
                           {"opaque_block_cap_frac": 1.0})},
}

# tests/goldens/<name>_hd.png: the reference's 1080p frames of the scenes
# above, rendered on the CPU by its visibility-buffer branch
# (tests/test_torch_bench_hd.py), with the reference's FrameDiagnostics of
# each and the 8x128 tiles whose bins that branch overflowed (it keeps 2048
# triangles of a pass a tile), where the golden lost triangles: the smooth
# dragon has the flagship's mesh and camera, so the flagship's five.
# _VIS_ZEROS: the fields that branch leaves at 0 on a scene without clip.
_VIS_ZEROS = {"clip_unresolved": 0, "mid_tri_count": 0, "mid_tri_capacity": 0,
            "transmission_tiles": 0, "transmission_tile_capacity": 0, "clip_tiles": 0,
            "clip_tile_capacity": 0, "tier_overflow": 0, "clip_round_demand": (),
            "clip_round_caps": (), "pair_demand": 0, "pair_capacity": 0}
BENCH_HD = {
    "helmet": {"dropped_tiles": (), "diagnostics": {
        "max_bin_count": 857, "bin_capacity": 2048, "big_tri_count": 2,
        "big_tri_capacity": 256, "opaque_blocks": 9438, "opaque_block_capacity": 10125,
        "transmission_blocks": 0, "transmission_block_capacity": 0, **_VIS_ZEROS}},
    "smooth": {"dropped_tiles": GOLDEN_DROPPED_TILES, "diagnostics": HD_VIS_DIAGNOSTICS},
    "attenuation": {"dropped_tiles": (), "diagnostics": {
        "max_bin_count": 2, "bin_capacity": 2048, "big_tri_count": 16,
        "big_tri_capacity": 256, "opaque_blocks": 0, "opaque_block_capacity": 0,
        "transmission_blocks": 2036, "transmission_block_capacity": 4050, **_VIS_ZEROS}},
    "bindless": {"dropped_tiles": (), "diagnostics": {
        "max_bin_count": 241, "bin_capacity": 2048, "big_tri_count": 53,
        "big_tri_capacity": 256, "opaque_blocks": 11194, "opaque_block_capacity": 13163,
        "transmission_blocks": 0, "transmission_block_capacity": 0, **_VIS_ZEROS}},
}
# BENCH_r05.json (the reference on a TPU): the bench's guard on bindless
BINDLESS_REFERENCE_OPAQUE_BLOCKS = 11194


def bench_scene(name: str, dev, small: bool = False):
    """(scene, draw list, flags, config, frame params, lights) of bench
    scene ``name`` on ``dev``: at the bench's size, config, camera and
    lights, or with ``small`` at its small golden's."""
    import dataclasses

    from transmission_renderer_tpu_torch.config import RenderConfig
    from transmission_renderer_tpu_torch.models import procedural
    from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light

    spec = BENCH_SCENES[name]
    if small:
        args, cam, pitch, changes = spec["small"]
        args = dict(spec["args"], **args)
        cfg = RenderConfig(width=128, height=72, **changes)
        rig = bench_rig(0)
        rig.camera.position = np.array(cam, np.float32)
        rig.camera.pitch = pitch
        rig.sun_yaw = 0.5
    else:
        args, cfg, rig = spec["args"], RenderConfig(width=1920, height=1080), bench_rig(0)
        cfg = dataclasses.replace(cfg, **spec["config"])
    scene, dl, flags = getattr(procedural, spec["builder"])(**args).finish_bundle(device=dev)
    params = make_params(cfg, rig, dev)
    if name == "bindless":
        lights = procedural.bindless_lights(20 if small else 48)
    elif small:
        lights = [point_light([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0)]
    else:
        lights = [point_light([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0),
                  point_light([8.0, 0.8, 0.0], [0.0, 1.0, 0.0], 10.0)]
    return scene, dl, flags, cfg, params, pack_lights(lights, device=dev)


def expected_launches(scene, flags) -> dict:
    """The kernel launches a kernel-branch frame of the scene must make:
    kernel 1 per pass, kernel 2 once per meta block a pass's shade taps
    (render/shading.py::used_meta_cols), kernel 3 per pass, kernel 4 once
    with a transmissive pass."""
    from transmission_renderer_tpu_torch.render.shading import (
        build_material_matrix, used_meta_cols)

    def taps(slots):
        return len(used_meta_cols(build_material_matrix(scene, slots, flags.slot_bundles),
                                  slots))

    t = int(flags.has_transmission)
    return {"raster_gbuf": 1 + t, "tap_finish": taps(flags.tex_slots)
            + (taps(flags.tex_slots_transmission) if t else 0),
            "shade": 1 + t, "transmission_fetch": t}


def bench_scenes_phase(card: str, max_err: dict) -> tuple:
    """Phase 10, the bench's other scenes: per scene kernel parity on
    every call of the frame, the launches, the diagnostics at both ends of
    the bench's sweep, the 1080p and the small golden, the timing; kernels
    2 and 3 against their bound on the helmet and bindless frames. ->
    ({scene: launch counts}, {scene: {kernel: (ms, plain ms, bound ms,
    bound by)}})."""
    import torch
    from transmission_renderer_tpu_torch.render.frame import render_frame
    from transmission_renderer_tpu_torch.scene.textures import linear_to_srgb
    from transmission_renderer_tpu_torch.utils.png import read_png
    from transmission_renderer_tpu_torch.utils.profiling import PASS_NAMES

    dev = torch.device("cuda", 0)
    handles = port_handles()[:4]
    all_launches, kernel_rows = {}, {}
    for name in BENCH_SCENES:
        t0 = time.perf_counter()
        scene, dl, flags, cfg, params, lights = bench_scene(name, dev)
        log(f"{name}: {int(dl.tri_vtx.shape[0])} triangles, {scene.atlas_meta.shape[0]} "
            f"images, {scene.materials.roughness_factor.numel()} materials, {lights.num} "
            f"lights ({int(lights.is_a_spotlight().sum())} spot), {cfg.width}x{cfg.height}, "
            f"opaque_block_cap_frac {cfg.opaque_block_cap_frac}, built in "
            f"{time.perf_counter() - t0:.2f} s, flags {flags}")

        def frame(p=params, c=cfg, **kw):
            return render_frame(scene, dl, p, lights, c, flags, **kw)

        # (a) every kernel call of the frame through the kernel and its
        # plain version
        expect = expected_launches(scene, flags)
        used = tuple(h for h in handles if expect[h.name])
        calls = capture(used, frame)
        for i, ((_, rows, uv, _, _, classes), _) in enumerate(calls["tap_finish"]):
            log(f"{name} tap_finish[{i}]: meta block {i + 1} of {len(calls['tap_finish'])}, "
                f"{uv.shape[0]} pixels, layer classes {classes}, image sizes "
                f"{sorted(set(rows[:, 2].tolist()))}")
        for i, ((inp, spec), _) in enumerate(calls["shade"]):
            log(f"{name} shade[{i}]: {inp.mat.shape[0]} materials, {inp.lmat.shape[0]} "
                f"lights, cluster lists up to {int(inp.counts.max())} lights, "
                f"{inp.samples.shape[0]} sample planes from {spec.n_layers}-layer blocks, "
                f"slot blocks {spec.slot_bundle}, slots {spec.tex_slots}")
        check_parity(used, calls, max_err, f"{name} ")

        # (b) one frame with the counts reset, against what it must launch
        (img, diag), launches = count_launches(handles, frame, return_diagnostics=True)
        all_launches[name] = launches
        log(f"{name} launches per frame: {launches}")
        require(launches == expect, f"{name} launch counts {launches}, expected {expect}")

        # (c) the image, and no overflow at both ends of the bench's sweep
        require(tuple(img.shape) == (1080, 1920, 3), f"{name} image shape {tuple(img.shape)}")
        require(bool(torch.isfinite(img).all()), f"{name} image has non-finite values")
        lo, hi = float(img.min()), float(img.max())
        require(0.0 <= lo and hi <= 1.0, f"{name} image outside [0, 1]: [{lo}, {hi}]")
        far = frame(make_params(cfg, bench_rig(11), dev), return_diagnostics=True)[1]
        for tag, d in (("yaw 0", diag), ("sweep end", far)):
            log(f"{name} diagnostics at {tag}: {diagnostics_dict(d)}")
            require(not d.overflowed(), f"{name} capacity overflow at {tag}: {d}")
        if name == "bindless":
            log(f"bindless opaque_blocks {int(diag.opaque_blocks)}/"
                f"{diag.opaque_block_capacity} at the bench's first camera; the reference "
                f"(BENCH_r05.json): overflowed=False opaque_blocks "
                f"{BINDLESS_REFERENCE_OPAQUE_BLOCKS}")

        # (d) the 1080p golden outside its dropped tiles, and the small one
        golden = read_png(os.path.join(ROOT, "tests", "goldens", f"{name}_hd.png"))
        golden = golden[..., :3] / 255.0
        srgb = linear_to_srgb(img.cpu().numpy())
        dropped = BENCH_HD[name]["dropped_tiles"]
        keep = golden_keep_mask(cfg, dropped)
        rmse_full = float(np.sqrt(np.mean((srgb - golden) ** 2)))
        rmse = float(np.sqrt(np.mean((srgb[keep] - golden[keep]) ** 2)))
        log(f"{name} golden {name}_hd.png: sRGB RMSE {rmse:.6f} (limit 4e-3) outside the "
            f"{len(dropped)} tiles where the golden's raster dropped triangles; "
            f"{rmse_full:.6f} over the whole frame")
        require(rmse < 4e-3, f"{name} sRGB RMSE {rmse} vs its 1080p golden")
        if BENCH_SCENES[name]["small"] is None:
            log(f"{name}: no small golden (the small goldens hold the dragon at roughness "
                f"0.25 only)")
        else:
            s_scene, s_dl, s_flags, s_cfg, s_params, s_lights = bench_scene(name, dev, True)
            small, s_diag = render_frame(s_scene, s_dl, s_params, s_lights, s_cfg, s_flags,
                                         return_diagnostics=True)
            golden = read_png(os.path.join(ROOT, "tests", "goldens", f"{name}.png"))
            golden = golden[..., :3] / 255.0
            rmse_s = float(np.sqrt(np.mean((linear_to_srgb(small.cpu().numpy())
                                            - golden) ** 2)))
            log(f"{name} golden {name}.png at 128x72 (8x128 tiles, {s_lights.num} lights): "
                f"sRGB RMSE {rmse_s:.6f} (limit 4e-3)")
            require(not s_diag.overflowed(), f"{name} 128x72 capacity overflow: {s_diag}")
            require(rmse_s < 4e-3, f"{name} sRGB RMSE {rmse_s} vs its small golden")

        # (e) timing
        times = timed_frames(frame, 2, 10)
        med = statistics.median(times)
        log(f"{name} frame 1920x1080 on [{card}]: median {med:.3f} ms/frame "
            f"({1000.0 / med:.2f} fps), min {min(times):.3f}, max {max(times):.3f}")
        profile_passes(frame, card, PASS_NAMES)

        # (f) kernels 2 and 3 against their bound on the helmet and
        # bindless frames
        if name in ("helmet", "bindless"):
            kernel_rows[name] = {}
            for h in used:
                if h.name not in ("tap_finish", "shade"):
                    continue
                k_ms, h_ms = kernel_ms(h, calls[h.name])
                p_ms = plain_ms(h, calls[h.name])
                works = [kernel_work(h.name, c) for c in calls[h.name]]
                b_ms, b_by = bound_of(works)
                kernel_rows[name][h.name] = (k_ms, p_ms, b_ms, b_by)
                log(f"{name} kernel {h.name} on [{card}]: {k_ms:.3f} ms/frame on the device "
                    f"(host {h_ms:.3f}), plain {p_ms:.3f} ms/frame, bound {b_ms:.4f} ms by "
                    f"{b_by} ({sum(w[0] for w in works)} bytes, {sum(w[1] for w in works)} "
                    f"operations), {b_ms / k_ms:.4f} of the bound reached, "
                    f"{len(calls[h.name])} call(s) per frame")
    return all_launches, kernel_rows


def port_handles() -> tuple:
    """Every kernel's handle: the flagship's four, then the occlusion
    walk (ray-traced frames) and the visibility raster (vis frames)."""
    from transmission_renderer_tpu_torch.ops import bvh_packet, raster_gbuf, raster_vis, tap_finish
    from transmission_renderer_tpu_torch.render import shade_kernel

    return (raster_gbuf.KERNEL, tap_finish.TAP_KERNEL, shade_kernel.KERNEL,
            tap_finish.FETCH_KERNEL, bvh_packet.KERNEL, raster_vis.KERNEL)


def kernel_times() -> int:
    """--kernel-times: every kernel of the package beside this script on
    the calls of the widest 1080p frame that launches it (the ray-traced
    frame, then the visibility-buffer frame for the kernels it alone
    launches), per frame: ms (the card's time, device_ms) and host ms to
    enqueue them, as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from transmission_renderer_tpu_torch import kernels
    from transmission_renderer_tpu_torch.config import RenderConfig
    from transmission_renderer_tpu_torch.render.frame import render_frame

    dev = torch.device("cuda", 0)
    kernels.build()
    builder, scene, dl, flags, params, lights = flagship_scene(dev)
    bvh = builder.build_rt_bvh(device=dev)
    handles = port_handles()
    frames = ((RenderConfig(width=1920, height=1080, ray_traced_shadows=True), {"bvh": bvh}),
              (RenderConfig(width=1920, height=1080, use_pallas_raster=False), {}))
    out = {}
    for cfg, kw in frames:
        calls = capture(handles, lambda cfg=cfg, kw=kw: render_frame(
            scene, dl, params, lights, cfg, flags, **kw))
        for h in handles:
            if calls[h.name] and h.name not in out:
                dev_ms, h_ms = kernel_ms(h, calls[h.name])
                out[h.name] = {"ms": dev_ms, "host_ms": h_ms, "calls": len(calls[h.name])}
    print(json.dumps({"kernel_times": out, "root": ROOT, "card": card_line()}), flush=True)
    return 0


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
    from transmission_renderer_tpu_torch.ops import bvh_packet, raster_gbuf, raster_vis
    from transmission_renderer_tpu_torch.ops.cull import transform_vertices
    from transmission_renderer_tpu_torch.render.frame import render_frame
    from transmission_renderer_tpu_torch.scene.textures import linear_to_srgb
    from transmission_renderer_tpu_torch.utils.png import read_png
    from transmission_renderer_tpu_torch.utils.profiling import PASS_NAMES

    # ---- 2. build ------------------------------------------------------------
    info = kernels.build()
    log(f"build: {'compiled' if info.built else 'up to date'} in "
        f"{info.seconds:.2f} s -> {os.path.relpath(info.path, ROOT)}")
    for line in info.log.splitlines():
        if any(s in line for s in ("Compiling entry", "registers", "spill")) or \
                "error" in line.lower():
            log(f"  ptxas: {line.strip()}")

    # ---- 3. scene --------------------------------------------------------------
    t0 = time.perf_counter()
    builder, scene, dl, flags, params, lights = flagship_scene(dev)
    cfg = RenderConfig(width=1920, height=1080)
    n_tris = int(dl.tri_vtx.shape[0])
    log(f"scene: dragon {n_tris} triangles, {cfg.width}x{cfg.height}, built in "
        f"{time.perf_counter() - t0:.2f} s, flags {flags}")

    def frame(**kw):
        return render_frame(scene, dl, params, lights, cfg, flags, **kw)

    handles = port_handles()[:4]

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
        k_ms, h_ms = kernel_ms(h, calls[h.name])
        p_ms = plain_ms(h, calls[h.name])
        log(f"kernel {h.name} on [{card}]: {k_ms:.3f} ms/frame on the device (host "
            f"{h_ms:.3f}), plain {p_ms:.3f} ms/frame "
            f"({len(calls[h.name])} call(s) per frame)")

    # ---- 7. ray-traced shadows ---------------------------------------------------
    cfg_rt = RenderConfig(width=1920, height=1080, ray_traced_shadows=True)
    t0 = time.perf_counter()
    bvh = builder.build_rt_bvh(device=dev)
    log(f"rt: BVH over {bvh.num_tris} triangles, {bvh.num_leaves} leaves, levels "
        f"{bvh.level_counts}, built in {time.perf_counter() - t0:.2f} s")

    def rt_frame(**kw):
        return render_frame(scene, dl, params, lights, cfg_rt, flags, bvh=bvh, **kw)

    rt_handles = port_handles()[:5]
    # (a) the occlusion kernel's hit set, exactly; the plain walk also
    # counts the pops and triangle tests that the bound's operations come
    # from. The packet table is built from the frame's world positions
    # (the geometry pass's transform of the same draw list)
    n_kinds = 1 + lights.num  # the sun and each light
    world_pos = transform_vertices(scene, dl, params.proj_view)[0]
    rt_calls = capture(rt_handles, rt_frame)
    occl = check_occlusion(rt_calls["bvh_occlusion"], n_kinds, "rt ", dl.tri_vtx, world_pos)
    walk_counts = [(r[0], r[5]) for r in occl]
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
        k_ms, h_ms = kernel_ms(h, rt_calls[h.name])
        p_ms = plain_ms(h, rt_calls[h.name])
        if h.name == "bvh_occlusion":
            per_call = walk_counts
        elif h.name == "raster_gbuf":  # covering pixel-record pairs, pixels with a winner
            per_call = gbuf_counts(rt_calls[h.name])
            pairs = [raster_runs(h.name, c)[1] * 1024 for c in rt_calls[h.name]]
            log(f"rt kernel raster_gbuf per call: pixel-record pairs {pairs}, where the "
                f"record covers the pixel {[p[0] for p in per_call]}, pixels with a winner "
                f"{[p[1] for p in per_call]}")
        else:
            per_call = [None] * len(rt_calls[h.name])
        works = [kernel_work(h.name, c, p) for c, p in zip(rt_calls[h.name], per_call)]
        b_ms, b_by = bound_of(works)
        log(f"rt kernel {h.name} on [{card}]: {k_ms:.3f} ms/frame on the device (host "
            f"{h_ms:.3f}), plain {p_ms:.3f} "
            f"ms/frame, bound {b_ms:.4f} ms by {b_by} ({sum(w[0] for w in works)} "
            f"bytes, {sum(w[1] for w in works)} operations), {b_ms / k_ms:.4f} of "
            f"the bound reached, {len(rt_calls[h.name])} call(s) per frame")
        kernel_rows.append({
            "name": h.name, "route": "cuda", "source": h.source,
            "replaces": h.replaces, "launches": rt_launches[h.name],
            "max_abs_err": None, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None, "frame": "rt",
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
    occl_h = check_occlusion(half_calls["bvh_occlusion"], n_kinds, "half-res ", dl.tri_vtx,
                             world_pos)
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

    vis_handles = port_handles()
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
    k_ms, h_ms = kernel_ms(h, vis_calls[h.name])
    p_ms = plain_ms(h, vis_calls[h.name])
    # covering pixel-record pairs, pixels with a winner
    per_call = [(raster_vis.covered_pairs(*a, pass_class=kw.get("pass_class")),
                 int((h.replay((a, kw), True)[0] >= 0).sum())) for a, kw in vis_calls[h.name]]
    pairs = [(int(a[3].sum()) + a[1].numel() * int(a[4][0])) * a[7] * a[8]
             for a, _ in vis_calls[h.name]]
    log(f"vis kernel raster_vis per call: pixel-record pairs {pairs}, where the record "
        f"covers the pixel {[p[0] for p in per_call]}, pixels with a winner "
        f"{[p[1] for p in per_call]}")
    works = [kernel_work(h.name, c, p) for c, p in zip(vis_calls[h.name], per_call)]
    b_ms, b_by = bound_of(works)
    log(f"vis kernel {h.name} on [{card}]: {k_ms:.3f} ms/frame on the device (host "
        f"{h_ms:.3f}), plain {p_ms:.3f} "
        f"ms/frame, bound {b_ms:.4f} ms by {b_by} ({sum(w[0] for w in works)} bytes, "
        f"{sum(w[1] for w in works)} operations), {b_ms / k_ms:.4f} of the bound "
        f"reached, {len(vis_calls[h.name])} call(s) per frame")
    kernel_rows.append({
        "name": h.name, "route": "cuda", "source": h.source, "replaces": h.replaces,
        "launches": vis_launches[h.name], "max_abs_err": None, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "frame": "vis",
    })

    # (f) kernel 1 on the frame's own materialised bins: every tile walks
    # the big list before its run, as the reference's kernel does
    # (raster_pallas_gbuf.py:339-345); no frame reaches the big list
    # through kernel 1 otherwise
    big_calls = gbuf_on_materialised_bins(scene, dl, params, cfg_vis)
    for (a, kw) in big_calls["raster_gbuf"]:
        log(f"vis kernel-1 replay: big list {int(a[3][0])} records walked by each of "
            f"{a[1].numel()} tiles, seeded {kw.get('init_depth_tiles') is not None}")
    check_parity((raster_gbuf.KERNEL,), big_calls, max_err, "vis materialised bins ")

    # ---- 9. the stress frame ----------------------------------------------------
    stress_rows = stress_phase(card, max_err)

    # ---- 10. the bench's other scenes --------------------------------------------
    bench_launches, bench_kernels = bench_scenes_phase(card, max_err)

    for row in kernel_rows:  # the worst over every frame checked
        row["max_abs_err"] = max_err[row["name"]]
    log(json.dumps({"bench_kernels": bench_kernels}))
    log(json.dumps({"stress_launches": stress_rows}))
    log(json.dumps({"bench_launches": bench_launches}))
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(kernel_times() if sys.argv[1:] == ["--kernel-times"] else main())
