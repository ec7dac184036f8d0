#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's frames of the bench's scenes once on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times
    python3 chip_smoke.py --sharded-cards

The second form only builds the kernels, captures every kernel's calls
on the widest frame that launches it (kernels 1-5 on phase 7's
ray-traced frame, kernel 6 on phase 8's visibility-buffer frame, its
alpha form on phase 13's) and prints one JSON line of their ms per
frame: run beside another tree's
package (a copy of this script in that tree's root), it times that
tree's kernels on the same inputs, so two versions can be timed in turns
in one call. The third needs four cards: the row-band frame on 2 and 4
ranks with a card each, over NCCL (sharded_cards).

Phases (any failure raises and exits non-zero; nothing falls back):

1. device: a CUDA device must be present; prints the card's name and
   power limit (nvidia-smi) and torch.cuda.get_device_name().
2. build: compiles the eight CUDA kernels (transmission_renderer_tpu_torch/
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
   cluster (the warps a warp-shared light list would serve). Then the
   pixel box (sliver_check): a sliver of the glass blob whose float32
   edge functions read "inside" 3 px past its vertices' box at 1920x1080
   draws no pixel through kernel 1 nor through kernel 6 (both orders),
   and draws that pixel through kernel 1 with its box widened to the
   screen, so the witness is live on the card.
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
   on its ten calls, the peel's max_depth calls included; the peel's
   alpha test, csrc/clip_alpha.cu, bit for bit on its eight calls over a
   random ok state, the rows no slot names left alone: check_clip_alpha;
   the others as phase 4); (b) with the counts reset, the frame launches
   raster 10 (opaque, the class-2 peel's first round and 3 re-races,
   transmission, the class-3 peel's first round and 3 re-races), tap 1,
   shade 2, fetch 1, clip_alpha 8 (one alpha test per round),
   clip_worklist 6 and clip_merge 6 (one each per re-race round); (c)
   FrameDiagnostics at the bench's camera (yaw 0) and at its
   sweep's far end (the bench's smoothed rig after target yaw 0.18,
   bench_rig): the clip caps [608, 162, 41], no capacity overflow but the
   peel's, the clip diagnostics printed beside the reference's
   (STRESS_REFERENCE, BENCH_r05.json); (d) a finite image in [0, 1], and
   with the peel run to convergence (8 rounds, full re-race caps: no
   unresolved pixel) sRGB RMSE < 4e-3 against tests/goldens/stress_hd.png
   (the reference's 1080p frame, rendered on the CPU by its
   visibility-buffer branch); at the bench config the RMSE over the frame
   and outside the tiles holding unresolved pixels is printed, and the
   converged frame's 16 alpha tests through check_clip_alpha and its 14
   re-race rounds' worklists and merges (csrc/clip_peel.cu) through
   check_clip_peel; (e) median
   ms/frame over 10 frames after 2 warm-ups, per-pass ms (the peel's
   ranges too), kernel 1's ms over the frame's calls, the alpha
   test's over the converged frame's (the benchmark's peel) and the
   worklists' and merges' in a profiled converged frame beside their
   plain versions' and their bounds. Its launch counts are printed on a
   line of their own before the kernels line.
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

11. the port's CLI (transmission_renderer_tpu_torch/cli.py), driven in
   process through cli.main at its defaults (1920x1080, the flagship
   camera, sun and lights), each run with every launch count set to 0
   just before it and read just after: (a) --procedural dragon
   --roughness-override 0.25: its frame equals phase 5's render_frame
   frame (max abs error 0) and its PNG meets dragon_hd.png outside
   GOLDEN_DROPPED_TILES at sRGB RMSE < 4e-3; (b) --procedural dragon
   --as-debug: the closest-hit kernel launches once and nothing else
   does, and on the frame's 2.07M camera rays its hit and triangle id
   equal its plain walk's on every ray (t, u, v: the max abs error is
   printed and reported), the plain walk's pops, triangle tests by exit
   stage and alpha tests, the kernel's ms per frame (device_ms), the
   plain walk's ms and the bound (kernel_work); (c) --procedural stress
   --as-debug: the same equalities, and the rays whose closest candidate
   an alpha test rejected (the kernel replayed with every cutoff at
   -inf: > 0); (d) --debug-clusters --cluster-wireframe 5 on the dragon:
   the reference's gate sends both shade passes to the tensor shade, so
   kernel 1 launches twice and kernels 2-4 never; the image finite in
   [0, 1]; (e) tests/assets/multi.glb --external-model --no-sponza
   --check-nan (a GLB with binary-chunk PNGs, decoded without PIL): a
   finite image, one VALIDATION line, the sparse transmissive raster's
   tile overflow (MULTI_GLB_TRANSMISSION_TILES, the reference's own
   count, against the default cap of 507) and no other, kernel 1 bit for
   bit against its plain version on the frame's calls
   (check_multi_glb_run); (f) --procedural dragon
   --spotlights --rotate-model --frames 3: three PNGs, finite, frames 1
   and 2 differ from frame 0; (g) --procedural dragon --roughness-override
   0.25 --debug-checks: exit 0, no report, kernel 6 (its checked form)
   launched twice and nothing else, the frame equal to phase 8's.
12. the frame variants (variants_phase), each frame at 1920x1080 unless
   said, with every kernel call through the kernel and its plain version
   at phase 4's tolerances (kernels 1 and 6 bit for bit, kernel 5's hit
   sets exact; a call on the very same inputs as one held in an earlier
   phase, such as a pass two frames share, is reported and not replayed
   again), the launches with the counts reset, a finite image in [0, 1],
   and the median ms/frame over 5 after 2 beside the flagship's from the
   same phase: (a) the flagship with each quality flag, each within the
   reference's own bound of the exact flagship frame (half-res 0.02 and
   quad taps 0.1 linear RMSE, bf16 1e-2 sRGB RMSE); (b) the flagship with
   a metallic-roughness texture on its glass (textured_glass_dragon): no
   static level set, so kernel 4's full-pyramid form, its ms, plain ms
   and bound, and the frame within linear RMSE 1e-4 of the same frame
   through the tensor shade; (c) the dense transmission raster and shade
   (tile cap None, block cap None) with ray-traced shadows, both passes'
   rays in 8x16 groups: equal to phase 7's fused sparse frame; (d) the
   flagship at 1600x900 (partial last tile column and row, tensor
   shades); (e) the stress frame at the bench's config with ray-traced
   shadows (the compacted transmission worklist's rays in its own order;
   nowhere brighter in HDR than without them); (f) the visibility-buffer
   flagship with ray-traced shadows (likewise against phase 8's frame);
   (g) cli.main with each flag: (a)'s frames exactly, and (a)'s launches.
13. the visibility-buffer stress frame (vis_clip_phase): the stress scene
   at RenderConfig(1920, 1080, opaque_block_cap_frac=0.8125,
   use_pallas_raster=False) with tests/goldens/stress_hd.png's camera and
   lights, whose raster kills alpha-clip fragments in kernel 6's depth
   race (its alpha form). (a) kernel 6's two calls through the kernel and
   its plain version: tri ids, depth and barycentrics bit for bit, with
   the fragments the alpha test checks and taps per call; (b) with the
   counts reset, raster_vis 2 launches and no other kernel; (c) a finite
   image in [0, 1] without overflow, its FrameDiagnostics equal to the
   reference's (STRESS_VIS_DIAGNOSTICS); (d) sRGB RMSE < 4e-3 against
   stress_hd.png over the whole frame (the reference's render of this
   branch); (e) the median ms/frame over 10 after 2, per-pass ms, and the
   alpha form's ms per frame beside its plain version's and its bound
   (kernel_work with alpha_taps); (f) checked_frame_fn on the same frame
   (kernel 6's checked form): silent and bit-equal; (g) injected
   out-of-range indices at covered sites: the clip materials' diffuse
   texture past the atlas through the checked frame, and a run start past
   the records through the checked kernel: both reported, and the process
   renders the same frame afterwards.
14. glTF JPEG images (jpeg_phase, without PIL): (a)
   utils/jpeg.py's decode_jpeg on each image of tests/assets/jpeg.glb
   (multi.glb's scene with baseline 4:2:0 + restart markers, progressive
   4:2:2 and greyscale JPEGs) gives PIL's RGBA by the SHA-256 and shape
   in tests/assets/jpeg_digests.json; (b) jpeg.glb through cli.main at
   its defaults with --check-nan, held as (e) holds multi.glb, its
   launches equal to (e)'s; (c) that 1920x1080 frame equals bit for bit
   the frame of its PNG twin (the same GLB with each image a PNG of its
   decoded RGBA, written by utils/png.py); (d) each image's decode time
   and seconds per megapixel, host time.
15. the row-band sharded frames (sharded_phase; parallel/sharded.py) at
   1920x1080: (a) one rank in an NCCL group: the flagship's kernel calls
   (kernels 1-3 on the band's tiles; kernel 4 must not run, the band
   pyramid's sampler replaces its fetch) against their plain versions,
   then their ms per frame and bound; launches raster 2, tap 1, shade 2,
   fetch 0; the frame within 2e-6 of render_frame's, no overflow, the
   diagnostics the two share equal (the tier ladder's, the peel's); (b)
   2 and 4 ranks sharing the card (gloo, staged through the host), each
   a process (parallel/ranks.py): at a halo of the band height the frame
   within 2e-6 of (a)'s everywhere, at the default halo off the glass
   (the pixels (a)'s transmissive raster won), the glass pixels beyond
   2e-6 counted; diagnostics equal to (a)'s; every kernel call of the
   last band, whose tiles run into the rows padded below the frame,
   against its plain version; (c) on 2 ranks the stress frame with its
   peel converged against stress_hd.png (sRGB RMSE < 4e-3), its alpha
   tests, and its 14 re-race rounds' worklists and merges on the band's
   tile ids, bit for bit against their plain versions on every rank
   (check_clip_alpha, check_clip_peel), and (d) the
   ray-traced flagship within 2e-6 of (a)'s off the glass, kernel 5's
   calls of every band exact against the plain walk; (e) cli.main with
   --devices 2 exits 2 with the reference's "only 1 available" on one
   card; (f) ms/frame of render_frame and of each band count, median of
   10 after 2 on the host clock (ranks sharing one card say nothing about
   scaling). --sharded-cards runs the frame on 2 and 4 ranks with a card
   each (NCCL) against render_frame, on a four-card machine.
16. pair-stream compaction and the frontier traversal: (a) the flagship
   with pallas_pair_cap_frac (compaction_phase): its binning call's
   stream compacted at PAIR_FIT_FRAC equals the uncompacted valid prefix
   (tile_start equal); the frame launches raster 2, tap 1, shade 2, fetch
   1, reports the binning's pair_demand and pair_capacity, no overflow,
   and equals phase 5's frame bit for bit; at PAIR_OVERFLOW_FRAC the
   frame reports pair_demand past pair_capacity and stays finite in [0,
   1]; the binning and payload spans and the frame, with and without
   compaction, median of 10 after 2 in turns (CUDA events); (b) the RT
   flagship's opaque shadow rays (phase 7's first kernel-5 call) through
   ops/bvh.py::trace_shadow_bfs (bfs_phase): hits equal to kernel 5's ray
   for ray with no frontier overflow (cap_factor from 8, doubled and
   printed while it overflows); ms of each in turns and the peak memory
   each allocates.

The kernels JSON object reports every kernel on the widest path that
launches it, named in its "frame" key: kernels 1-5 on the ray-traced
frame ("rt", phase 7), kernel 6 on the visibility-buffer frame ("vis",
phase 8; the bindless frame, with 48 lights, is kernel 3's busiest,
reported in phase 10(f)), the closest-hit walk on the AS-debug dragon
("as_debug", phase 11(b); it replaces no TPU kernel, its "replaces"
says so); kernel 4's row also carries its full form on the
textured-roughness frame ("full_form", phase 12(b)) and kernel 6's its
alpha form on the visibility-buffer stress frame ("alpha_form", phase
13); the peel's alpha test on the converged stress frame ("stress_conv",
phase 9(e); it replaces no TPU kernel either), and each row's "sharded"
key the one-rank sharded flagship's
launches (phase 15(a); for kernels 1-3 also ms and bound): launches,
worst parity error over every frame checked, ms per frame of the kernel (the card's time for
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
import re
import statistics
import struct
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
        nc = _num_classes(tile_start, width, height, kwargs.get("n_tiles_global"))
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
        # 46 of a record's 64 floats are read (42 and the pixel box); per
        # pixel and record three edge functions and their coverage tests
        # (15 operations), and where the record covers the pixel (data[0]
        # such pairs) the box's 4 tests, the w and z sums, a divide and 5
        # tests more (35 in all); per pixel with a winner (data[1]) its
        # interpolation once: 11 operations of set-up
        # (edge and coefficient sums, 1/D, the 2/(w D^2) scales), 6 per
        # interpolated value (pos, nrm, uv) and 18 more per derivative
        # pair (pos with pos_derivs, uv)
        covered, winners = data
        nbytes = (runs + nbig) * 46 * 4 + tile_ids.numel() * 12 + px * 4 * (seeds + planes)
        interp = 11 + 6 * (6 + 2 * uv) + 18 * (2 * uv + 3 * pd)
        # every tile tests its run and the big list
        pairs = (runs + tile_ids.numel() * nbig) * TILE_H * TILE_W
        return nbytes, (pairs - covered) * 15 + covered * 35 + winners * interp
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
        if len(level_set) == pyramid.num_levels:
            # the full form (every level, level 0 the whole framebuffer):
            # the texels (3 float planes) of the two levels each pixel of
            # this call brackets, each counted once
            levels = 12 * full_form_texels(pyramid, args[2], args[3], args[4])
        else:
            levels = sum(pyramid.levels[k].nbytes for k in level_set)
        # 5 planes in, 5 out; two tent-weighted bilinear level taps of 3
        # channels and a bilinear LUT tap of 2
        return 5 * m * 4 + levels + args[7].nbytes + 5 * m * 4, m * 80
    if name == "raster_vis":
        _, tile_ids, _, run_count, big_count, _, _, tile_w, tile_h = args
        k, px = tile_ids.numel(), tile_ids.numel() * tile_w * tile_h
        runs, nbig = int(run_count.sum()), int(big_count[0])
        seeded = kwargs.get("init_depth_tiles") is not None
        # each walked record (20 floats) read once, the tile list, the seed
        # depth, and the four [K, th, tw] outputs; per pixel and record
        # (each tile's run and the big list) three edge functions and their
        # coverage tests (15 operations), and where the record covers the
        # pixel (data[0] such pairs) the pixel box's 4 tests, the w and z
        # sums, a divide and 5 tests more (35 in all); per pixel with a
        # winner (data[1]) its resolve once: the edge functions, the w and z sums, the depth's divide,
        # the edge sum and the two barycentrics (28). The alpha form
        # (data[2], alpha_taps) adds per fragment it tests that is a
        # clip-bucket triangle's with a diffuse texture 154 operations (the
        # uv and its derivatives 58, the LOD 14, the two levels' footprints
        # 51, their bilinear lerps and the blend 29, the factor and the
        # cutoff test 2) and 2 per other tested fragment (its clip flag),
        # and the bytes of the distinct texels the taps read (the bf16
        # alpha of each once) and of the tested triangles' side-table rows
        # and materials
        covered, winners = data[:2]
        nbytes = (runs + nbig) * 80 + k * 12 + 4 + px * 4 * (seeded + 4)
        pairs = (runs + k * nbig) * tile_w * tile_h
        ops = (pairs - covered) * 15 + covered * 35 + winners * 28
        if len(data) > 2:
            tested, textured, tap_bytes = data[2]
            nbytes += tap_bytes
            ops += textured * 154 + (tested - textured) * 2
        return nbytes, ops
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
    if name == "bvh_closest":
        tree, table, rays, _, alpha = args
        inner, tests, alphas = data
        # every input once (the table, the leaf slots' ids, the rays, the
        # alpha test's triangles, uvs, materials and atlas) and the five
        # outputs (1 + 4 * 4 bytes a ray); the inner pops' slab tests and
        # the triangle tests by exit stage as bvh_occlusion's, every real
        # slot of a popped leaf tested (closest hit has no early exit),
        # and per alpha test of a candidate that hit (alphas: textured,
        # untextured) 36 operations where the material has a diffuse
        # texture: the barycentric uv (12), the LOD-0 footprint (16), the
        # lerp (6), the factor and the cutoff test (2); 2 where it has
        # none. The plain walk tests a leaf's candidates against the best
        # t at the pop, the kernel against its running best, so these
        # counts may exceed the kernel's own by the candidates a nearer
        # one in the same leaf hides: the bound may lean high, never low
        n = rays.shape[1]
        nbytes = (sum(t.nbytes for t in table) + tree.leaf_tri.nbytes + rays.nbytes
                  + sum(t.nbytes for t in alpha) + n * 17)
        ops = (inner * 8 * 25 + sum(k * c for k, c in zip(tests, (16, 28, 46, 54)))
               + alphas[0] * 36 + alphas[1] * 2)
        return nbytes, ops
    raise KeyError(name)


def tap_texel_keys(rows, tid, uv, lod) -> list:
    """Keys of the texels a trilinear REPEAT tap of each diffuse ref
    ``tid`` (packed image | layer << 16) reads at ``uv`` and ``lod``: the
    2x2 footprint of both levels, one key per (image, layer, level, x, y)."""
    import torch
    from transmission_renderer_tpu_torch.ops.texture import _level_meta_from_rows, _tap_footprint
    from transmission_renderer_tpu_torch.scene.textures import IMAGE_MASK, LAYER_SHIFT, WRAP_REPEAT

    keys = []
    l0 = torch.floor(torch.clamp(lod, min=0.0)).to(torch.int32)
    image = ((tid & IMAGE_MASK).long() * 32 + (tid >> LAYER_SHIFT).long()) * 16
    for lvl in (l0, l0 + 1):
        off, w, h = _level_meta_from_rows(rows, lvl)
        _, _, _, x0, y0 = _tap_footprint(off, w, h, uv, WRAP_REPEAT)
        level = torch.minimum(torch.clamp(lvl, min=0), rows[:, 0] - 1).long()
        for dy in (0, 1):
            for dx in (0, 1):
                x, y = ((x0 + dx) % w).long(), ((y0 + dy) % h).long()
                keys.append(((image + level) << 32) | (y << 16) | x)
    return keys


def clip_alpha_work(call) -> tuple:
    """(bytes, operations) one call of the peel's alpha test must move and
    compute: per pixel of a slot with a tile id its tri read and its ok
    byte written (5 B), per winner its material (4 B), per textured winner
    its uv and derivatives (24 B); the bf16 alpha of each distinct texel
    the textured winners' taps read and the material rows they name (a
    diffuse ref, factor and cutoff: 12 B); per textured winner the LOD (14
    operations), two levels' footprints (20) and bilinear lerps (18), the
    blend (3), the factor and the compare (2)."""
    import torch
    from transmission_renderer_tpu_torch.render.shading import _mip_lod
    from transmission_renderer_tpu_torch.scene.textures import IMAGE_MASK, META_COLS

    (scene, ch, ids, n_tiles, _), _ = call
    live = (ids < n_tiles)[:, None, None]
    m = scene.materials
    mat = torch.clamp(ch["material"], min=0).long()
    tid = m.tex_diffuse[mat]
    winners = (ch["tri"] >= 0) & live
    textured = winners & (tid >= 0)
    mats = torch.unique(mat[winners])
    mat, tid = mat[textured], tid[textured]
    rows = scene.atlas_meta[(tid & IMAGE_MASK).long()][:, :META_COLS]
    pick = [ch[n][textured] for n in ("uv_u", "uv_v", "duvdx_u", "duvdx_v", "duvdy_u",
                                       "duvdy_v")]
    lod = _mip_lod(torch.stack(pick[2:4], -1), torch.stack(pick[4:6], -1), rows[:, 2],
                   rows[:, 3])
    keys = tap_texel_keys(rows, tid, torch.stack(pick[:2], -1), lod)
    texels = int(torch.unique(torch.cat(keys)).numel()) if keys else 0
    n = int(textured.sum())
    px = int(live.sum()) * 8 * 128
    nbytes = px * 5 + int(winners.sum()) * 4 + n * 24 + texels * 2 + mats.numel() * 12
    return nbytes, n * 57


def full_form_texels(pyramid, uv_x, uv_y, lod) -> int:
    """Distinct texels that kernel 4's full form reads for these pixels:
    the four texels of the clamp-to-edge bilinear footprint
    (csrc/transmission_fetch.cu::bilinear_clamp) at each of the two levels
    bracketing each lod, as ids into the levels laid end to end."""
    import torch

    top = pyramid.num_levels - 1
    l0 = torch.floor(torch.clamp(lod, 0.0, float(top))).long()
    ids, base = [], 0
    for k, (w, h) in enumerate(zip(pyramid.widths, pyramid.heights)):
        at = (l0 == k) | (torch.clamp(l0 + 1, max=top) == k)
        x0 = torch.floor(uv_x[at] * float(w) - 0.5).long().clamp(0, w - 1)
        y0 = torch.floor(uv_y[at] * float(h) - 0.5).long().clamp(0, h - 1)
        for yy in (y0, (y0 + 1).clamp(max=h - 1)):
            for xx in (x0, (x0 + 1).clamp(max=w - 1)):
                ids.append(base + yy * w + xx)
        base += w * h
    return int(torch.unique(torch.cat(ids)).numel())


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
        nc = _num_classes(tile_start, width, height, kwargs.get("n_tiles_global"))
        count = _tile_runs(tile_start, tile_ids, nc, kwargs.get("pass_class"))[1]
    tile_ids = args[1]
    recs = int(count.sum())
    return tile_ids.numel(), recs, recs / max(tile_ids.numel(), 1), int(count.max())


def gbuf_counts(calls) -> list:
    """Per kernel-1 call (the pixel-record pairs where the record covers
    the pixel, the pixels with a winner): the counts of its bound."""
    from transmission_renderer_tpu_torch.ops import raster_gbuf

    return [(raster_gbuf.covered_pairs(*a[:3], *a[4:6], kw.get("pass_class"),
                                       big_count=a[3], n_tiles_global=kw.get("n_tiles_global")),
             int((raster_gbuf.KERNEL.replay((a, kw), True)["tri"] >= 0).sum()))
            for a, kw in calls]


# every call held against its plain version so far, per kernel: a later
# frame's call on the very same inputs (a pass two frames share) was held
# there, and is not replayed through the plain version again
VERIFIED: dict = {}


def same_inputs(a, b) -> bool:
    """Whether two recorded call arguments are equal, tensors by value."""
    import dataclasses

    import torch

    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.shape == b.shape and a.dtype == b.dtype and a.device == b.device
                and bool(torch.equal(a, b)))
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(same_inputs(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_inputs(a[k], b[k]) for k in a))
    if dataclasses.is_dataclass(a):
        return (type(a) is type(b) and all(same_inputs(getattr(a, f.name), getattr(b, f.name))
                                           for f in dataclasses.fields(a)))
    return type(a) is type(b) and a == b


def check_parity(handles, calls, max_err, tag: str) -> None:
    """Replay every recorded call through the kernel and the plain
    version; raise on a disagreement. A call on the same inputs as one
    held before is reported as such and not replayed again."""
    import torch
    from transmission_renderer_tpu_torch.render.shade_kernel import shade_work

    for h in handles:
        require(len(calls[h.name]) > 0, f"{h.name}: the frame never called it")
        seen = VERIFIED.setdefault(h.name, [])
        for i, call in enumerate(calls[h.name]):
            prev = next((t for t, c in seen if same_inputs(c, call)), None)
            if prev is not None:
                log(f"parity {tag}{h.name}[{i}]: the same inputs as {prev}, held there")
                continue
            seen.append((f"{tag}{h.name}[{i}]", call))
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


def check_clip_alpha(calls, max_err, tag: str) -> None:
    """Replay each recorded call of the peel's alpha test
    (render/frame.py::CLIP_ALPHA_KERNEL) through the kernel and the plain
    version, each over a copy of one random ok state: equal bit for bit,
    and the rows no slot names (the empty slots' pad row among them) as
    they were; raise on a difference."""
    import torch
    from transmission_renderer_tpu_torch.render.frame import CLIP_ALPHA_KERNEL as h

    require(len(calls) > 0, f"{tag}clip_alpha: the frame never called it")
    gen = torch.Generator(device=calls[0][0][4].device).manual_seed(29)
    for i, ((scene, ch, ids, n_tiles, ok_p), kw) in enumerate(calls):
        base = torch.rand(ok_p.shape, generator=gen, device=ok_p.device) < 0.5
        got = h.replay(((scene, ch, ids, n_tiles, base.clone()), kw), True)
        ref = h.replay(((scene, ch, ids, n_tiles, base.clone()), kw), False)
        named = torch.zeros(n_tiles + 1, dtype=torch.bool, device=ok_p.device)
        named[ids.long()] = True
        named[n_tiles] = False
        live = ids < n_tiles
        fail = (ch["tri"] >= 0) & ~got[ids.long()] & live[:, None, None]
        bad, moved = int((got != ref).sum()), int((got[~named] != base[~named]).sum())
        ok = bad == 0 and moved == 0
        log(f"parity {tag}clip_alpha[{i}]: {int(live.sum())} slots of {n_tiles} tiles "
            f"({int((~live).sum())} empty), {int(fail.sum())} winners fail, differing {bad}, "
            f"rows no slot names changed {moved}, {'ok' if ok else 'FAIL'}")
        require(ok, "clip_alpha: kernel disagrees with its plain version")
    max_err["clip_alpha"] = 0.0


def snapshot(x):
    """``x`` with every tensor in it copied (tuples, lists and dicts
    walked)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: snapshot(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(snapshot(v) for v in x)
    return x


class Snapshots(list):
    """A KernelHandle recorder that keeps each call's arguments as they
    were when the call was made: the peel's worklist and merge read a
    state and ok that later rounds change in place."""

    def append(self, call):
        super().append(snapshot(call))


def words(t):
    """A float32 tensor's bits as int32 (other tensors as they are)."""
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


# the peel's re-race kernels (csrc/clip_peel.cu)
PEEL_KERNELS = ("peel_flag_kernel", "peel_compact_kernel", "peel_gather_kernel",
                "peel_merge_kernel")


def check_clip_peel(wl_calls, mg_calls, tag: str) -> None:
    """Replay each recorded round's worklist (render/frame.py::
    CLIP_WORKLIST_KERNEL) and merge (CLIP_MERGE_KERNEL), recorded by
    Snapshots, through the kernels and the plain versions, each over a
    copy of its arguments: every output, and the merged state and raced
    channels, equal bit for bit; raise on a difference."""
    from transmission_renderer_tpu_torch.render.frame import (
        CLIP_MERGE_KERNEL as mg,
        CLIP_WORKLIST_KERNEL as wl,
    )

    require(len(wl_calls) > 0 and len(wl_calls) == len(mg_calls),
            f"{tag}clip_peel: {len(wl_calls)} worklists, {len(mg_calls)} merges")
    for i, (wc, mc) in enumerate(zip(wl_calls, mg_calls)):
        got, ref = wl.replay(snapshot(wc), True), wl.replay(snapshot(wc), False)
        bad_wl = sum(int((words(g) != words(r)).sum()) for g, r in zip(got, ref))
        a, b = snapshot(mc), snapshot(mc)
        mg.replay(a, True)
        mg.replay(b, False)
        (sa, _, _, ra), (sb, _, _, rb) = a[0], b[0]
        bad_mg = int((words(sa) != words(sb)).sum()) + sum(
            int((words(ra[n]) != words(rb[n])).sum()) for n in ra)
        n_tiles, cap = wc[0][0].shape[1], wc[0][5]
        ok = bad_wl == 0 and bad_mg == 0
        log(f"parity {tag}clip_peel[{i}]: demand {int(got[2])} of {n_tiles} tiles, cap {cap}, "
            f"{int((got[0] >= n_tiles).sum())} empty slots; words differing: worklist "
            f"{bad_wl}, merge {bad_mg}, {'ok' if ok else 'FAIL'}")
        require(ok, "clip_peel: a kernel disagrees with its plain version")


def clip_peel_work(wl_call, mg_call) -> tuple:
    """(bytes, 0) one re-race round's worklist and merge must move: every
    tile's tri and ok (5 B a pixel) to find the failing tiles; per slot
    pixel its seed and state depth read and kernel 1's two inputs written
    (16 B); per live slot's pixel its tri and ok (5 B) and per channel one
    word read and one written (8 B). No arithmetic."""
    (state, _, _, _, _, cap), _ = wl_call
    (_, _, ids, _), _ = mg_call
    n_ch, n_tiles = state.shape[:2]
    live = int((ids < n_tiles).sum())
    return (n_tiles * 5 + cap * 16 + live * (5 + 8 * n_ch)) * 8 * 128, 0


def profiled_kernel_ms(frame, names) -> float:
    """Device ms of the kernels whose names hold one of ``names`` in one
    profiled ``frame()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        frame()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if any(n in ev.key for n in names)) / 1000.0


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


# a sliver of the glass blob (the benchmark's dragon.orbit, seed 4004,
# frame 32): clip-space vertices as the frame computes them; at 1920x1080
# its float32 edge functions read "inside" at pixel (1160, 170), 3 px
# right of its vertices' box, where float64 reads outside, and no pixel
# centre lies inside it (the tests of the pixel box read it from here)
SLIVER = [[0.9275342226028442, -3.1695566177368164, 0.009908081032335758, 4.605861186981201],
          [0.9480902552604675, -3.1573805809020996, 0.009908118285238743, 4.604023456573486],
          [0.9262080192565918, -3.165588140487671, 0.009908199310302734, 4.599979877471924]]
SLIVER_PIXEL = (1160, 170)


def sliver_check(dev) -> None:
    """Kernels 1 and 6 on the card draw no pixel of SLIVER at 1920x1080;
    kernel 1 with the record's box widened to the screen draws exactly
    SLIVER_PIXEL (the edge functions alone cover it)."""
    import torch

    from transmission_renderer_tpu_torch.ops import raster, raster_gbuf, raster_vis

    w, h = 1920, 1080
    clip = torch.tensor(SLIVER, dtype=torch.float32, device=dev)
    tris = torch.tensor([[0, 1, 2]], dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    setup = raster.setup_triangles(clip, tris, one, w, h, 128, 8)
    x, y = SLIVER_PIXEL
    tile = (y // 8) * (w // 128) + x // 128
    ids = torch.tensor([tile], dtype=torch.int32, device=dev)
    cls = torch.zeros(1, dtype=torch.int32, device=dev)
    bins = raster.bin_triangles(setup, w // 128, -(-h // 8), 8, cls, 2,
                                ((8, 4096), (128, 512), (2048, 64), (0, 16)))
    zeros = torch.zeros(3, 3, device=dev)
    rec = raster_gbuf.pack_gbuf_payload(setup, tris, cls, torch.ones(1, device=dev), zeros,
                                        zeros, torch.zeros(3, 2, device=dev), cls)
    drawn = {}
    for tag, box in (("box", None), ("screen", [0.0, 0.0, w - 1.0, h - 1.0])):
        r = rec.clone()
        if box is not None:
            r[:, raster_gbuf.BOX_F32 : raster_gbuf.BOX_F32 + 4] = torch.tensor(box, device=dev)
        ch = raster_gbuf.rasterize_gbuffer_tiles(raster_gbuf.gather_gbuf_payload(r, bins), ids,
                                                 bins.tile_start, 0, w, h, pass_class=0)
        drawn[tag] = [(tile % (w // 128) * 128 + c, tile // (w // 128) * 8 + rr)
                      for rr, c in torch.nonzero(ch["tri"][0] >= 0).tolist()]
    mat = raster.bin_triangles_materialized(setup, w // 128, -(-h // 8), 8, 64, 16)
    payload = raster_vis.gather_bin_payload(setup, mat)
    tid = ids.long()
    vis = {}
    for xla in (True, False):
        count = (mat.tile_tri_count[tid] if xla
                 else mat.tile_start[tid + 1] - mat.tile_start[tid]).to(torch.int32)
        tri = raster_vis.raster_vis(payload, ids, mat.tile_start[tid].contiguous(),
                                    count.contiguous(), torch.zeros(1, dtype=torch.int32,
                                                                    device=dev),
                                    w, h, 128, 8, xla_order=xla)[0]
        vis[xla] = int((tri >= 0).sum())
    torch.cuda.synchronize()
    log(f"sliver at {SLIVER_PIXEL}: kernel 1 draws {drawn['box']} (box from the set-up "
        f"{setup.pixel_box[0].tolist()}), {drawn['screen']} with the box widened to the "
        f"screen; kernel 6 draws {vis[True]} (XLA order), {vis[False]} (kernel-6 order)")
    require(drawn["box"] == [] and vis == {True: 0, False: 0},
            "the sliver drew a pixel past its box on the card")
    require(drawn["screen"] == [SLIVER_PIXEL], "the sliver's witness pixel is not live")


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


def flagship_rig():
    """The flagship's camera and sun (tests/golden_defs.py::render_hd_golden)."""
    from transmission_renderer_tpu_torch.scene.camera import CameraRig

    rig = CameraRig()
    rig.camera.position = np.array([0.0, 2.2, 1.5], np.float32)
    rig.camera.pitch = -0.25
    rig.sun_yaw = 4.8
    return rig


def flagship_scene(dev):
    """The flagship scene, camera and lights (tests/golden_defs.py::
    render_hd_golden) on ``dev`` -> (builder, scene, draw list, flags,
    1080p frame params, lights)."""
    from transmission_renderer_tpu_torch.config import RenderConfig
    from transmission_renderer_tpu_torch.models.procedural import build_dragon_scene
    from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
    from transmission_renderer_tpu_torch.render.frame import make_frame_params

    builder = build_dragon_scene(roughness_override=0.25)
    scene, dl, flags = builder.finish_bundle(device=dev)
    rig = flagship_rig()
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
    sweep's smoothed updates (CameraRig.update at dt 1/60: position
    half-time 0.5, rotation 0.25, toward the rig's default target position
    (0, 3, 1) and pitch -15 degrees and the sweep's target yaw; update n
    aims at yaw 0.02 min(n, 9))."""
    from transmission_renderer_tpu_torch.scene.camera import CameraRig

    rig = CameraRig()
    rig.camera.position = np.array([0.0, 2.2, 1.5], np.float32)
    rig.camera.pitch = -0.25
    for n in range(sweep_updates):
        rig.target_yaw = 0.02 * min(n, 9)
        rig.update(1.0 / 60.0)
    return rig


def make_params(cfg, rig, dev):
    """The frame params of a CameraRig's camera and sun at ``cfg``."""
    from transmission_renderer_tpu_torch.render.frame import make_frame_params

    return make_frame_params(cfg, rig.camera.view_matrix(), rig.camera.position,
                             rig.sun_dir(), device=dev)


def stress_phase(card: str, max_err: dict) -> tuple:
    """Phase 9, the stress frame: kernel parity on every call of the
    frame, the launches, the clip diagnostics at both ends of the bench's
    sweep, the golden, the timing. -> (the frame's launch counts, the
    kernels JSON row of the peel's alpha test)."""
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
        return render_frame(scene, dl, p, lights, c, flags=flags, **kw)

    handles = port_handles()[:4]
    clip = frame_mod.CLIP_ALPHA_KERNEL
    # (a) every kernel call of the frame through the kernel and its plain
    # version: kernel 1 bit for bit on all ten, the peel bounds included;
    # the peel's eight alpha tests bit for bit
    calls = capture(handles + (clip,), frame)
    for i, (a, kw) in enumerate(calls["raster_gbuf"]):
        log(f"stress raster_gbuf[{i}]: pass_class {kw.get('pass_class')}, "
            f"max_depth {kw.get('max_depth_tiles') is not None}, "
            f"seeded {kw.get('init_depth_tiles') is not None}")
    check_parity(handles, calls, max_err, "stress ")
    check_clip_alpha(calls[clip.name], max_err, "stress ")

    # (b) one frame with the counts reset: the reference's call sequence
    # (frame.py:1186-1197, 1417-1456): kernel 1 for the opaque raster, the
    # class-2 peel's first round and 3 re-races, the sparse transmissive
    # raster, the class-3 peel's first round and 3 re-races (the scene has
    # no class-3 triangle; the reference peels whenever alpha clip is on);
    # the diffuse tap once (the glass samples no texture), two shades, one
    # refraction fetch; one alpha test per round of each peel
    peel = (frame_mod.CLIP_WORKLIST_KERNEL, frame_mod.CLIP_MERGE_KERNEL)
    (img, diag), launches = count_launches(handles + (clip,) + peel, frame,
                                           return_diagnostics=True)
    log(f"stress launches per frame: {launches}")
    expect = {"raster_gbuf": 10, "tap_finish": 1, "shade": 2, "transmission_fetch": 1,
              "clip_alpha": 2 * cfg.alpha_clip_rounds,
              "clip_worklist": 2 * (cfg.alpha_clip_rounds - 1),
              "clip_merge": 2 * (cfg.alpha_clip_rounds - 1)}
    require(launches == expect, f"stress launch counts {launches}, expected {expect}")

    # (c) the diagnostics at both ends of the bench's sweep, the unresolved
    # pixels' mask recorded from the peel
    masks = []
    peeled = frame_mod._rasterize_clip_peeled

    def recording_peel(*args, **kwargs):
        out = peeled(*args, **kwargs)
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
        frame_mod._rasterize_clip_peeled = peeled
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
    clip.recorder = []
    for h in peel:
        h.recorder = Snapshots()
    try:
        img_conv, d_conv = frame(params, cfg_conv, return_diagnostics=True)
        torch.cuda.synchronize()
    finally:
        conv_calls, clip.recorder = clip.recorder, None
        (wl_conv, mg_conv) = (h.recorder for h in peel)
        for h in peel:
            h.recorder = None
    log(f"stress converged (alpha_clip_rounds 8, clip_retile_cap_frac 1.0): diagnostics "
        f"{diagnostics_dict(d_conv)}")
    require(len(conv_calls) == 2 * cfg_conv.alpha_clip_rounds,
            f"stress converged: {len(conv_calls)} alpha tests")
    check_clip_alpha(conv_calls, max_err, "stress converged ")
    check_clip_peel(wl_conv, mg_conv, "stress converged ")
    max_err["clip_worklist"] = max_err["clip_merge"] = 0.0
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
    # the peel's alpha test on the converged frame's calls: the
    # benchmark's peel (8 rounds, full re-race caps)
    k_ms, h_ms = kernel_ms(clip, conv_calls)
    p_ms = plain_ms(clip, conv_calls)
    works = [clip_alpha_work(c) for c in conv_calls]
    b_ms, b_by = bound_of(works)
    log(f"stress kernel clip_alpha on [{card}]: {k_ms:.4f} ms/frame on the device (host "
        f"{h_ms:.3f}), plain {p_ms:.3f} ms/frame, bound {b_ms:.4f} ms by {b_by} "
        f"({sum(w[0] for w in works)} bytes, {sum(w[1] for w in works)} operations), "
        f"{b_ms / k_ms:.4f} of the bound reached, {len(conv_calls)} calls per converged "
        f"frame; bytes per call {[w[0] for w in works]}")
    row = {"name": clip.name, "route": "cuda", "source": clip.source,
           "replaces": clip.replaces, "launches": len(conv_calls), "max_abs_err": None,
           "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None, "frame": "stress_conv", "sharded": None}
    # the peel's worklists and merges on the converged frame: the kernels'
    # time in one profiled frame, the plain versions' over the recorded
    # rounds (the merges replayed over their recorded state, which they
    # change: the same work)
    works = [clip_peel_work(w, m) for w, m in zip(wl_conv, mg_conv)]
    b_ms, b_by = bound_of(works)
    k_ms = profiled_kernel_ms(lambda: frame(params, cfg_conv), PEEL_KERNELS)
    p_ms = sum(cuda_ms(lambda: h.replay(c, False), 3)
               for h, calls in zip(peel, (wl_conv, mg_conv)) for c in calls)
    log(f"stress kernels clip_worklist + clip_merge on [{card}]: {k_ms:.4f} ms/frame on the "
        f"device (profiled), plain {p_ms:.3f} ms/frame, bound {b_ms:.4f} ms "
        f"by {b_by} ({sum(w[0] for w in works)} bytes), {b_ms / k_ms:.4f} of the bound "
        f"reached, {len(wl_conv)} rounds per converged frame; bytes per round "
        f"{[w[0] for w in works]}")
    peel_row = {"name": "clip_worklist+clip_merge", "route": "cuda",
                "source": peel[0].source, "replaces": peel[0].replaces,
                "launches": len(wl_conv) + len(mg_conv), "max_abs_err": None, "ms": k_ms,
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "frame": "stress_conv", "sharded": None}
    return launches, [row, peel_row]


# FrameDiagnostics of the reference's 1080p stress frame on its
# visibility-buffer branch (the render of tests/goldens/stress_hd.png:
# the bench's stress config, camera and lights), read once from the
# reference on the CPU and pinned; tests/test_torch_vis_clip.py's slow
# test re-derives them.
STRESS_VIS_DIAGNOSTICS = {
    "max_bin_count": 183, "bin_capacity": 2048, "big_tri_count": 50,
    "big_tri_capacity": 256, "opaque_blocks": 11218, "opaque_block_capacity": 13163,
    "transmission_blocks": 1641, "transmission_block_capacity": 4050,
    "clip_unresolved": 0, "mid_tri_count": 0, "mid_tri_capacity": 0,
    "transmission_tiles": 0, "transmission_tile_capacity": 0, "clip_tiles": 0,
    "clip_tile_capacity": 0, "tier_overflow": 0, "clip_round_demand": (),
    "clip_round_caps": (), "pair_demand": 0, "pair_capacity": 0,
}


def alpha_taps(call) -> tuple:
    """(fragments kernel 6's alpha form tests, those it taps in the atlas:
    a clip-bucket triangle's with a diffuse texture, the bytes the tests
    need: the bf16 alpha of each distinct texel the taps read, and the
    side-table row of each tested triangle and the row of each of its
    materials) of one recorded call, counted on its plain version's
    segmented race: the kernel's work items, so the same fragments beat a
    segment's current best and are tested."""
    import torch
    from transmission_renderer_tpu_torch.ops import raster_vis

    args, kw = call
    alpha = kw["alpha"]
    seen = []
    tap = raster_vis.alpha_tap

    def recording(*a):
        seen.append(tap(*a))
        return seen[-1]

    raster_vis.alpha_tap = recording
    try:
        raster_vis.raster_vis_plain(*args, **kw, segment=raster_vis.SEG)
    finally:
        raster_vis.alpha_tap = tap
    tested = textured = 0
    keys, tris, mids = [], [], []
    for tri, mid, tid, rows, uv, lod in seen:
        tested += tri.numel()
        tris.append(tri)
        mids.append(mid)
        at = (alpha.tri_clip[tri] != 0) & (tid >= 0)
        textured += int(at.sum())
        keys += tap_texel_keys(rows[at], tid[at], uv[at], lod[at])
    texels = int(torch.unique(torch.cat(keys)).numel()) if keys else 0
    n_tri = int(torch.unique(torch.cat(tris)).numel()) if tris else 0
    n_mat = int(torch.unique(torch.cat(mids)).numel()) if mids else 0
    return tested, textured, texels * 2 + n_tri * 32 + n_mat * 12


def vis_clip_phase(card: str, max_err: dict) -> dict:
    """Phase 13, the visibility-buffer stress frame: the stress scene at
    the bench's config on the visibility-buffer branch, whose raster
    kills alpha-clip fragments in kernel 6's depth race (its alpha form),
    with the camera and lights of tests/goldens/stress_hd.png; then the
    debug-checks frame (kernel 6's checked form) on it, clean and with
    injected out-of-range indices. -> kernel 6's alpha form's figures."""
    import io

    import torch
    from transmission_renderer_tpu_torch.config import RenderConfig
    from transmission_renderer_tpu_torch.models.procedural import build_stress_scene
    from transmission_renderer_tpu_torch.ops import raster_vis
    from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
    from transmission_renderer_tpu_torch.render import checks
    from transmission_renderer_tpu_torch.render.checks import checked_frame_fn
    from transmission_renderer_tpu_torch.render.frame import render_frame
    from transmission_renderer_tpu_torch.scene.textures import linear_to_srgb
    from transmission_renderer_tpu_torch.utils.png import read_png
    from transmission_renderer_tpu_torch.utils.profiling import PASS_NAMES

    dev = torch.device("cuda", 0)
    scene, dl, flags = build_stress_scene().finish_bundle(device=dev)
    cfg = RenderConfig(width=1920, height=1080, opaque_block_cap_frac=0.8125,
                       use_pallas_raster=False)
    lights = pack_lights([
        point_light([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0),
        point_light([8.0, 0.8, 0.0], [0.0, 1.0, 0.0], 10.0),
    ], device=dev)
    params = make_params(cfg, bench_rig(0), dev)  # render_stress_hd_golden's camera
    require(flags.has_alpha_clip, "the stress scene has alpha clip")

    def frame(**kw):
        return render_frame(scene, dl, params, lights, cfg, flags=flags, **kw)

    h = raster_vis.KERNEL
    handles = port_handles()
    # (a) kernel 6's alpha form on the frame's two calls, bit for bit
    calls = capture((h,), frame)
    require(len(calls[h.name]) == 2 and all("alpha" in kw for _, kw in calls[h.name]),
            f"vis clip: {len(calls[h.name])} kernel-6 calls, expected 2 with alpha")
    check_parity((h,), calls, max_err, "vis clip ")
    taps = [alpha_taps(c) for c in calls[h.name]]
    log(f"vis clip alpha taps per call: fragments tested {[t[0] for t in taps]}, tapped in "
        f"the atlas {[t[1] for t in taps]}, bytes of their texels and rows "
        f"{[t[2] for t in taps]}")

    # (b) + (c) one frame with the counts reset
    (img, diag), launches = count_launches(handles, frame, return_diagnostics=True)
    log(f"vis clip launches per frame: {launches}")
    expect = dict.fromkeys(launches, 0) | {"raster_vis": 2}
    require(launches == expect, f"vis clip launch counts {launches}, expected {expect}")
    require(tuple(img.shape) == (1080, 1920, 3), f"vis clip image shape {tuple(img.shape)}")
    require(bool(torch.isfinite(img).all()), "vis clip image has non-finite values")
    lo, hi = float(img.min()), float(img.max())
    require(0.0 <= lo and hi <= 1.0, f"vis clip image outside [0, 1]: [{lo}, {hi}]")
    got_diag = diagnostics_dict(diag)
    log(f"vis clip diagnostics: {got_diag}, overflowed {diag.overflowed()}")
    require(not diag.overflowed(), f"vis clip capacity overflow: {diag}")
    bad = {f: (v, STRESS_VIS_DIAGNOSTICS[f]) for f, v in got_diag.items()
           if v != STRESS_VIS_DIAGNOSTICS[f]}
    require(not bad, f"vis clip diagnostics differ from the reference's (got, expected): {bad}")

    # (d) the golden, whole frame: the reference's own render of this branch
    golden = read_png(os.path.join(ROOT, "tests", "goldens", "stress_hd.png"))[..., :3] / 255.0
    rmse = float(np.sqrt(np.mean((linear_to_srgb(img.cpu().numpy()) - golden) ** 2)))
    log(f"vis clip golden stress_hd.png: sRGB RMSE {rmse:.6f} over the whole frame "
        f"(limit 4e-3) on [{card}]")
    require(rmse < 4e-3, f"vis clip sRGB RMSE {rmse} vs golden")

    # (e) timing, passes, kernel 6's alpha form against its bound
    times = timed_frames(frame, 2, 10)
    med = statistics.median(times)
    log(f"vis clip frame 1920x1080 on [{card}]: median {med:.3f} ms/frame "
        f"({1000.0 / med:.2f} fps), min {min(times):.3f}, max {max(times):.3f}")
    profile_passes(frame, card, PASS_NAMES)
    k_ms, h_ms = kernel_ms(h, calls[h.name])
    p_ms = plain_ms(h, calls[h.name])
    per_call = [(raster_vis.covered_pairs(*a, pass_class=kw.get("pass_class")),
                 int((h.replay((a, kw), True)[0] >= 0).sum()), t)
                for (a, kw), t in zip(calls[h.name], taps)]
    works = [kernel_work(h.name, c, pc) for c, pc in zip(calls[h.name], per_call)]
    b_ms, b_by = bound_of(works)
    log(f"vis clip kernel raster_vis (alpha form) on [{card}]: {k_ms:.3f} ms/frame on the "
        f"device (host {h_ms:.3f}), plain {p_ms:.3f} ms/frame, bound {b_ms:.4f} ms by {b_by} "
        f"({sum(w[0] for w in works)} bytes, {sum(w[1] for w in works)} operations), "
        f"{b_ms / k_ms:.4f} of the bound reached, {len(calls[h.name])} calls per frame; "
        f"covering pairs {[c[0] for c in per_call]}, pixels with a winner "
        f"{[c[1] for c in per_call]}, fragments tapped {[t[1] for t in taps]}")

    # (f) the debug-checks frame: silent, and the frame bit for bit
    out = io.StringIO()
    render_checked = checked_frame_fn(config=cfg, flags=flags, out=out)
    checked, launches_f = count_launches(
        handles, lambda: render_checked(scene, dl, params, lights))
    require(out.getvalue() == "", f"checked frame reported: {out.getvalue()!r}")
    require(torch.equal(checked, img), "the checked frame differs from the frame")
    require(launches_f == expect, f"checked frame launches {launches_f}")
    log(f"vis clip checked frame: silent, bit-equal to the frame, launches {launches_f}")

    # (g) injected faults at covered sites: the clip materials' diffuse
    # texture past the atlas (kernel 6's error word and the material
    # matrix's counter), and a run start past the records (kernel 6's
    # error word); the process and its context go on
    m = scene.materials
    n_images = int(scene.atlas_meta.shape[0])
    bad_scene = scene._replace(materials=m._replace(tex_diffuse=torch.where(
        m.tex_diffuse >= 0, torch.full_like(m.tex_diffuse, n_images), m.tex_diffuse)))
    out = io.StringIO()
    bad = checked_frame_fn(config=cfg, flags=flags, out=out)(bad_scene, dl, params, lights)
    torch.cuda.synchronize()
    lines = out.getvalue().splitlines()
    log(f"vis clip checked frame, diffuse texture past the atlas: {lines}")
    require(any(raster_vis.CHECK_SITES[5] in ln and "out-of-bounds" in ln for ln in lines),
            "kernel 6's checked form did not report the atlas image")
    require(bool(torch.isfinite(bad).all()), "the faulty checked frame is not finite")
    args, kw = calls[h.name][0]
    run_start = args[2].clone()
    run_start[int(torch.argmax(args[3]))] = args[0][0].shape[0] + 5
    with checks.collect() as found:
        h.replay((args[:2] + (run_start,) + args[3:], kw), True)
    torch.cuda.synchronize()
    log(f"vis clip checked kernel 6, run start past the records: {found}")
    require((raster_vis.CHECK_SITES[0], None) in found, "the bad run start was not reported")
    again = render_frame(scene, dl, params, lights, cfg, flags=flags)
    require(torch.equal(again, img), "the frame after the faults differs")
    log("vis clip: after the faults the process goes on and renders the same frame")
    return {"frame": "stress_vis", "launches": launches["raster_vis"],
            "max_abs_err": max_err["raster_vis"], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "fragments_tested": [t[0] for t in taps], "fragments_tapped": [t[1] for t in taps],
            "frame_ms": med}


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
            return render_frame(scene, dl, p, lights, c, flags=flags, **kw)

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
            small, s_diag = render_frame(s_scene, s_dl, s_params, s_lights, s_cfg, flags=s_flags,
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


# tests/assets/multi.glb through the CLI at its defaults: its glass quad
# covers this many 8x128 tiles, more than the sparse transmissive raster's
# default cap (0.25 of 2025 tiles: 507), so --check-nan reports it. The
# count is the reference's own binning's
# (tests/test_torch_cli.py::test_multi_glb_transmission_tiles_are_the_references).
MULTI_GLB_TRANSMISSION_TILES = 592
# the glTF JPEG fixture: multi.glb's scene with its three images as JPEGs
# (baseline 4:2:0 with restart markers, progressive 4:2:2, greyscale; 512,
# 256 and 512 texels a side, multi.glb's relation, so the same meta blocks
# and launches), and the SHA-256 and shape of PIL's convert("RGBA") of each
# (tests/test_torch_jpeg.py writes both)
JPEG_GLB = os.path.join("tests", "assets", "jpeg.glb")
JPEG_DIGESTS = os.path.join("tests", "assets", "jpeg_digests.json")


def glb_parts(glb: bytes) -> tuple:
    """A GLB's (JSON document, binary chunk)."""
    (jlen,) = struct.unpack("<I", glb[12:16])
    (blen,) = struct.unpack("<I", glb[20 + jlen : 24 + jlen])
    return json.loads(glb[20 : 20 + jlen]), glb[28 + jlen : 28 + jlen + blen]


def glb_images(glb: bytes) -> list:
    """The bytes of each image of a GLB whose images live in its binary
    chunk."""
    doc, blob = glb_parts(glb)
    views = [doc["bufferViews"][img["bufferView"]] for img in doc["images"]]
    return [blob[v.get("byteOffset", 0) : v.get("byteOffset", 0) + v["byteLength"]]
            for v in views]


def glb_with_images(glb: bytes, images: list) -> bytes:
    """``glb`` with its images replaced, in order, by ``images`` ((bytes,
    MIME type) each), each appended 4-byte aligned to the binary chunk and
    its bufferView pointed at it."""
    doc, blob = glb_parts(glb)
    blob = bytearray(blob)
    for img, (data, mime) in zip(doc["images"], images):
        doc["bufferViews"][img["bufferView"]].update(byteOffset=len(blob),
                                                     byteLength=len(data))
        img["mimeType"] = mime
        blob += data + bytes(-len(data) % 4)
    doc["buffers"][0]["byteLength"] = len(blob)
    text = json.dumps(doc, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 4)
    return (struct.pack("<III", 0x46546C67, 2, 28 + len(text) + len(blob))
            + struct.pack("<II", len(text), 0x4E4F534A) + text
            + struct.pack("<II", len(blob), 0x004E4942) + bytes(blob))


def check_multi_glb_run(tag: str, frames: list, calls: dict, err: str, max_err: dict) -> None:
    """multi.glb's geometry through the CLI with --check-nan at its
    defaults: no non-finite pixel; the one capacity line is the sparse
    transmissive raster's, whose tile count is the reference's own
    (MULTI_GLB_TRANSMISSION_TILES), and nothing else overflows; kernel 1
    bit for bit against its plain version on the frame's calls."""
    from transmission_renderer_tpu_torch.ops import raster_gbuf
    from transmission_renderer_tpu_torch.render.frame import FrameDiagnostics

    lines = [ln for ln in err.splitlines() if "VALIDATION" in ln]
    require(bool(np.isfinite(frames[0]).all()) and "non-finite" not in err,
            f"{tag}: image is not finite")
    tiles = f"transmission_tiles=tensor({MULTI_GLB_TRANSMISSION_TILES}"
    require(len(lines) == 1 and "capacity overflow" in lines[0] and tiles in lines[0]
            and "transmission_tile_capacity=507" in lines[0], f"{tag}: {lines}")
    fields = dict(re.findall(r"(\w+)=(?:tensor\()?(\d+)", lines[0]))
    diag = FrameDiagnostics(**{f: int(fields[f]) for f in FrameDiagnostics._fields
                               if f in fields and not f.startswith("clip_round")})
    require(not diag._replace(transmission_tiles=0).overflowed(),
            f"{tag}: another capacity overflowed: {lines[0]}")
    log(f"{tag} --check-nan: {int(diag.transmission_tiles)} transmission "
        f"tiles against a cap of {diag.transmission_tile_capacity} (the reference's "
        f"binning gives {MULTI_GLB_TRANSMISSION_TILES}), no other overflow, no "
        f"non-finite pixel")
    check_parity((raster_gbuf.KERNEL,), {"raster_gbuf": calls["raster_gbuf"]}, max_err,
                 f"{tag} ")


def cli_run(handles, argv: list) -> tuple:
    """(exit code, linear frames, {kernel: recorded calls}, {kernel:
    launches}, stderr text) of one in-process run of the port's CLI, with
    every count set to 0 just before it and read just after."""
    import contextlib
    import io

    import torch
    from transmission_renderer_tpu_torch import cli

    for h in handles:
        h.launches = 0
        h.recorder = []
    frames, err = [], io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv, frames_out=frames)
        torch.cuda.synchronize()
    finally:
        calls = {h.name: h.recorder for h in handles}
        for h in handles:
            h.recorder = None
    launches = {h.name: h.launches for h in handles}
    log(f"cli {' '.join(argv)}: exit {rc}, launches {launches}; stderr: "
        f"{err.getvalue().strip()!r}")
    require(rc == 0, f"cli exited {rc}: {err.getvalue()}")
    return frames, calls, launches, err.getvalue()


def check_closest(card: str, tag: str, call, max_err: dict) -> tuple:
    """The closest-hit kernel on one recorded call against its plain walk
    (run once, with its counts): hit and tri id equal on every ray, and t,
    u, v bit-equal (both follow the same f32 rounding: the kernel is built
    with --fmad=false), folded into max_err. -> (plain ms, (inner pops,
    tests by stage, (textured, untextured) alpha tests), rays, hits)."""
    import torch
    from transmission_renderer_tpu_torch.ops import bvh, bvh_closest

    (tree, table, rays, t_min, alpha), _ = call
    got = bvh_closest.KERNEL.replay(call, True)
    textured = []

    def alpha_test(tri_id, u, v):
        # counts the candidates whose material has a diffuse texture (the
        # kernel taps the atlas only for those); kept on the card, so the
        # walk's timing takes no extra sync
        tid = alpha.tex_diffuse[alpha.tri_material[tri_id.long()].long()]
        textured.append((tid >= 0).sum())
        return alpha.test(tri_id, u, v)

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    walk = bvh.closest_walk(tree, table, rays, t_min, alpha_test)
    end.record()
    torch.cuda.synchronize()
    p_ms = start.elapsed_time(end)
    hit, t, tri, u, v, inner, leaf, tests, alphas = walk
    n_tex = int(sum(textured)) if textured else 0
    require(torch.equal(got[0], hit), f"{tag}bvh_closest: hit differs on "
            f"{int((got[0] != hit).sum())} rays")
    require(torch.equal(got[2], tri), f"{tag}bvh_closest: tri id differs on "
            f"{int((got[2] != tri).sum())} rays")
    errs = [float((a - b).abs().max()) for a, b in zip((got[1], got[3], got[4]), (t, u, v))]
    require(max(errs) == 0.0, f"{tag}bvh_closest: t, u, v differ from the plain walk's by "
            f"{errs} (tolerance 0: bit-equal)")
    max_err["bvh_closest"] = max(max_err.get("bvh_closest", 0.0), *errs)
    n, live = rays.shape[1], int((rays[9] > t_min).sum())
    log(f"parity {tag}bvh_closest: {n} rays, {int(hit.sum())} hits; hit and tri id equal "
        f"on every ray; max abs error t {errs[0]:.3e}, u {errs[1]:.3e}, v {errs[2]:.3e} (tolerance 0); "
        f"plain walk {p_ms:.3f} ms on [{card}]: {int(inner.sum())} inner pops, "
        f"{int(leaf.sum())} leaf pops ({int(inner.sum() + leaf.sum()) / max(live, 1):.2f} "
        f"pops per live ray), triangle tests by exit stage "
        f"{tests.sum(dim=0).tolist()}, {int(alphas.sum())} alpha tests ({n_tex} textured)")
    alpha_tests = (n_tex, int(alphas.sum()) - n_tex)
    return p_ms, (int(inner.sum()), tests.sum(dim=0).tolist(), alpha_tests), n, hit


def cli_phase(card: str, max_err: dict, flagship_img, vis_img=None) -> dict:
    """Phase 11, the port's CLI at 1920x1080 in-process (cli.main): the
    flagship frame, the AS-debug view on the dragon and on the stress
    scene (the closest-hit kernel against its plain walk), the cluster
    views, multi.glb with --check-nan, the spotlights with the rotating
    model over 3 frames, and the flagship with --debug-checks (equal to
    ``vis_img``, phase 8's frame, when given). -> (the closest-hit
    kernel's row, the launches of multi.glb's run (e))."""
    import tempfile

    import torch
    from transmission_renderer_tpu_torch.config import RenderConfig
    from transmission_renderer_tpu_torch.ops import bvh_closest
    from transmission_renderer_tpu_torch.utils.png import read_png

    handles = port_handles()
    names = [h.name for h in handles]
    with tempfile.TemporaryDirectory() as tmp:
        def out(name):
            return ["-o", os.path.join(tmp, name)]

        # (a) the flagship through the CLI: phase 5's frame exactly
        frames, _, launches, _ = cli_run(
            handles, ["--procedural", "dragon", "--roughness-override", "0.25"]
            + out("dragon.png"))
        got = torch.from_numpy(frames[0])
        err = float((got - flagship_img.cpu()).abs().max())
        log(f"cli (a) flagship: max abs error {err:.3e} against phase 5's render_frame "
            f"frame; launches {launches}")
        require(err == 0.0, f"cli flagship frame differs from render_frame's by {err}")
        golden = read_png(os.path.join(ROOT, "tests", "goldens", "dragon_hd.png"))
        golden = golden[..., :3] / 255.0
        png = read_png(os.path.join(tmp, "dragon.png"))[..., :3] / 255.0
        keep = golden_keep_mask(RenderConfig(width=1920, height=1080))
        rmse = float(np.sqrt(np.mean((png[keep] - golden[keep]) ** 2)))
        log(f"cli (a) dragon.png vs dragon_hd.png: sRGB RMSE {rmse:.6f} outside "
            f"GOLDEN_DROPPED_TILES (limit 4e-3) on [{card}]")
        require(rmse < 4e-3, f"cli flagship PNG RMSE {rmse}")

        # (b) the AS-debug view of the dragon: the closest-hit kernel's
        # main-path run, then its parity, timing and bound
        frames, calls, launches_b, _ = cli_run(
            handles, ["--procedural", "dragon", "--as-debug"] + out("as_debug.png"))
        require(launches_b == dict.fromkeys(names, 0) | {"bvh_closest": 1},
                f"as-debug launches {launches_b}")
        require(bool(np.isfinite(frames[0]).all()), "as-debug image has non-finite values")
        call = calls["bvh_closest"][0]
        p_ms, work, n_rays, _ = check_closest(card, "cli (b) dragon ", call, max_err)
        k_ms, h_ms = kernel_ms(bvh_closest.KERNEL, [call])
        b_ms, b_by = bound_of([kernel_work("bvh_closest", call, work)])
        nb, ops = kernel_work("bvh_closest", call, work)
        log(f"cli (b) kernel bvh_closest on [{card}]: {k_ms:.3f} ms/frame on the device "
            f"(host {h_ms:.3f}), plain {p_ms:.3f} ms/frame, bound {b_ms:.4f} ms by {b_by} "
            f"({nb} bytes, {ops} operations), {b_ms / k_ms:.4f} of the bound reached, "
            f"{n_rays} rays")
        row = {"name": "bvh_closest", "route": "cuda", "source": bvh_closest.KERNEL.source,
               "replaces": bvh_closest.KERNEL.replaces,
               "launches": launches_b["bvh_closest"], "max_abs_err": None, "ms": k_ms,
               "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
               "frame": "as_debug"}

        # (c) the AS-debug view of the stress scene: the alpha test on the
        # leaf cards. The kernel with every cutoff at -inf gives each ray's
        # geometrically closest candidate; where that differs, an alpha
        # test rejected it
        frames, calls, launches_c, _ = cli_run(
            handles, ["--procedural", "stress", "--as-debug"] + out("stress_as_debug.png"))
        require(launches_c["bvh_closest"] == 1, f"stress as-debug launches {launches_c}")
        require(bool(np.isfinite(frames[0]).all()), "stress as-debug image is not finite")
        call = calls["bvh_closest"][0]
        _, work_c, _, hit_c = check_closest(card, "cli (c) stress ", call, max_err)
        (tree, table, rays, t_min, alpha), kw = call
        no_clip = alpha._replace(cutoff=torch.full_like(alpha.cutoff, -torch.inf))
        geo = bvh_closest.KERNEL.replay(((tree, table, rays, t_min, no_clip), kw), True)
        got = bvh_closest.KERNEL.replay(call, True)
        rejected = int((geo[0] & (geo[2] != got[2])).sum())
        k_ms_c, _ = kernel_ms(bvh_closest.KERNEL, [call])
        log(f"cli (c) stress: {rejected} rays whose closest candidate an alpha test "
            f"rejected; {sum(work_c[2])} alpha tests ({work_c[2][0]} textured); kernel "
            f"{k_ms_c:.3f} ms/frame on [{card}]")
        require(rejected > 0, "stress as-debug: no candidate was rejected by its alpha test")

        # (d) the cluster views: the reference's gate sends both passes to
        # the tensor shade, so kernels 2-4 never launch
        frames, _, launches_d, _ = cli_run(
            handles, ["--procedural", "dragon", "--debug-clusters", "--cluster-wireframe",
                      "5"] + out("clusters.png"))
        expect = dict.fromkeys(names, 0) | {"raster_gbuf": 2}
        log(f"cli (d) routing: launches {launches_d} (the gate refuses debug_clusters: "
            f"both passes on the tensor shade)")
        require(launches_d == expect, f"debug-clusters launches {launches_d}, expected {expect}")
        img = frames[0]
        require(bool(np.isfinite(img).all()) and img.min() >= 0.0 and img.max() <= 1.0,
                "cluster view outside [0, 1] or not finite")

        # (e) the GLB fixture (binary-chunk PNGs, no PIL) with --check-nan
        glb = os.path.join(ROOT, "tests", "assets", "multi.glb")
        frames, calls, launches_e, err = cli_run(
            handles, [glb, "--external-model", "--no-sponza", "--check-nan"]
            + out("multi.png"))
        check_multi_glb_run("cli (e) multi.glb", frames, calls, err, max_err)

        # (f) the spotlights and the rotating model over 3 frames
        frames, _, _, _ = cli_run(
            handles, ["--procedural", "dragon", "--spotlights", "--rotate-model",
                      "--frames", "3"] + out("spots.png"))
        pngs = sorted(f for f in os.listdir(tmp) if f.startswith("spots_"))
        require(pngs == ["spots_000.png", "spots_001.png", "spots_002.png"], f"{pngs}")
        require(len(frames) == 3 and all(np.isfinite(f).all() for f in frames),
                "spotlight frames not finite")
        diffs = [float(np.abs(frames[k] - frames[0]).max()) for k in (1, 2)]
        log(f"cli (f) spotlights + rotate-model: frames 1 and 2 differ from frame 0 by "
            f"{diffs} (max abs)")
        require(min(diffs) > 0.0, "the spotlight / rotation frames did not change")

        # (g) the flagship with --debug-checks: the visibility-buffer
        # branch, kernel 6's checked form, no report
        frames, _, launches_g, err = cli_run(
            handles, ["--procedural", "dragon", "--roughness-override", "0.25",
                      "--debug-checks"] + out("checked.png"))
        require("out-of-bounds" not in err and "CHECKS" not in err,
                f"--debug-checks reported on the flagship: {err!r}")
        require(launches_g == dict.fromkeys(names, 0) | {"raster_vis": 2},
                f"--debug-checks launches {launches_g}")
        same = vis_img is None or bool(np.array_equal(frames[0], vis_img.cpu().numpy()))
        log(f"cli (g) --debug-checks flagship: exit 0, no report, launches {launches_g}, "
            f"equal to phase 8's frame: {same}")
        require(same, "--debug-checks frame differs from phase 8's visibility-buffer frame")
    return row, launches_e


def jpeg_phase(card: str, max_err: dict, multi_launches: dict) -> None:
    """Phase 14, glTF JPEG images, decoded without PIL:
    (a) decode_jpeg gives each image of JPEG_GLB PIL's RGBA, by the
    committed SHA-256 and shape; (b) JPEG_GLB through the CLI at its
    defaults with --check-nan, as multi.glb in phase 11(e): the same
    capacity line, kernel 1 bit for bit, the launches equal to
    ``multi_launches``; (c) that frame bit-equal to its PNG twin's (the
    same GLB with each image a PNG of its decoded RGBA, written here by
    the port's PNG writer); (d) each image's decode time (host time)."""
    import hashlib
    import tempfile

    from transmission_renderer_tpu_torch.utils.jpeg import decode_jpeg
    from transmission_renderer_tpu_torch.utils.png import write_png

    with open(os.path.join(ROOT, JPEG_GLB), "rb") as f:
        glb = f.read()
    with open(os.path.join(ROOT, JPEG_DIGESTS)) as f:
        digests = json.load(f)
    images, decoded = glb_images(glb), []
    for k, (data, want) in enumerate(zip(images, digests)):
        t0 = time.perf_counter()
        rgba = decode_jpeg(data, f"image {k}")
        sec = time.perf_counter() - t0
        got = hashlib.sha256(rgba.tobytes()).hexdigest()
        log(f"jpeg (a) image {k} ({want['form']}): shape {list(rgba.shape)}, sha256 "
            f"{got[:16]}..., PIL's {want['sha256'][:16]}...: "
            f"{'equal' if got == want['sha256'] else 'DIFFERENT'}")
        require(list(rgba.shape) == want["shape"] and got == want["sha256"],
                f"jpeg image {k}: decode_jpeg differs from PIL's RGBA")
        mp = rgba.shape[0] * rgba.shape[1] / 1e6
        log(f"jpeg (d) image {k} ({want['form']}, {len(data)} bytes): decoded in "
            f"{sec * 1e3:.1f} ms, {sec / mp:.3f} s per megapixel (host time, on the host of "
            f"[{card}])")
        decoded.append(rgba)

    handles = port_handles()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(ROOT, JPEG_GLB)
        frames, calls, launches, err = cli_run(
            handles, [path, "--external-model", "--no-sponza", "--check-nan",
                      "-o", os.path.join(tmp, "jpeg.png")])
        check_multi_glb_run("jpeg (b) jpeg.glb", frames, calls, err, max_err)
        log(f"jpeg (b) launches {launches}; multi.glb's (phase 11(e)) {multi_launches}")
        require(launches == multi_launches, "jpeg.glb's launches differ from multi.glb's")

        pngs = []
        for k, rgba in enumerate(decoded):
            name = os.path.join(tmp, f"twin_{k}.png")
            write_png(name, rgba[..., :3])  # every JPEG decodes opaque
            with open(name, "rb") as f:
                pngs.append((f.read(), "image/png"))
        twin = os.path.join(tmp, "png_twin.glb")
        with open(twin, "wb") as f:
            f.write(glb_with_images(glb, pngs))
        twin_frames, _, twin_launches, _ = cli_run(
            handles, [twin, "--external-model", "--no-sponza", "-o",
                      os.path.join(tmp, "twin.png")])
        same = bool(np.array_equal(frames[0], twin_frames[0]))
        log(f"jpeg (c) the {frames[0].shape[1]}x{frames[0].shape[0]} frame equals its PNG "
            f"twin's bit for bit: {same}; the twin's launches {twin_launches}")
        require(same, "jpeg.glb's frame differs from its PNG twin's")
        require(twin_launches == launches, "the PNG twin's launches differ from jpeg.glb's")


# Phase 12's quality flags, each with the reference's own pinned bound on
# the frame against the exact one (RMSE): tests/test_e2e.py:93-103
# (half-res, linear), tests/test_quad_taps.py:36-50 (quad taps, linear),
# tests/test_goldens.py:62-77 (bf16, sRGB).
FLAG_BOUNDS = {"half_res_refraction": (0.02, "linear"), "quad_material_taps": (0.1, "linear"),
               "bf16_light_math": (1e-2, "sRGB")}
FLAG_ARGS = {"half_res_refraction": "--half-res-refraction",
             "quad_material_taps": "--quad-taps", "bf16_light_math": "--bf16-lights"}


def roughness_image(size: int = 64, seed: int = 5) -> np.ndarray:
    """The glass's metallic-roughness texture of the textured-roughness
    frame (tests/variants_defs.py builds the same): roughness (G) a wave
    over [0.05, 0.95] with noise, metallic (B) 0."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    g = np.clip(0.5 + 0.45 * np.sin(6.0 * x + 3.0 * y)
                + 0.05 * rng.standard_normal((size, size)), 0.0, 1.0)
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 1] = np.round(g * 255.0).astype(np.uint8)
    img[..., 3] = 255
    return img


def textured_glass_dragon():
    """The flagship scene (build_dragon_scene at default detail) with a
    metallic-roughness texture on its glass, through the port's
    SceneBuilder: the transmissive roughness is per pixel, so the frame
    has no static pyramid level set."""
    from transmission_renderer_tpu_torch.config import BUCKET_OPAQUE, BUCKET_TRANSMISSION
    from transmission_renderer_tpu_torch.models import procedural as proc
    from transmission_renderer_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    checker = b.add_texture(proc.checkerboard_texture(512, 12, 230, 40), srgb=True)
    floor_mat = b.add_material(tex_diffuse=checker, roughness_factor=0.7)
    wall_mat = b.add_material(diffuse_factor=(0.35, 0.5, 0.7, 1.0), roughness_factor=0.9)
    glass = b.add_material(
        diffuse_factor=(1.0, 1.0, 1.0, 1.0), roughness_factor=1.0, metallic_factor=0.0,
        transmission_factor=1.0, thickness_factor=0.6, attenuation_distance=1.0,
        attenuation_colour=(0.9, 0.4, 0.25), index_of_refraction=1.5,
        tex_metallic_roughness=b.add_texture(roughness_image(), srgb=False))
    p_floor = b.add_primitive(*proc.make_plane_mesh(10.0), bucket=BUCKET_OPAQUE)
    p_wall = b.add_primitive(*proc.make_box_mesh((6.0, 4.0, 0.2)), bucket=BUCKET_OPAQUE)
    p_glass = b.add_primitive(*proc._displaced_sphere(180, 360, amp=0.25),
                              bucket=BUCKET_TRANSMISSION)
    p_prop = b.add_primitive(*proc.make_sphere_mesh(24, 48), bucket=BUCKET_OPAQUE)
    b.add_instance(p_floor, floor_mat)
    b.add_instance(p_wall, wall_mat, translation=(0.0, 3.0, -7.0))
    b.add_instance(p_glass, glass, translation=(0.0, 1.6, -3.5), scale=1.2)
    for x, z, colour in ((-2.4, -4.6, (0.9, 0.2, 0.1, 1.0)), (2.4, -4.8, (0.1, 0.7, 0.2, 1.0))):
        b.add_instance(p_prop, b.add_material(diffuse_factor=colour, roughness_factor=0.5),
                       translation=(x, 0.8, z), scale=0.8)
    return b


def ray_orders(frame) -> tuple:
    """(frame's result, the ray order (packet_swizzle; None: the
    compacted worklist's own) of each shadow_factors call it made)."""
    from transmission_renderer_tpu_torch.render import frame as pframe

    real, orders = pframe.shadow_factors, []

    def recorded(*args, **kwargs):
        orders.append(kwargs.get("packet_swizzle"))
        return real(*args, **kwargs)

    pframe.shadow_factors = recorded
    try:
        out = frame()
    finally:
        pframe.shadow_factors = real
    return out, tuple(orders)


def image_ok(tag: str, img, shape: tuple) -> None:
    import torch

    require(tuple(img.shape) == shape, f"{tag}: image shape {tuple(img.shape)}")
    require(bool(torch.isfinite(img).all()), f"{tag}: image has non-finite values")
    lo, hi = float(img.min()), float(img.max())
    require(0.0 <= lo and hi <= 1.0, f"{tag}: image outside [0, 1]: [{lo}, {hi}]")


def variants_phase(card: str, max_err: dict, base: dict) -> dict:
    """Phase 12, the frame variants ported last: the quality flags, the
    textured-roughness frame (kernel 4's full form), the dense transmission
    raster and shade with ray-traced shadows, 1600x900, ray-traced shadows
    with alpha clip and on the visibility-buffer branch, and the CLI's
    flags. Per frame: every kernel call against its plain version (a call
    on the same inputs as an earlier frame's is held there), the launches,
    the image, the median ms/frame over 5 after 2 beside the flagship's
    from the same phase. -> kernel 4's full form's figures."""
    import dataclasses
    import tempfile

    import torch
    from transmission_renderer_tpu_torch.config import RenderConfig
    from transmission_renderer_tpu_torch.models.procedural import build_stress_scene
    from transmission_renderer_tpu_torch.ops import bvh_packet, raster_vis, tap_finish
    from transmission_renderer_tpu_torch.ops.cull import transform_vertices
    from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
    from transmission_renderer_tpu_torch.render.frame import render_frame
    from transmission_renderer_tpu_torch.scene.textures import linear_to_srgb

    dev = torch.device("cuda", 0)
    scene, dl, flags, params, lights, bvh = (base[k] for k in (
        "scene", "dl", "flags", "params", "lights", "bvh"))
    cfg = RenderConfig(width=1920, height=1080)
    handles = port_handles()[:5]
    names = [h.name for h in handles]
    hd = (1080, 1920, 3)

    def launches_of(**want):
        return {n: want.get(n, 0) for n in names}

    flag_ms = statistics.median(timed_frames(lambda: render_frame(
        scene, dl, params, lights, cfg, flags=flags), 2, 5))
    log(f"variants: the flagship 1920x1080 on [{card}]: median {flag_ms:.3f} ms/frame "
        f"(5 after 2, this phase)")

    def run(tag, frame, expect, shape=hd, occl=None):
        """Parity on every call, the launches, the image, the timing ->
        (image, hdr, diagnostics, calls, launches)."""
        calls, orders = ray_orders(lambda: capture(handles, frame))
        if occl is not None:
            n_kinds, tri_vertices, positions, want = occl
            require(orders == want, f"{tag}: shadow rays traced in the orders {orders}, "
                    f"expected {want}")
            require(len(calls["bvh_occlusion"]) == 2, f"{tag}: two occlusion calls")
            check_occlusion(calls["bvh_occlusion"], n_kinds, f"{tag} ", tri_vertices,
                            positions)
            log(f"{tag}: kernel 5 exact on the frame's ray orders "
                f"{tuple(o or 'worklist' for o in orders)}")
            max_err.setdefault("bvh_occlusion", 0.0)
        check_parity([h for h in handles if calls[h.name] and h.name != "bvh_occlusion"],
                     calls, max_err, f"{tag} ")
        (img, hdr, diag), got = count_launches(handles, frame, return_hdr=True,
                                               return_diagnostics=True)
        log(f"{tag} launches per frame: {got}")
        require(got == expect, f"{tag}: launch counts {got}, expected {expect}")
        image_ok(tag, img, shape)
        times = timed_frames(frame, 2, 5)
        med = statistics.median(times)
        log(f"{tag} frame {shape[1]}x{shape[0]} on [{card}]: median {med:.3f} ms/frame "
            f"({1000.0 / med:.2f} fps; the flagship {flag_ms:.3f}), min {min(times):.3f}, "
            f"max {max(times):.3f}; diagnostics {diagnostics_dict(diag)}")
        return img, hdr, diag, calls, got

    exact_img = base["img"]
    flag_imgs = {}
    # (a) the flagship with each quality flag: the reference's gate sends
    # quad taps and bf16 to the tensor shade (both passes), half-res to the
    # dense tensor transmission shade (the opaque pass stays on kernels 2-3)
    for flag, (bound, space) in FLAG_BOUNDS.items():
        cfg_f = dataclasses.replace(cfg, **{flag: True})
        half = flag == "half_res_refraction"
        expect = launches_of(raster_gbuf=2, tap_finish=int(half), shade=int(half))
        img_f, _, diag, _, _ = run(f"variants (a) {flag}", lambda c=cfg_f, **kw: render_frame(
            scene, dl, params, lights, c, flags=flags, **kw), expect)
        require(not diag.overflowed(), f"{flag}: capacity overflow {diag}")
        a, b = img_f.cpu().numpy(), exact_img.cpu().numpy()
        if space == "sRGB":
            a, b = linear_to_srgb(a), linear_to_srgb(b)
        err = float(np.sqrt(np.mean((a - b) ** 2)))
        log(f"variants (a) {flag}: {space} RMSE {err:.6f} against the exact flagship frame "
            f"(the reference's bound {bound})")
        require(0.0 < err < bound, f"{flag}: RMSE {err} against the exact frame")
        flag_imgs[flag] = img_f

    # (b) per-pixel (textured) glass roughness: no level set, kernel 4's
    # full form on the fused sparse path; the same frame through the
    # tensor shade (pallas_shade False, the reference's XLA formulation)
    builder_t = textured_glass_dragon()
    scene_t, dl_t, flags_t = builder_t.finish_bundle(device=dev)
    require(flags_t.transmission_ior_roughness is None, "textured glass: a static level set")
    img_t, _, diag, calls_t, got_t = run(
        "variants (b) textured roughness", lambda **kw: render_frame(
            scene_t, dl_t, params, lights, cfg, flags=flags_t, **kw),
        launches_of(**expected_launches(scene_t, flags_t)))
    require(not diag.overflowed(), f"textured roughness: capacity overflow {diag}")
    (fetch,) = calls_t["transmission_fetch"]
    require(fetch[0][1] == tuple(range(fetch[0][0].num_levels)),
            f"textured roughness: kernel 4 ran over the level set {fetch[0][1]}")
    lod = fetch[0][4]
    lvl = torch.floor(torch.clamp(lod, 0.0, 10.0))[lod > 0]
    log(f"variants (b): kernel 4's full form over {fetch[0][2].shape[0]} pixels, levels "
        f"{sorted(set(int(v) for v in torch.unique(lvl).tolist()))} bracketed")
    tensor_t = render_frame(scene_t, dl_t, params, lights,
                            dataclasses.replace(cfg, pallas_shade=False), flags=flags_t)
    err = float(((img_t - tensor_t) ** 2).mean().sqrt())
    log(f"variants (b): linear RMSE {err:.3e} (max abs {float((img_t - tensor_t).abs().max()):.3e})"
        f" against the same frame through the tensor shade (limit 1e-4)")
    require(err < 1e-4, f"textured roughness: kernel route vs tensor route RMSE {err}")
    h = tap_finish.FETCH_KERNEL
    k_ms, h_ms = kernel_ms(h, calls_t[h.name])
    p_ms = plain_ms(h, calls_t[h.name])
    works = [kernel_work(h.name, c) for c in calls_t[h.name]]
    b_ms, b_by = bound_of(works)
    log(f"variants kernel transmission_fetch (full form) on [{card}]: {k_ms:.4f} ms/frame on "
        f"the device (host {h_ms:.3f}), plain {p_ms:.3f} ms/frame, bound {b_ms:.4f} ms by "
        f"{b_by} ({sum(w[0] for w in works)} bytes, {sum(w[1] for w in works)} operations), "
        f"{b_ms / k_ms:.4f} of the bound reached")
    full_form = {"frame": "textured_roughness", "launches": got_t[h.name], "ms": k_ms, "plain_ms": p_ms,
                 "bound_ms": b_ms, "bound_by": b_by}

    # (c) the dense transmission raster and shade with ray-traced shadows:
    # both passes' rays in 8x16 groups; the same image as phase 7's fused
    # sparse frame (the same pixels, the same rays)
    world_pos = transform_vertices(scene, dl, params.proj_view)[0]
    n_kinds = 1 + lights.num
    cfg_d = dataclasses.replace(cfg, ray_traced_shadows=True, transmission_tile_cap_frac=None,
                                transmission_block_cap_frac=None)
    img_d, _, diag, _, _ = run(
        "variants (c) dense transmission rt", lambda **kw: render_frame(
            scene, dl, params, lights, cfg_d, flags=flags, bvh=bvh, **kw),
        launches_of(raster_gbuf=2, tap_finish=1, shade=2, transmission_fetch=1,
                    bvh_occlusion=2),
        occl=(n_kinds, dl.tri_vtx, world_pos, ("2d", "2d")))
    require(diag.transmission_tile_capacity == 0 and diag.transmission_block_capacity == 0,
            "dense: a capped transmission path")
    err = float((img_d - base["img_rt"]).abs().max())
    log(f"variants (c): max abs error {err:.3e} against phase 7's fused sparse rt frame "
        f"(limit 1e-5)")
    require(err <= 1e-5, f"dense rt frame vs fused rt frame: {err}")

    # (d) 1600x900: kernel 1 over a partial last tile column and row, both
    # shades on the tensor path, the sparse-tile transmissive raster and
    # the compacted shade
    cfg_w = RenderConfig(width=1600, height=900)
    params_w = make_params(cfg_w, flagship_rig(), dev)
    img_w, _, diag, _, _ = run(
        "variants (d) 1600x900", lambda **kw: render_frame(
            scene, dl, params_w, lights, cfg_w, flags=flags, **kw),
        launches_of(raster_gbuf=2), shape=(900, 1600, 3))
    require(not diag.overflowed(), f"1600x900: capacity overflow {diag}")

    # (e) the stress frame at the bench's config with ray-traced shadows:
    # the compacted transmission worklist's rays in its own order
    t0 = time.perf_counter()
    sbuilder = build_stress_scene()
    s_scene, s_dl, s_flags = sbuilder.finish_bundle(device=dev)
    s_bvh = sbuilder.build_rt_bvh(device=dev)
    cfg_s = RenderConfig(width=1920, height=1080, opaque_block_cap_frac=0.8125)
    s_params = make_params(cfg_s, bench_rig(0), dev)
    s_lights = pack_lights([point_light([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0),
                            point_light([8.0, 0.8, 0.0], [0.0, 1.0, 0.0], 10.0)], device=dev)
    log(f"variants (e): stress BVH over {s_bvh.num_tris} triangles built in "
        f"{time.perf_counter() - t0:.2f} s")
    cfg_srt = dataclasses.replace(cfg_s, ray_traced_shadows=True)
    _, s_hdr = render_frame(s_scene, s_dl, s_params, s_lights, cfg_s, flags=s_flags,
                            return_hdr=True)
    _, hdr_s, diag, _, _ = run(
        "variants (e) stress rt", lambda **kw: render_frame(
            s_scene, s_dl, s_params, s_lights, cfg_srt, flags=s_flags, bvh=s_bvh, **kw),
        launches_of(raster_gbuf=10, tap_finish=1, shade=2, transmission_fetch=1,
                    bvh_occlusion=2),
        occl=(n_kinds, s_dl.tri_vtx, transform_vertices(s_scene, s_dl, s_params.proj_view)[0],
              ("2d", None)))
    brighter = float((hdr_s - s_hdr).max())
    log(f"variants (e): HDR at most {brighter:.3e} brighter than the stress frame without "
        f"shadows; {int(((s_hdr - hdr_s).amax(dim=-1) > 0.05).sum())} pixels darker by 0.05")
    require(brighter <= 1e-5 and bool((hdr_s < s_hdr).any()), "stress rt: shadows brightened")

    # (f) the visibility-buffer flagship with ray-traced shadows
    cfg_vrt = RenderConfig(width=1920, height=1080, use_pallas_raster=False,
                           ray_traced_shadows=True)
    vis_handles = handles + (raster_vis.KERNEL,)
    handles, names = vis_handles, [h.name for h in vis_handles]
    _, hdr_v, diag, _, _ = run(
        "variants (f) vis rt", lambda **kw: render_frame(
            scene, dl, params, lights, cfg_vrt, flags=flags, bvh=bvh, **kw),
        launches_of(raster_vis=2, bvh_occlusion=2),
        occl=(n_kinds, dl.tri_vtx, world_pos, ("2d", None)))
    brighter = float((hdr_v - base["hdr_vis"]).max())
    log(f"variants (f): HDR at most {brighter:.3e} brighter than phase 8's frame")
    require(brighter <= 1e-5 and bool((hdr_v < base["hdr_vis"]).any()),
            "vis rt: shadows brightened")

    # (g) the CLI with each flag: (a)'s frames exactly
    handles = port_handles()
    with tempfile.TemporaryDirectory() as tmp:
        for flag, arg in FLAG_ARGS.items():
            frames, _, got, _ = cli_run(handles, ["--procedural", "dragon",
                                                  "--roughness-override", "0.25", arg,
                                                  "-o", os.path.join(tmp, "f.png")])
            err = float((torch.from_numpy(frames[0]) - flag_imgs[flag].cpu()).abs().max())
            log(f"variants (g) cli {arg}: max abs error {err:.3e} against (a)'s frame")
            require(err == 0.0, f"cli {arg}: frame differs from render_frame's")
            half = flag == "half_res_refraction"
            require(got == {n.name: 0 for n in handles} | {
                "raster_gbuf": 2, "tap_finish": int(half), "shade": int(half)},
                f"cli {arg}: launches {got}")
    return full_form


# ---------------------------------------------------------------------------
# phase 15: the row-band sharded frames
# ---------------------------------------------------------------------------

SHARDED_MAX_ABS = 2e-6  # the reference's own bound (tests/sharding_driver.py:108)


def host_frames(frame, warmups: int, reps: int) -> list:
    """Per-frame ms on the host's clock, the card synchronised before and
    after each frame (a band group's frame ends in a gather through the
    host, so CUDA events on one rank's stream would not span it)."""
    import torch

    for _ in range(warmups):
        frame()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def glass_mask(calls) -> np.ndarray:
    """[1080, 1920] bool, the glass: the pixels the transmissive pass's
    kernel-1 call (over every tile) won, from a 1080p frame's calls."""
    from transmission_renderer_tpu_torch.ops import raster_gbuf
    from transmission_renderer_tpu_torch.ops.raster import untile_image

    (call,) = [c for c in calls["raster_gbuf"] if c[1].get("pass_class") == 1]
    tri = raster_gbuf.KERNEL.replay(call, True)["tri"]
    return (untile_image(tri, 15, 135, 128, 8, 1920, 1080) >= 0).cpu().numpy()


def sharded_configs(n: int) -> dict:
    """Phase 15's configs on n bands: the flagship at the default 64-px
    halo and at a halo of the band height (every pyramid level gathered),
    the ray-traced flagship, the stress frame with its peel run to
    convergence (stress_hd.png's frame), and the stress frame on the
    visibility branch (kernel 6's alpha form) with dense shading and a
    halo of the band height."""
    import dataclasses

    from transmission_renderer_tpu_torch.config import RenderConfig
    from transmission_renderer_tpu_torch.parallel.sharded import _band_tile_rows

    cfg = RenderConfig(width=1920, height=1080)
    band_h = _band_tile_rows(cfg, n) * cfg.tile_h
    return {"default": cfg,
            "full_halo": dataclasses.replace(cfg, sharded_refraction_halo_px=band_h),
            "rt": dataclasses.replace(cfg, ray_traced_shadows=True),
            "stress": RenderConfig(width=1920, height=1080, alpha_clip_rounds=8,
                                   clip_retile_cap_frac=1.0),
            "stress_vis": RenderConfig(width=1920, height=1080, use_pallas_raster=False,
                                       transmission_block_cap_frac=None,
                                       sharded_refraction_halo_px=band_h)}


def sharded_frames_on_rank(mesh, out_dir: str):
    """Phase 15(b)-(d) on one rank of a band group sharing the card; every
    rank renders the same frames in the same order. (b) the flagship at
    the default halo (launches counted; every kernel call of the last
    band, whose tiles run into the padded rows, held against its plain
    version), at a halo of the band height, and timed; with 2 bands (c)
    the stress frame, on the G-buffer branch and on the visibility branch
    (the last band's kernel-6 calls, padded rows included, against their
    plain version; the peel's alpha tests, worklists and merges on the
    band's tile ids, check_clip_alpha and check_clip_peel, on every rank),
    and (d) the ray-traced flagship, kernel 5's band
    calls against the plain walk on every band. -> rank 0's frames,
    diagnostics, launches and times; the other ranks write their parity
    errors to out_dir/rank<r>.json and return None."""
    import torch
    from transmission_renderer_tpu_torch.models.procedural import build_stress_scene
    from transmission_renderer_tpu_torch.ops import bvh_packet, raster_vis
    from transmission_renderer_tpu_torch.ops.cull import transform_vertices
    from transmission_renderer_tpu_torch.parallel import render_frame_sharded
    from transmission_renderer_tpu_torch.render import frame as frame_mod

    n, r, dev = mesh.size, mesh.rank, mesh.device
    tag = f"sharded n={n} rank {r} "
    cfgs = sharded_configs(n)
    builder, scene, dl, flags, params, lights = flagship_scene(dev)
    handles = port_handles()
    max_err, out = {}, {}

    def frame(cfg, s=scene, d=dl, f=flags, p=params, **kw):
        return render_frame_sharded(s, d, p, lights, cfg, mesh, flags=f, **kw)

    (ldr, diag), out["launches"] = count_launches(
        handles, lambda: frame(cfgs["default"], return_diagnostics=True))
    out["default"], out["diag"] = ldr.cpu().numpy(), diagnostics_dict(diag)
    calls = capture(handles[:3], lambda: frame(cfgs["default"]))
    tiles = sorted({int(t) for a, _ in calls["raster_gbuf"] for t in a[1].tolist()})
    padded = sum(t >= cfgs["default"].tiles_x * cfgs["default"].tiles_y for t in tiles)
    log(f"{tag}kernel 1 on tiles {tiles[0]}..{tiles[-1]} ({padded} below the frame), "
        f"launches {out['launches']}")
    if r == n - 1:
        require(padded > 0 or n == 1, f"{tag}the last band holds no padded tile row")
        check_parity(handles[:3], calls, max_err, tag)
    out["full_halo"] = frame(cfgs["full_halo"]).cpu().numpy()
    out["times"] = host_frames(lambda: frame(cfgs["default"]), 2, 10)
    if n == 2:
        s_scene, s_dl, s_flags = build_stress_scene().finish_bundle(device=dev)
        s_params = make_params(cfgs["stress"], bench_rig(0), dev)
        clip = frame_mod.CLIP_ALPHA_KERNEL
        peel = (frame_mod.CLIP_WORKLIST_KERNEL, frame_mod.CLIP_MERGE_KERNEL)
        clip.recorder = []
        for h in peel:
            h.recorder = Snapshots()
        try:
            ldr, diag = frame(cfgs["stress"], s_scene, s_dl, s_flags, s_params,
                              return_diagnostics=True)
            torch.cuda.synchronize()
        finally:
            clip_calls, clip.recorder = clip.recorder, None
            wl_calls, mg_calls = (h.recorder for h in peel)
            for h in peel:
                h.recorder = None
        out["stress"], out["stress_diag"] = ldr.cpu().numpy(), diagnostics_dict(diag)
        # the peel's alpha test, worklist and merge on the band's tile
        # ids (t0 = the band's first tile on every rank but rank 0)
        check_clip_alpha(clip_calls, max_err, tag)
        rounds = 2 * (cfgs["stress"].alpha_clip_rounds - 1)
        require(len(wl_calls) == rounds and len(mg_calls) == rounds,
                f"{tag}clip_peel: {len(wl_calls)} worklists and {len(mg_calls)} merges, "
                f"expected {rounds} each")
        check_clip_peel(wl_calls, mg_calls, tag)
        max_err["clip_worklist"] = max_err["clip_merge"] = 0.0
        v_params = make_params(cfgs["stress_vis"], bench_rig(0), dev)
        (ldr, diag), out["vis_launches"] = count_launches(handles, lambda: frame(
            cfgs["stress_vis"], s_scene, s_dl, s_flags, v_params, return_diagnostics=True))
        out["stress_vis"], out["stress_vis_diag"] = ldr.cpu().numpy(), diagnostics_dict(diag)
        vis_calls = capture((raster_vis.KERNEL,), lambda: frame(
            cfgs["stress_vis"], s_scene, s_dl, s_flags, v_params))
        vis_tiles = sorted({int(t) for a, _ in vis_calls["raster_vis"] for t in a[1].tolist()})
        tiles_vis = cfgs["stress_vis"].tiles_x * cfgs["stress_vis"].tiles_y
        log(f"{tag}kernel 6 on tiles {vis_tiles[0]}..{vis_tiles[-1]} "
            f"({sum(t >= tiles_vis for t in vis_tiles)} below the frame), launches "
            f"{out['vis_launches']}")
        if r == n - 1:
            require(vis_tiles[-1] >= tiles_vis, f"{tag}kernel 6: no padded tile row")
            check_parity((raster_vis.KERNEL,), vis_calls, max_err, tag)
        bvh = builder.build_rt_bvh(device=dev)
        rt_calls = capture((bvh_packet.KERNEL,), lambda: frame(cfgs["rt"], bvh=bvh))
        world_pos = transform_vertices(scene, dl, params.proj_view)[0]
        check_occlusion(rt_calls["bvh_occlusion"], 1 + lights.num, tag, dl.tri_vtx, world_pos)
        max_err["bvh_occlusion"] = 0.0
        ldr, out["rt_launches"] = count_launches(handles, lambda: frame(cfgs["rt"], bvh=bvh))
        out["rt"] = ldr.cpu().numpy()
    torch.cuda.synchronize()
    if r == 0:
        out["max_err"] = max_err
        return out
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump({"max_err": max_err}, f)
    return None


def sharded_phase(card: str, max_err: dict, base: dict) -> dict:
    """Phase 15, the row-band sharded frames (parallel/sharded.py) at
    1920x1080: (a) one rank in an NCCL group against render_frame;
    (b) 2 and 4 ranks sharing the card (gloo) against (a); (c) the stress
    frame and (d) the ray-traced flagship on 2 ranks; (e) the CLI's
    --devices 2 on one card; (f) ms/frame of each band count beside
    render_frame's. -> {kernel: the one-rank frame's launches, and for
    kernels 1-3 their ms per frame and bound on its calls}."""
    import contextlib
    import io
    import tempfile

    import torch
    import torch.distributed as dist
    from transmission_renderer_tpu_torch import cli
    from transmission_renderer_tpu_torch.models.procedural import build_stress_scene
    from transmission_renderer_tpu_torch.parallel import make_band_mesh, render_frame_sharded
    from transmission_renderer_tpu_torch.parallel.ranks import BandRanks, free_init_method
    from transmission_renderer_tpu_torch.render.frame import render_frame
    from transmission_renderer_tpu_torch.scene.textures import linear_to_srgb
    from transmission_renderer_tpu_torch.utils.png import read_png

    scene, dl, flags = base["scene"], base["dl"], base["flags"]
    params, lights, bvh = base["params"], base["lights"], base["bvh"]
    cfgs = sharded_configs(1)
    handles = port_handles()

    def single(cfg, **kw):
        return render_frame(scene, dl, params, lights, cfg, flags=flags, **kw)

    # render_frame's visibility-branch stress frame, (c)'s yardstick there
    vis_cfg = sharded_configs(2)["stress_vis"]
    s_scene, s_dl, s_flags = build_stress_scene().finish_bundle(device=scene.positions.device)
    img_vis, vis_diag = render_frame(s_scene, s_dl, make_params(
        vis_cfg, bench_rig(0), scene.positions.device), lights, vis_cfg, flags=s_flags,
        return_diagnostics=True)
    img_vis, vis_diag = img_vis.cpu().numpy(), diagnostics_dict(vis_diag)
    del s_scene, s_dl

    img, s_diag = single(cfgs["default"], return_diagnostics=True)
    img, s_diag = img.cpu().numpy(), diagnostics_dict(s_diag)
    times = {"render_frame": host_frames(lambda: single(cfgs["default"]), 2, 10)}

    # (a) one rank, NCCL
    dist.init_process_group("nccl", init_method=free_init_method(), world_size=1, rank=0)
    try:
        mesh = make_band_mesh(1)

        def sframe(cfg, **kw):
            return render_frame_sharded(scene, dl, params, lights, cfg, mesh, flags=flags, **kw)

        calls = capture(handles, lambda: sframe(cfgs["default"]))
        require(not calls["transmission_fetch"], "sharded: kernel 4 ran; the band sampler "
                "replaces its pyramid fetch")
        check_parity(handles[:3], calls, max_err, "sharded n=1 ")
        rows = {}
        for h in handles[:3]:  # the band's calls (here the whole frame) against the bound
            per_call = (gbuf_counts(calls[h.name]) if h.name == "raster_gbuf"
                        else [None] * len(calls[h.name]))
            b_ms, b_by = bound_of([kernel_work(h.name, c, d)
                                   for c, d in zip(calls[h.name], per_call)])
            k_ms, h_ms = kernel_ms(h, calls[h.name])
            rows[h.name] = {"ms": k_ms, "bound_ms": b_ms, "bound_by": b_by}
            log(f"sharded n=1 kernel {h.name} on [{card}]: {k_ms:.3f} ms/frame on the device "
                f"(host {h_ms:.3f}), bound {b_ms:.4f} ms by {b_by}, {b_ms / k_ms:.4f} of the "
                f"bound reached, {len(calls[h.name])} call(s) per frame")
        (ldr1, diag1), launches1 = count_launches(
            handles, lambda: sframe(cfgs["default"], return_diagnostics=True))
        expect = dict.fromkeys(launches1, 0)
        expect.update(raster_gbuf=2, tap_finish=1, shade=2)
        log(f"sharded n=1 (NCCL) launches per frame: {launches1}")
        require(launches1 == expect, f"sharded n=1 launches {launches1}, expected {expect}")
        ldr1 = ldr1.cpu().numpy()
        require(ldr1.shape == (1080, 1920, 3) and bool(np.isfinite(ldr1).all()),
                "sharded n=1: frame shape or finiteness")
        err1 = float(np.abs(ldr1 - img).max())
        d1 = diagnostics_dict(diag1)
        log(f"sharded n=1 against render_frame: max abs {err1:.3e} (limit "
            f"{SHARDED_MAX_ABS}); diagnostics {d1}, overflowed {diag1.overflowed()}")
        require(err1 <= SHARDED_MAX_ABS, f"sharded n=1 differs from render_frame by {err1}")
        require(not diag1.overflowed(), f"sharded n=1 overflow: {d1}")
        # the fields both frames report: the tier ladder's and the peel's
        shared = ("max_bin_count", "big_tri_count", "big_tri_capacity", "mid_tri_count",
                  "mid_tri_capacity", "tier_overflow", "clip_unresolved")
        require(all(d1[f] == s_diag[f] for f in shared),
                f"sharded n=1 diagnostics differ from render_frame's on {shared}: {s_diag}")
        glass = glass_mask(calls)
        rt1 = sframe(cfgs["rt"], bvh=bvh).cpu().numpy()
        img_rt = single(cfgs["rt"], bvh=bvh).cpu().numpy()
        rt1_err = float(np.abs(rt1 - img_rt).max())
        log(f"sharded n=1 rt against render_frame's rt: max abs {rt1_err:.3e} "
            f"({float(np.abs(rt1 - img_rt)[~glass].max()):.3e} off the glass's "
            f"{int(glass.sum())} pixels; limit {SHARDED_MAX_ABS} over the frame)")
        # rt1 is (d)'s yardstick
        require(rt1_err <= SHARDED_MAX_ABS, f"sharded n=1 rt differs from render_frame by "
                f"{rt1_err}")
        times[1] = host_frames(lambda: sframe(cfgs["default"]), 2, 10)
    finally:
        dist.destroy_process_group()

    # (b)-(d) 2 and 4 ranks sharing the card
    golden = read_png(os.path.join(ROOT, "tests", "goldens", "stress_hd.png"))[..., :3] / 255.0
    for n in (2, 4):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            with BandRanks(n, sharded_frames_on_rank, (tmp,), device="cuda") as mesh:
                log(f"sharded n={n}: {n} ranks on [{card}], backend gloo "
                    f"(staged {mesh.staged})")
                res = sharded_frames_on_rank(mesh, tmp)
            errs = [res["max_err"]] + [json.load(open(os.path.join(tmp, f"rank{r}.json")))
                                       ["max_err"] for r in range(1, n)]
        for e in errs:
            for k, v in e.items():
                max_err[k] = max(max_err.get(k, 0.0), v)
        log(f"sharded n={n}: group ran in {time.perf_counter() - t0:.1f} s; rank 0 launches "
            f"{res['launches']}")
        require(res["launches"] == expect, f"sharded n={n} rank 0 launches {res['launches']}")
        require(res["diag"] == d1, f"sharded n={n} diagnostics {res['diag']} differ from "
                f"n=1's {d1}")
        full_err = float(np.abs(res["full_halo"] - ldr1).max())
        diff = np.abs(res["default"] - ldr1).max(axis=-1)
        off_err = float(diff[~glass].max())
        over = diff > SHARDED_MAX_ABS
        log(f"sharded n={n}: halo of the band height: max abs {full_err:.3e} over the whole "
            f"frame; default 64-px halo: max abs {off_err:.3e} off the glass, "
            f"{int(over[glass].sum())} glass pixels beyond {SHARDED_MAX_ABS} (max "
            f"{float(diff[glass].max()):.3e}); diagnostics equal to n=1's")
        require(full_err <= SHARDED_MAX_ABS, f"sharded n={n} full-halo frame off by {full_err}")
        require(off_err <= SHARDED_MAX_ABS, f"sharded n={n} off-glass pixels off by {off_err}")
        require(not over[~glass].any(), "sharded: a pixel off the glass moved")
        times[n] = res["times"]
        if n == 2:
            sd = res["stress_diag"]
            rmse = float(np.sqrt(np.mean((linear_to_srgb(res["stress"]) - golden) ** 2)))
            log(f"sharded n=2 stress (8 peel rounds, full re-race caps): sRGB RMSE {rmse:.6f} "
                f"against stress_hd.png (limit 4e-3); clip_unresolved {sd['clip_unresolved']}; "
                f"diagnostics {sd}")
            require(rmse < 4e-3, f"sharded stress sRGB RMSE {rmse}")
            vd = res["stress_vis_diag"]
            vis_err = float(np.abs(res["stress_vis"] - img_vis).max())
            log(f"sharded n=2 stress on the visibility branch (halo of the band height): max "
                f"abs {vis_err:.3e} over the frame against render_frame's (limit "
                f"{SHARDED_MAX_ABS}); rank 0 launches {res['vis_launches']}; diagnostics {vd}")
            require(vis_err <= SHARDED_MAX_ABS, f"sharded n=2 vis stress off by {vis_err}")
            require(res["vis_launches"]["raster_vis"] == 2, "sharded vis: kernel 6 launches")
            require(not any(vd[f] > vd[c] for f, c in (
                ("max_bin_count", "bin_capacity"), ("big_tri_count", "big_tri_capacity"))),
                f"sharded vis stress overflow: {vd}")
            require(all(vd[f] == vis_diag[f] for f in ("max_bin_count", "big_tri_count",
                                                       "clip_unresolved")),
                    f"sharded vis stress diagnostics differ from render_frame's {vis_diag}")
            rt_err = float(np.abs(res["rt"] - rt1).max(axis=-1)[~glass].max())
            log(f"sharded n=2 rt: max abs {rt_err:.3e} off the glass against the n=1 rt frame; "
                f"rank 0 launches {res['rt_launches']}")
            require(rt_err <= SHARDED_MAX_ABS, f"sharded n=2 rt off by {rt_err}")
            require(res["rt_launches"]["bvh_occlusion"] == 2, "sharded rt: kernel 5 launches")

    # (e) --devices 2 on the one card
    err = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, contextlib.redirect_stderr(err):
        rc = cli.main(["--procedural", "dragon", "--devices", "2", "-o",
                       os.path.join(tmp, "never.png")])
    msg = err.getvalue().strip()
    log(f"sharded cli --devices 2 on {torch.cuda.device_count()} card(s): exit {rc}, {msg!r}")
    require(rc == 2 and msg == "error: --devices 2 but only 1 available",
            "cli --devices 2: not the reference's refusal")

    # (f) timing
    summary = {}
    for key, ts in times.items():
        summary[str(key)] = statistics.median(ts)
        log(f"sharded timing on [{card}] ({'render_frame' if key == 'render_frame' else f'{key} rank(s)'}): "
            f"median {statistics.median(ts):.3f} ms/frame over 10 after 2 (host clock), "
            f"min {min(ts):.3f}, max {max(ts):.3f}")
    log("sharded timing: ranks that share one card say nothing about scaling")
    log(json.dumps({"sharded_ms": summary, "card": card}))
    return {name: dict(rows.get(name, {}), launches=n) for name, n in launches1.items()}


def sharded_card_frames(mesh, out_dir: str):
    """--sharded-cards on one rank (a card of its own): the flagship at
    the default halo (launches, diagnostics) and at a halo of the band
    height, the ray-traced flagship at full and half resolution, and the
    flagship timed; every rank renders the same frames in order. ->
    rank 0's frames, or None on the others."""
    import dataclasses

    import torch
    from transmission_renderer_tpu_torch.parallel import render_frame_sharded

    cfgs = sharded_configs(mesh.size)
    cfgs["rt_half"] = dataclasses.replace(cfgs["rt"], half_res_shadow_rays=True)
    builder, scene, dl, flags, params, lights = flagship_scene(mesh.device)
    bvh = builder.build_rt_bvh(device=mesh.device)

    def frame(cfg, **kw):
        return render_frame_sharded(scene, dl, params, lights, cfg, mesh, flags=flags, **kw)

    out = {}
    (ldr, diag), out["launches"] = count_launches(
        port_handles(), lambda: frame(cfgs["default"], return_diagnostics=True))
    out["default"], out["diag"] = ldr.cpu().numpy(), diagnostics_dict(diag)
    out["full_halo"] = frame(cfgs["full_halo"]).cpu().numpy()
    for key in ("rt", "rt_half"):
        out[key] = frame(cfgs[key], bvh=bvh).cpu().numpy()
    out["times"] = host_frames(lambda: frame(cfgs["default"]), 2, 10)
    torch.cuda.synchronize()
    return out if mesh.rank == 0 else None


def sharded_cards() -> int:
    """--sharded-cards: the row-band frame on 2 and 4 ranks with a card
    each (NCCL; needs 4 cards), against render_frame: the flagship off
    the glass and with a halo of the band height everywhere, the
    ray-traced flagship at full and half resolution, within 2e-6; its
    launches and diagnostics; ms/frame per band count beside
    render_frame's (host clock, 10 after 2); then cli.main with
    --devices 2 and 4 against render_frame's frame."""
    import dataclasses
    import tempfile

    import torch
    from transmission_renderer_tpu_torch import kernels
    from transmission_renderer_tpu_torch.parallel.ranks import BandRanks
    from transmission_renderer_tpu_torch.render.frame import render_frame

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    require(torch.cuda.device_count() >= 4, "--sharded-cards needs 4 cards")
    kernels.build()
    card = card_line()
    log(f"cards: {torch.cuda.device_count()} x [{card}]")
    builder, scene, dl, flags, params, lights = flagship_scene(torch.device("cuda", 0))
    bvh = builder.build_rt_bvh(device=scene.positions.device)
    cfgs = sharded_configs(1)
    cfgs["rt_half"] = dataclasses.replace(cfgs["rt"], half_res_shadow_rays=True)

    def single(key):
        kw = {"bvh": bvh} if key.startswith("rt") else {}
        return render_frame(scene, dl, params, lights, cfgs[key], flags=flags, **kw)

    ref = {k: single(k).cpu().numpy() for k in ("default", "rt", "rt_half")}
    # the dense transmissive raster covers every tile
    dense = dataclasses.replace(cfgs["default"], transmission_tile_cap_frac=None)
    glass = glass_mask(capture(port_handles()[:1], lambda: render_frame(
        scene, dl, params, lights, dense, flags=flags)))
    times = {"render_frame": host_frames(lambda: single("default"), 2, 10)}
    for n in (2, 4):
        with BandRanks(n, sharded_card_frames, ("",), device="cuda") as mesh:
            require(not mesh.staged, "sharded cards: expected NCCL")
            res = sharded_card_frames(mesh, "")
        log(f"sharded cards n={n} (NCCL, cuda:0..{n - 1}): launches on rank 0 "
            f"{res['launches']}, diagnostics {res['diag']}")
        for key in ("default", "full_halo", "rt", "rt_half"):
            diff = np.abs(res[key] - ref["default" if key == "full_halo" else key]).max(axis=-1)
            area = diff if key == "full_halo" else diff[~glass]
            log(f"sharded cards n={n} {key}: max abs {float(area.max()):.3e} "
                f"{'over the frame' if key == 'full_halo' else 'off the glass'}, "
                f"{int((diff > SHARDED_MAX_ABS).sum())} pixels beyond {SHARDED_MAX_ABS}")
            require(float(area.max()) <= SHARDED_MAX_ABS, f"sharded cards n={n} {key}")
        times[n] = res["times"]
    for n in (2, 4):
        with tempfile.TemporaryDirectory() as tmp:
            frames, calls, launches, err = cli_run(port_handles(), [
                "--procedural", "dragon", "--roughness-override", "0.25", "--devices",
                str(n), "-o", os.path.join(tmp, f"devices{n}.png")])
        diff = float(np.abs(frames[0] - ref["default"]).max(axis=-1)[~glass].max())
        log(f"sharded cards cli --devices {n}: max abs {diff:.3e} off the glass against "
            f"render_frame's frame; rank 0 launches {launches}")
        require(diff <= SHARDED_MAX_ABS, f"cli --devices {n} frame")
    for key, ts in times.items():
        log(f"sharded cards timing on [{card}] "
            f"({'render_frame, one card' if key == 'render_frame' else f'{key} cards'}): "
            f"median {statistics.median(ts):.3f} ms/frame over 10 after 2 (host clock), "
            f"min {min(ts):.3f}, max {max(ts):.3f}")
    print(json.dumps({"sharded_cards_ms": {str(k): statistics.median(v)
                                           for k, v in times.items()}, "card": card}),
          flush=True)
    return 0


# ---------------------------------------------------------------------------
# phase 16: pair-stream compaction and the frontier traversal
# ---------------------------------------------------------------------------

# pallas_pair_cap_frac values on the flagship at 1080p: a capacity that
# holds its valid pairs, and one (the 65,536-slot floor) that does not
PAIR_FIT_FRAC = 0.5
PAIR_OVERFLOW_FRAC = 0.01


def binning_calls(frame) -> list:
    """The arguments of each ops/raster.py::bin_triangles call that one
    run of ``frame()`` makes (render/frame.py's kernel branch)."""
    from transmission_renderer_tpu_torch.render import frame as frame_mod

    seen, real = [], frame_mod.bin_triangles

    def spy(*args, **kw):
        seen.append(args)
        return real(*args, **kw)

    frame_mod.bin_triangles = spy
    try:
        frame()
    finally:
        frame_mod.bin_triangles = real
    return seen


def check_compacted_bins(args, frac: float) -> tuple:
    """One binning call's set-up binned with pallas_pair_cap_frac ``frac``
    and without: the demand is every valid pair; while it fits the
    capacity, the compacted sorted stream equals the uncompacted one's
    valid prefix (sentinels past it) and tile_start is equal; past it, the
    stream holds the capacity's pairs. -> (demand, capacity, the
    uncompacted stream's length)."""
    import torch
    from transmission_renderer_tpu_torch.ops.raster import bin_triangles

    args = args[:7]
    plain = bin_triangles(*args)
    got = bin_triangles(*args, frac)
    s_len = plain.sorted_tri_ids.shape[0]
    demand, cap = int(got.pair_demand), got.pair_capacity
    require(0 < cap < s_len and got.sorted_tri_ids.shape[0] == cap,
            f"pair compaction at {frac}: capacity {cap} of a {s_len}-slot stream")
    require(demand == int(plain.tile_start[-1]),
            f"pair demand {demand}, the stream's valid pairs {int(plain.tile_start[-1])}")
    if demand <= cap:
        require(torch.equal(got.tile_start, plain.tile_start),
                "compacted tile_start differs from the uncompacted one")
        require(torch.equal(got.sorted_tri_ids[:demand], plain.sorted_tri_ids[:demand]),
                "compacted sorted stream differs from the uncompacted valid prefix")
        require(bool((got.sorted_tri_ids[demand:] == -1).all()),
                "compacted stream: a non-sentinel past the demand")
    else:
        require(int(got.tile_start[-1]) == cap, "overflowing compaction: stream not full")
    return demand, cap, s_len


def span_turns(frames: dict, names: tuple, warmups: int, reps: int) -> dict:
    """ms of each frame and of its passes ``names`` on the GPU timeline
    (CUDA events around the frame and inside render/frame.py's
    pass_scope), the frames of ``frames`` run in turns, their order
    alternating, ``reps`` runs each after ``warmups`` -> {key: {"frame" or
    pass name: [ms]}}."""
    import contextlib

    import torch
    from transmission_renderer_tpu_torch.render import frame as frame_mod

    real, marks = frame_mod.pass_scope, {}

    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @contextlib.contextmanager
    def scope(name):
        with real(name):
            start = event() if name in names else None
            yield
            if start is not None:
                marks[name] = (start, event())

    out = {k: {n: [] for n in ("frame",) + names} for k in frames}
    frame_mod.pass_scope = scope
    try:
        for i in range(warmups + reps):
            for key in (list(frames) if i % 2 == 0 else list(frames)[::-1]):
                marks.clear()
                start = event()
                frames[key]()
                end = event()
                end.synchronize()
                if i >= warmups:
                    out[key]["frame"].append(start.elapsed_time(end))
                    for n in names:
                        out[key][n].append(marks[n][0].elapsed_time(marks[n][1]))
    finally:
        frame_mod.pass_scope = real
    return out


def compaction_phase(card: str, base: dict) -> None:
    """Phase 16(a): the flagship with pair-stream compaction at 1920x1080.
    The binning call's stream compacted at PAIR_FIT_FRAC equals the
    uncompacted valid prefix; the frame launches the flagship's kernels
    and equals phase 5's bit for bit, no overflow; at PAIR_OVERFLOW_FRAC
    the overflow is reported and the image stays finite in [0, 1]; the
    binning and payload spans and the frame, with and without, in turns."""
    import dataclasses

    import torch
    from transmission_renderer_tpu_torch.config import RenderConfig
    from transmission_renderer_tpu_torch.render.frame import render_frame

    scene, dl, flags, params, lights = (base[k] for k in ("scene", "dl", "flags", "params",
                                                          "lights"))
    cfg = RenderConfig(width=1920, height=1080)

    def frame_at(frac, **kw):
        c = dataclasses.replace(cfg, pallas_pair_cap_frac=frac)
        return render_frame(scene, dl, params, lights, c, flags=flags, **kw)

    calls = binning_calls(lambda: frame_at(None))
    require(len(calls) == 1, f"the flagship made {len(calls)} binning calls, expected 1")
    demand, cap, s_len = check_compacted_bins(calls[0], PAIR_FIT_FRAC)
    log(f"compaction (a): stream {s_len} slots, pair_demand {demand}, pair_capacity {cap} "
        f"at pallas_pair_cap_frac {PAIR_FIT_FRAC}; the sorted stream equals the "
        f"uncompacted valid prefix, tile_start equal")
    require(demand <= cap, f"pair demand {demand} past the capacity {cap}")
    (img, diag), launches = count_launches(port_handles()[:4], lambda: frame_at(
        PAIR_FIT_FRAC, return_diagnostics=True))
    expect = {"raster_gbuf": 2, "tap_finish": 1, "shade": 2, "transmission_fetch": 1}
    log(f"compaction (a): launches {launches}; FrameDiagnostics pair_demand "
        f"{int(diag.pair_demand)}, pair_capacity {diag.pair_capacity}, overflowed "
        f"{diag.overflowed()}; image equal to phase 5's: {torch.equal(img, base['img'])}")
    require(launches == expect, f"compaction launch counts {launches}, expected {expect}")
    require((int(diag.pair_demand), diag.pair_capacity) == (demand, cap),
            "compaction: the frame's diagnostics differ from its binning's")
    require(not diag.overflowed(), f"compaction: capacity overflow {diag}")
    require(torch.equal(img, base["img"]), "the compacted frame differs from phase 5's")

    over_demand, over_cap, _ = check_compacted_bins(calls[0], PAIR_OVERFLOW_FRAC)
    img_o, diag_o = frame_at(PAIR_OVERFLOW_FRAC, return_diagnostics=True)
    lo, hi = float(img_o.min()), float(img_o.max())
    log(f"compaction (a) overflow at pallas_pair_cap_frac {PAIR_OVERFLOW_FRAC}: pair_demand "
        f"{int(diag_o.pair_demand)} > pair_capacity {diag_o.pair_capacity}, overflowed "
        f"{diag_o.overflowed()}, image in [{lo:.4f}, {hi:.4f}], "
        f"{int((img_o != base['img']).any(dim=-1).sum())} pixels moved")
    require(diag_o.overflowed() and int(diag_o.pair_demand) > diag_o.pair_capacity
            and (int(diag_o.pair_demand), diag_o.pair_capacity) == (over_demand, over_cap),
            "compaction: the forced overflow is not reported")
    require(bool(torch.isfinite(img_o).all()) and 0.0 <= lo and hi <= 1.0,
            "compaction: the overflowing frame is not finite in [0, 1]")

    spans = ("binning", "payload")
    times = span_turns({"uncompacted": lambda: frame_at(None),
                        "compacted": lambda: frame_at(PAIR_FIT_FRAC)}, spans, 2, 10)
    for key, t in times.items():
        log(f"compaction timing on [{card}] ({key}): median of 10 after 2, in turns, "
            + ", ".join(f"{n} {statistics.median(t[n]):.3f} ms" for n in spans)
            + f", frame {statistics.median(t['frame']):.3f} ms "
              f"(min {min(t['frame']):.3f}, max {max(t['frame']):.3f})")
    log(json.dumps({"compaction_ms": {k: {n: statistics.median(v) for n, v in t.items()}
                                      for k, t in times.items()},
                    "stream": s_len, "pair_demand": demand, "pair_capacity": cap,
                    "card": card}))


def bfs_phase(card: str, call, tri_vertices, positions) -> None:
    """Phase 16(b): ops/bvh.py::trace_shadow_bfs on the rays of a
    recorded kernel-5 call (the RT flagship's opaque pass): hits equal to
    kernel 5's ray for ray with no overflow (cap_factor from 8, doubled
    while the frontier overflows); ms of each, in turns, and the peak
    memory each allocates."""
    import torch
    from transmission_renderer_tpu_torch.ops import bvh_packet
    from transmission_renderer_tpu_torch.ops.bvh import trace_shadow_bfs

    (tree, _, rays, t_min), _ = call
    want = bvh_packet.KERNEL.replay(call, True)
    o, d, tm = rays[0:3].T, rays[6:9].T, rays[9]
    cap_factor = 8

    def bfs():
        return trace_shadow_bfs(tree, tri_vertices, positions, o, d, t_min, tm,
                                cap_factor=cap_factor)

    while True:
        hit, over = bfs()
        if int(over) == 0:
            break
        log(f"bfs: cap_factor {cap_factor} overflows the frontier by {int(over)}; doubling")
        cap_factor *= 2
        require(cap_factor <= 64, "bfs: the frontier overflows at cap_factor 64")
    bad = int((hit != want).sum())
    log(f"bfs (b): {rays.shape[1]} rays ({int((tm > t_min).sum())} live), cap_factor "
        f"{cap_factor}, overflow 0, hits {int(hit.sum())}, differing from kernel 5's {bad}")
    require(bad == 0, "bfs: the frontier traversal's hits differ from kernel 5's")

    def peak_mb(fn) -> float:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - before) / 2**20

    kernel5 = lambda: bvh_packet.KERNEL.replay(call, True)  # noqa: E731
    turns = [cuda_ms(fn, 1, warmup=False) for fn in (bfs, kernel5, kernel5, bfs)]
    bfs_ms, k5_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    mem = {"bfs": peak_mb(bfs), "kernel5": peak_mb(kernel5)}
    log(f"bfs timing on [{card}]: trace_shadow_bfs {bfs_ms:.3f} ms, kernel 5 (bvh_occlusion) "
        f"{k5_ms:.3f} ms on the same {rays.shape[1]} rays, in turns (bfs, kernel 5, kernel 5, "
        f"bfs: {', '.join(f'{t:.3f}' for t in turns)}); peak memory allocated beyond the "
        f"inputs: bfs {mem['bfs']:.1f} MiB, kernel 5 {mem['kernel5']:.1f} MiB")
    log(json.dumps({"bfs_ms": bfs_ms, "kernel5_ms": k5_ms, "cap_factor": cap_factor,
                    "peak_mib": mem, "rays": rays.shape[1], "card": card}))


def port_handles() -> tuple:
    """Every kernel's handle: the flagship's four, then the occlusion
    walk (ray-traced frames), the visibility raster (vis frames) and the
    closest-hit walk (the AS-debug view)."""
    from transmission_renderer_tpu_torch.ops import (
        bvh_closest, bvh_packet, raster_gbuf, raster_vis, tap_finish)
    from transmission_renderer_tpu_torch.render import shade_kernel

    return (raster_gbuf.KERNEL, tap_finish.TAP_KERNEL, shade_kernel.KERNEL,
            tap_finish.FETCH_KERNEL, bvh_packet.KERNEL, raster_vis.KERNEL,
            bvh_closest.KERNEL)


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
            scene, dl, params, lights, cfg, flags=flags, **kw))
        for h in handles:
            if calls[h.name] and h.name not in out:
                dev_ms, h_ms = kernel_ms(h, calls[h.name])
                out[h.name] = {"ms": dev_ms, "host_ms": h_ms, "calls": len(calls[h.name])}
    # kernel 6's alpha form, on phase 13's frame
    from transmission_renderer_tpu_torch.models.procedural import build_stress_scene
    from transmission_renderer_tpu_torch.ops import raster_vis

    s_scene, s_dl, s_flags = build_stress_scene().finish_bundle(device=dev)
    cfg = RenderConfig(width=1920, height=1080, opaque_block_cap_frac=0.8125,
                       use_pallas_raster=False)
    calls = capture((raster_vis.KERNEL,), lambda: render_frame(
        s_scene, s_dl, make_params(cfg, bench_rig(0), dev), lights, cfg, flags=s_flags))
    dev_ms, h_ms = kernel_ms(raster_vis.KERNEL, calls["raster_vis"])
    out["raster_vis_alpha"] = {"ms": dev_ms, "host_ms": h_ms, "calls": len(calls["raster_vis"])}
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
        return render_frame(scene, dl, params, lights, cfg, flags=flags, **kw)

    handles = port_handles()[:4]

    # ---- 4. kernel parity at the path's own shapes -----------------------------
    calls = capture(handles, frame)
    max_err = {}
    check_parity(handles, calls, max_err, "")
    sliver_check(dev)

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
        return render_frame(scene, dl, params, lights, cfg_rt, flags=flags, bvh=bvh, **kw)

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
        return render_frame(scene, dl, params, lights, cfg_half, flags=flags, bvh=bvh, **kw)

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
        return render_frame(scene, dl, params, lights, cfg_vis, flags=flags, **kw)

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
    (img_vis, hdr_vis, diag), vis_launches = count_launches(
        vis_handles, vis_frame, return_hdr=True, return_diagnostics=True)
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
    stress_rows, peel_rows = stress_phase(card, max_err)

    # ---- 10. the bench's other scenes --------------------------------------------
    bench_launches, bench_kernels = bench_scenes_phase(card, max_err)

    # ---- 11. the CLI ---------------------------------------------------------------
    closest_row, multi_launches = cli_phase(card, max_err, img, img_vis)
    kernel_rows.append(closest_row)

    # ---- 12. the frame variants --------------------------------------------------
    full_form = variants_phase(card, max_err, {
        "scene": scene, "dl": dl, "flags": flags, "params": params, "lights": lights,
        "bvh": bvh, "img": img, "img_rt": img_rt, "hdr_vis": hdr_vis})
    for row in kernel_rows:  # kernel 4's row covers both of its forms
        if row["name"] == "transmission_fetch":
            row["full_form"] = full_form

    # ---- 13. the visibility-buffer stress frame: kernel 6's alpha form ------
    alpha_form = vis_clip_phase(card, max_err)
    for row in kernel_rows:  # kernel 6's row covers its alpha form
        if row["name"] == "raster_vis":
            row["alpha_form"] = alpha_form

    # ---- 14. glTF JPEG images ----------------------------------------------------
    jpeg_phase(card, max_err, multi_launches)

    # ---- 15. row-band sharded frames -------------------------------------------------
    sharded = sharded_phase(card, max_err, {
        "scene": scene, "dl": dl, "flags": flags, "params": params, "lights": lights,
        "bvh": bvh})
    for row in kernel_rows:  # the one-rank sharded flagship's calls
        row["sharded"] = sharded[row["name"]]
    kernel_rows.extend(peel_rows)  # the flagship runs no peel

    # ---- 16. pair-stream compaction; the frontier traversal beside kernel 5 ------
    compaction_phase(card, {"scene": scene, "dl": dl, "flags": flags, "params": params,
                            "lights": lights, "img": img})
    bfs_phase(card, rt_calls["bvh_occlusion"][0], dl.tri_vtx, world_pos)

    for row in kernel_rows:  # the worst over every frame checked (a row of two
        # kernels, "a+b", takes the worse of the two)
        row["max_abs_err"] = max(max_err[n] for n in row["name"].split("+"))
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
    sys.exit({"--kernel-times": kernel_times, "--sharded-cards": sharded_cards}.get(
        " ".join(sys.argv[1:]), main)())
