"""Pinned values, scenes and checks of the port's 1080p frames, shared by
the tests that run them on the card (tests/test_torch_card_hd.py,
tests/test_torch_cuda.py) and by the CPU tests that recompute the pinned
values from the reference.

It imports only the port, NumPy and torch, never JAX, so a card run
with ``--noconftest`` loads it; the band group's rank targets live here
because spawned ranks import them by name."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import struct

import numpy as np
import torch

from transmission_renderer_tpu_torch.config import RenderConfig

# a sliver of the glass blob (the benchmark's dragon.orbit, seed 4004,
# frame 32): clip-space vertices as the frame computes them; at 1920x1080
# its float32 edge functions read "inside" at pixel (1160, 170), 3 px
# right of its vertices' box, where float64 reads outside, and no pixel
# centre lies inside it (the tests of the pixel box read it from here)
SLIVER = [[0.9275342226028442, -3.1695566177368164, 0.009908081032335758, 4.605861186981201],
          [0.9480902552604675, -3.1573805809020996, 0.009908118285238743, 4.604023456573486],
          [0.9262080192565918, -3.165588140487671, 0.009908199310302734, 4.599979877471924]]
SLIVER_PIXEL = (1160, 170)

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

# The bench's stress cell (bench.py:276, 284-286): the stress scene at its
# default size, RenderConfig(1920, 1080, opaque_block_cap_frac=0.8125).
# Its camera is bench.py::make_rig's, which smooths toward CameraRig's
# targets on every update (reference scene/camera.py:151-165): the sweep
# sets target yaw 0.02 i and updates once a frame for 10 frames, and the
# diagnostics guard updates once more at target yaw 0.18 (bench.py:147-149,
# 206-216). BENCH_r05.json (the reference on a TPU) printed for that guard:
STRESS_REFERENCE = {"clip_unresolved": 196, "clip_round_demand": (510, 156, 26),
                    "clip_round_caps": (608, 162, 41)}

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

# tests/assets/multi.glb through the CLI at its defaults: its glass quad
# covers this many 8x128 tiles, more than the sparse transmissive raster's
# default cap (0.25 of 2025 tiles: 507), so --check-nan reports it. The
# count is the reference's own binning's
# (tests/test_torch_cli.py::test_multi_glb_transmission_tiles_are_the_references).
MULTI_GLB_TRANSMISSION_TILES = 592


# ---------------------------------------------------------------------------
# diagnostics, scenes
# ---------------------------------------------------------------------------

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


def bench_lights(dev):
    """bench.py's two point lights, which the flagship's golden shares."""
    from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light

    return pack_lights([point_light([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0),
                        point_light([8.0, 0.8, 0.0], [0.0, 1.0, 0.0], 10.0)], device=dev)


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
    from transmission_renderer_tpu_torch.models.procedural import build_dragon_scene

    builder = build_dragon_scene(roughness_override=0.25)
    scene, dl, flags = builder.finish_bundle(device=dev)
    params = make_params(RenderConfig(width=1920, height=1080), flagship_rig(), dev)
    return builder, scene, dl, flags, params, bench_lights(dev)


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


def bench_scene(name: str, dev, small: bool = False):
    """(scene, draw list, flags, config, frame params, lights) of bench
    scene ``name`` on ``dev``: at the bench's size, config, camera and
    lights, or with ``small`` at its small golden's."""
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
        lights = pack_lights(procedural.bindless_lights(20 if small else 48), device=dev)
    elif small:
        lights = pack_lights([point_light([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0)], device=dev)
    else:
        lights = bench_lights(dev)
    return scene, dl, flags, cfg, params, lights


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


# ---------------------------------------------------------------------------
# GLB documents
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# kernel calls: recording, and each kernel against its plain version
# ---------------------------------------------------------------------------

def all_handles() -> tuple:
    """Every kernel's handle: the flagship's four, the occlusion walk, the
    visibility raster, the closest-hit walk and the clip peel's four."""
    from transmission_renderer_tpu_torch.ops import (
        bvh_closest, bvh_packet, raster_gbuf, raster_vis, tap_finish)
    from transmission_renderer_tpu_torch.render import frame, shade_kernel

    return (raster_gbuf.KERNEL, tap_finish.TAP_KERNEL, shade_kernel.KERNEL,
            tap_finish.FETCH_KERNEL, bvh_packet.KERNEL, raster_vis.KERNEL,
            bvh_closest.KERNEL, frame.CLIP_ALPHA_KERNEL, frame.CLIP_WORKLIST_KERNEL,
            frame.CLIP_MERGE_KERNEL, frame.CLIP_ROUNDS_KERNEL)


def snapshot(x):
    """``x`` with every tensor in it copied (tuples, lists and dicts
    walked; a NamedTuple, such as the scene, which no kernel writes, is
    kept as it is)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: snapshot(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)) and not hasattr(x, "_fields"):
        return type(x)(snapshot(v) for v in x)
    return x


class Snapshots(list):
    """A KernelHandle recorder that keeps each call's arguments as they
    were when the call was made: the peel's rounds handle, worklist and
    merge read a state and ok that they or later rounds change in place."""

    def append(self, call):
        super().append(snapshot(call))


@contextlib.contextmanager
def plain_versions(*handles):
    """Within the block each handle runs its plain version for CUDA
    operands too."""
    kept = [h.cuda for h in handles]
    for h in handles:
        h.cuda = h.plain
    try:
        yield
    finally:
        for h, cuda in zip(handles, kept):
            h.cuda = cuda


@contextlib.contextmanager
def snapshots_of(*handles):
    """Within the block each handle's calls are recorded by Snapshots ->
    the recorders, in the order of ``handles``."""
    recorders = [Snapshots() for _ in handles]
    for h, r in zip(handles, recorders):
        h.recorder = r
    try:
        yield recorders
    finally:
        for h in handles:
            h.recorder = None


def record(frame, snapshots: bool = True) -> tuple:
    """(frame()'s result, {kernel name: recorded calls}, {kernel name:
    launches}) with every count reset just before; the peel's rounds
    handle, worklist and merge recorded by Snapshots (``snapshots``)."""
    handles = all_handles()
    peel = {"clip_rounds", "clip_worklist", "clip_merge"} if snapshots else set()
    for h in handles:
        h.launches = 0
        h.recorder = Snapshots() if h.name in peel else []
    try:
        out = frame()
        torch.cuda.synchronize()
    finally:
        calls = {h.name: h.recorder for h in handles}
        for h in handles:
            h.recorder = None
    return out, calls, {h.name: h.launches for h in handles}


def words(t):
    """A float32 tensor's bits as int32 (other tensors as they are)."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(g, r):
    """Equal, NaN where both are NaN."""
    return (g == r) | (torch.isnan(g) & torch.isnan(r))


def check_against_plain(handle, call) -> None:
    """One recorded call through the kernel and the plain version: the
    rasters' outputs equal (NaN where both are NaN); kernel 3 within 1e-5
    on all but 0.05% of the pixels (log2f / cosf ulps can move a
    cluster-boundary pixel to its neighbouring z-slice); kernels 2 and 4
    within 1e-6; the occlusion hit set exact."""
    got, ref = handle.replay(call, True), handle.replay(call, False)
    if isinstance(ref, dict):
        got, ref = [got[k] for k in ref], list(ref.values())
    if handle.name == "bvh_occlusion":
        assert torch.equal(got, ref), int((got != ref).sum())
        return
    if handle.name in ("raster_gbuf", "raster_vis"):
        bad = sum(int((~_same(g, r)).sum()) for g, r in zip(got, ref))
        assert bad == 0, f"{handle.name}: {bad} values differ"
        return
    tol = 1e-5 if handle.name == "shade" else 1e-6
    over = torch.stack([~(((g.double() - r.double()).abs() <= tol) | _same(g, r))
                        for g, r in zip(got, ref)])
    if handle.name == "shade":
        bad_px = int(over.any(dim=0).sum())
        assert bad_px <= 5e-4 * over.shape[1], f"shade: {bad_px} pixels past 1e-5"
    else:
        assert not bool(over.any()), f"{handle.name}: {int(over.sum())} values past 1e-6"


def check_clip_alpha(calls, seed: int = 29) -> None:
    """Each recorded call of the peel's alpha test through the kernel and
    the plain version, each over a copy of one random ok state: equal bit
    for bit, and the rows no slot names (the empty slots' pad row among
    them) as they were."""
    from transmission_renderer_tpu_torch.render.frame import CLIP_ALPHA_KERNEL as h

    assert calls, "the frame never called the peel's alpha test"
    gen = torch.Generator(device=calls[0][0][4].device).manual_seed(seed)
    for (scene, ch, ids, n_tiles, ok_p), kw in calls:
        base = torch.rand(ok_p.shape, generator=gen, device=ok_p.device) < 0.5
        got = h.replay(((scene, ch, ids, n_tiles, base.clone()), kw), True)
        ref = h.replay(((scene, ch, ids, n_tiles, base.clone()), kw), False)
        named = torch.zeros(n_tiles + 1, dtype=torch.bool, device=ok_p.device)
        named[ids.long()] = True
        named[n_tiles] = False
        assert torch.equal(got, ref)
        assert torch.equal(got[~named], base[~named])


def check_clip_peel(calls) -> None:
    """Each recorded call of the peel's rounds handle (recorded by
    Snapshots: its state and ok as they were before the call) three ways,
    each over a copy: the C entry (csrc/clip_peel.cu's
    trt_clip_peel_rounds), the per-round kernels launched round by round
    (the handle's plain loop on the card) and the plain loop (that loop
    over the per-round plain versions, kernel 1's and the alpha test's
    included): the state, ok and every round's demand equal bit for bit.
    The round-by-round run's worklists and merges then each go through the
    kernel and its plain version: every output, and the merged state and
    raced channels, equal bit for bit."""
    from transmission_renderer_tpu_torch.ops import raster_gbuf
    from transmission_renderer_tpu_torch.render.frame import (
        CLIP_ALPHA_KERNEL,
        CLIP_MERGE_KERNEL as mg,
        CLIP_ROUNDS_KERNEL as h,
        CLIP_WORKLIST_KERNEL as wl,
    )

    assert calls, "the frame never called the peel's rounds handle"
    for call in calls:
        c_call, loop_call, plain_call = snapshot(call), snapshot(call), snapshot(call)
        demand = h.replay(c_call, True)
        with snapshots_of(wl, mg) as (wl_calls, mg_calls):
            loop_demand = h.replay(loop_call, False)
        with plain_versions(wl, mg, raster_gbuf.KERNEL, CLIP_ALPHA_KERNEL):
            plain_demand = h.replay(plain_call, False)
        assert len(wl_calls) == len(mg_calls) == demand.shape[0] == len(call[0][6])
        for other, other_demand in ((loop_call, loop_demand), (plain_call, plain_demand)):
            assert torch.equal(demand, other_demand), (demand.tolist(), other_demand.tolist())
            assert torch.equal(words(c_call[0][1]), words(other[0][1]))
            assert torch.equal(c_call[0][2], other[0][2])
        round_kernels_match_plain(wl_calls, mg_calls)


def round_kernels_match_plain(wl_calls, mg_calls) -> None:
    """Each recorded round's worklist and merge (recorded by Snapshots)
    through the kernels and the plain versions, each over a copy of its
    arguments: every output, and the merged state and raced channels,
    equal bit for bit."""
    from transmission_renderer_tpu_torch.render.frame import (
        CLIP_MERGE_KERNEL as mg,
        CLIP_WORKLIST_KERNEL as wl,
    )

    assert wl_calls and len(wl_calls) == len(mg_calls), (len(wl_calls), len(mg_calls))
    for wc, mc in zip(wl_calls, mg_calls):
        got, ref = wl.replay(snapshot(wc), True), wl.replay(snapshot(wc), False)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and torch.equal(words(g), words(r))
        a, b = snapshot(mc), snapshot(mc)
        mg.replay(a, True)
        mg.replay(b, False)
        (sa, _, _, ra), (sb, _, _, rb) = a[0], b[0]
        assert torch.equal(words(sa), words(sb))
        for n in ra:
            assert torch.equal(words(ra[n]), words(rb[n])), n


def check_occlusion(calls, tri_vertices, positions) -> None:
    """Each recorded occlusion call through the kernel and the plain walk,
    over the kernel's own table and over the packet table built apart from
    it from the frame's triangles (``tri_vertices`` into the world
    ``positions``): the three hit sets equal, and the two walks count the
    same pops and triangle tests."""
    from transmission_renderer_tpu_torch.ops import bvh_packet
    from transmission_renderer_tpu_torch.ops.bvh import occlusion_walk

    assert calls
    for call in calls:
        tree, table, rays, t_min = call[0]
        got = bvh_packet.KERNEL.replay(call, True)
        walk = occlusion_walk(tree, table, rays, t_min)
        packet = occlusion_walk(tree, bvh_packet.packet_walk_table(tree, tri_vertices,
                                                                   positions), rays, t_min)
        assert torch.equal(got, walk[0]), int((got != walk[0]).sum())
        for a, b in zip(walk, packet):
            assert torch.equal(a, b)


def sliver_check(dev) -> None:
    """Kernels 1 and 6 on the card draw no pixel of SLIVER at 1920x1080;
    kernel 1 with the record's box widened to the screen draws exactly
    SLIVER_PIXEL (the edge functions alone cover it)."""
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
    assert drawn["box"] == [] and vis == {True: 0, False: 0}, (drawn, vis)
    assert drawn["screen"] == [SLIVER_PIXEL], drawn


# ---------------------------------------------------------------------------
# pair-stream compaction
# ---------------------------------------------------------------------------

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
    from transmission_renderer_tpu_torch.ops.raster import bin_triangles

    args = args[:7]
    plain = bin_triangles(*args)
    got = bin_triangles(*args, frac)
    s_len = plain.sorted_tri_ids.shape[0]
    demand, cap = int(got.pair_demand), got.pair_capacity
    assert 0 < cap < s_len and got.sorted_tri_ids.shape[0] == cap, (cap, s_len)
    assert demand == int(plain.tile_start[-1]), demand
    if demand <= cap:
        assert torch.equal(got.tile_start, plain.tile_start)
        assert torch.equal(got.sorted_tri_ids[:demand], plain.sorted_tri_ids[:demand])
        assert bool((got.sorted_tri_ids[demand:] == -1).all())
    else:
        assert int(got.tile_start[-1]) == cap
    return demand, cap, s_len


# ---------------------------------------------------------------------------
# the row-band frames: each rank's part (spawned ranks import these)
# ---------------------------------------------------------------------------

def sharded_configs(n: int) -> dict:
    """The row-band frames' configs on n bands: the flagship at the
    default 64-px halo and at a halo of the band height (every pyramid
    level gathered), the ray-traced flagship at full and half resolution,
    the stress frame with its peel run to convergence (stress_hd.png's
    frame), and the stress frame on the visibility branch (kernel 6's
    alpha form) with dense shading and a halo of the band height."""
    from transmission_renderer_tpu_torch.parallel.sharded import _band_tile_rows

    cfg = RenderConfig(width=1920, height=1080)
    band_h = _band_tile_rows(cfg, n) * cfg.tile_h
    rt = dataclasses.replace(cfg, ray_traced_shadows=True)
    return {"default": cfg,
            "full_halo": dataclasses.replace(cfg, sharded_refraction_halo_px=band_h),
            "rt": rt, "rt_half": dataclasses.replace(rt, half_res_shadow_rays=True),
            "stress": RenderConfig(width=1920, height=1080, alpha_clip_rounds=8,
                                   clip_retile_cap_frac=1.0),
            "stress_vis": RenderConfig(width=1920, height=1080, use_pallas_raster=False,
                                       transmission_block_cap_frac=None,
                                       sharded_refraction_halo_px=band_h)}


def band_frames(mesh, stress: bool = False) -> dict:
    """One rank's row-band frames, every rank making the same calls in
    the same order: the flagship at the default halo (its launches and
    diagnostics; the last band, whose tiles run into the rows padded below
    the frame, holds every kernel call against its plain version) and at
    a halo of the band height, and the ray-traced flagship at full and
    half resolution (kernel 5 exact on every band). With ``stress``, the
    converged stress frame (on the band's tile ids, on every rank: the
    peel's first-round alpha tests bit for bit, and its rounds handle's
    calls through the C entry, the round-by-round kernels and the plain
    loop bit-equal) and the stress frame
    on the visibility branch (the last band's kernel-6 calls against their
    plain version). -> {frame: LDR array, "launches"..., "diag"...}."""
    from transmission_renderer_tpu_torch.models.procedural import build_stress_scene
    from transmission_renderer_tpu_torch.ops.cull import transform_vertices
    from transmission_renderer_tpu_torch.parallel import render_frame_sharded

    cfgs, dev, last = sharded_configs(mesh.size), mesh.device, mesh.rank == mesh.size - 1
    builder, scene, dl, flags, params, lights = flagship_scene(dev)
    bvh = builder.build_rt_bvh(device=dev)

    def frame(key, s=scene, d=dl, f=flags, p=params, **kw):
        return render_frame_sharded(s, d, p, lights, cfgs[key], mesh, flags=f,
                                    return_diagnostics=True, **kw)

    out = {}
    (ldr, diag), calls, out["launches"] = record(lambda: frame("default"))
    out["default"], out["diag"] = ldr.cpu().numpy(), diagnostics_dict(diag)
    n_tiles = cfgs["default"].tiles_x * cfgs["default"].tiles_y
    if last and mesh.size > 1:
        assert max(int(t) for a, _ in calls["raster_gbuf"] for t in a[1].tolist()) >= n_tiles
    if last:
        for h in all_handles()[:3]:
            for call in calls[h.name]:
                check_against_plain(h, call)
    out["full_halo"] = frame("full_halo")[0].cpu().numpy()
    world_pos = transform_vertices(scene, dl, params.proj_view)[0]
    for key in ("rt", "rt_half"):
        (ldr, _), calls, out[f"{key}_launches"] = record(lambda: frame(key, bvh=bvh))
        out[key] = ldr.cpu().numpy()
        check_occlusion(calls["bvh_occlusion"], dl.tri_vtx, world_pos)
    if stress:
        s_scene, s_dl, s_flags = build_stress_scene().finish_bundle(device=dev)
        for key in ("stress", "stress_vis"):
            s_params = make_params(cfgs[key], bench_rig(0), dev)
            (ldr, diag), calls, out[f"{key}_launches"] = record(
                lambda: frame(key, s_scene, s_dl, s_flags, s_params))
            out[key], out[f"{key}_diag"] = ldr.cpu().numpy(), diagnostics_dict(diag)
            if key == "stress":
                rounds = 2 * (cfgs[key].alpha_clip_rounds - 1)
                assert len(calls["clip_rounds"]) == 2
                assert out[f"{key}_launches"]["clip_worklist"] == rounds
                check_clip_alpha(calls["clip_alpha"])
                check_clip_peel(calls["clip_rounds"])
            elif last:
                from transmission_renderer_tpu_torch.ops import raster_vis

                assert max(int(t) for a, _ in calls["raster_vis"]
                           for t in a[1].tolist()) >= n_tiles
                for call in calls["raster_vis"]:
                    check_against_plain(raster_vis.KERNEL, call)
    torch.cuda.synchronize()
    return out


def band_rank(mesh, stress: bool) -> None:
    """A spawned rank of a band group: its part of band_frames."""
    band_frames(mesh, stress)
