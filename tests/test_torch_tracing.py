"""The frame tracer (utils/profiling.py: FrameTracer, tracing, Span) on
the CPU, where the host clock stands in for the device's.

- ``render_frame``'s image with a tracer installed (timing, counting) is
  bit-equal to its image without one;
- spans nest under the innermost enclosing span, carry the frame's id,
  and a span's self time is its duration less the union of its
  children's;
- the op counter counts a hand-written sequence exactly (views and ops
  off the tracer's device excluded), ``KernelHandle.launches`` and sync
  warnings are attributed to the span that ran them, and a frame's
  per-pass counts sum to its frame span's;
- a span's host open lies within 100 us of the profiler's own
  ``record_function`` range for it (one clock);
- the frame span's diagnostics equal the FrameDiagnostics render_frame
  returns, the peel's per-round demands included;
- ``cli.py --spans`` writes host and device tracks of each frame.
"""

import json
import time
import types
import warnings

import numpy as np
import pytest
import torch

from transmission_renderer_tpu_torch import cli, kernels
from transmission_renderer_tpu_torch.config import (
    BUCKET_ALPHA_CLIP,
    BUCKET_OPAQUE,
    BUCKET_TRANSMISSION,
    RenderConfig,
)
from transmission_renderer_tpu_torch.models import procedural
from transmission_renderer_tpu_torch.pbr.lights import pack_lights, point_light
from transmission_renderer_tpu_torch.render.frame import make_frame_params, render_frame
from transmission_renderer_tpu_torch.scene.builder import SceneBuilder
from transmission_renderer_tpu_torch.scene.camera import CameraRig
from transmission_renderer_tpu_torch.scene.types import quat_from_axis_angle
from transmission_renderer_tpu_torch.utils import profiling
from transmission_renderer_tpu_torch.utils.profiling import (
    FRAME_SPAN,
    FrameTracer,
    pass_scope,
    tracing,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
# the kernel branch on the CPU: the alpha-clip peel's rounds, their spans
# nested three deep, and its diagnostics
CFG = RenderConfig(width=128, height=32, tile_w=128, tile_h=8, use_pallas_raster=True)


def _scene():
    """A floor, a box, a glass box and three alpha-clip leaf cards in
    front of them (holes in each): a frame whose peel runs every round."""
    b = SceneBuilder()
    checker = b.add_texture(procedural.checkerboard_texture(64, 8), srgb=True)
    ys, xs = np.meshgrid(np.arange(32), np.arange(32), indexing="ij")
    leaf = np.zeros((32, 32, 4), np.uint8)
    leaf[..., 1] = 140
    leaf[..., 3] = np.where(np.hypot(xs % 8 - 4, ys % 8 - 4) < 3, 255, 0)
    leaf_mat = b.add_material(tex_diffuse=b.add_texture(leaf, srgb=True),
                              alpha_clipping_cutoff=0.5, roughness_factor=0.8)
    leaf_card = b.add_primitive(*procedural.make_plane_mesh(1.5, y=0.0, uv_scale=1.0),
                                bucket=BUCKET_ALPHA_CLIP)
    b.add_instance(b.add_primitive(*procedural.make_plane_mesh(6.0), bucket=BUCKET_OPAQUE),
                   b.add_material(tex_diffuse=checker, roughness_factor=0.85))
    b.add_instance(b.add_primitive(*procedural.make_box_mesh((0.6, 0.6, 0.6)),
                                   bucket=BUCKET_OPAQUE),
                   b.add_material(diffuse_factor=(0.8, 0.1, 0.1, 1.0)),
                   translation=(0.0, 0.6, -4.0))
    b.add_instance(b.add_primitive(*procedural.make_box_mesh((0.4, 0.4, 0.4)),
                                   bucket=BUCKET_TRANSMISSION),
                   b.add_material(transmission_factor=1.0, roughness_factor=0.2,
                                  thickness_factor=0.5),
                   translation=(0.8, 1.0, -3.0))
    for k in range(3):
        b.add_instance(leaf_card, leaf_mat, translation=(0.1 * k, 1.2, -2.0 - 0.4 * k),
                       rotation=quat_from_axis_angle([1, 0, 0], 1.57))
    return b


def _frame_inputs():
    scene, dl, flags = _scene().finish_bundle(device=CPU)
    lights = pack_lights([point_light([0.0, 0.8, 0.0], [1.0, 0.0, 0.0], 5.0)], device=CPU)
    rig = CameraRig()
    rig.target_position = np.array([0.0, 2.2, 1.5], np.float32)
    rig.camera.position = rig.target_position.copy()
    rig.camera.pitch = rig.target_pitch = -0.25
    params = make_frame_params(CFG, rig.camera.view_matrix(), rig.camera.position,
                               rig.sun_dir(), device=CPU)
    return scene, dl, params, lights, flags


def _render(inputs, **kw):
    scene, dl, params, lights, flags = inputs
    return render_frame(scene, dl, params, lights, CFG, flags=flags, **kw)


@pytest.fixture(scope="module")
def inputs():
    return _frame_inputs()


@pytest.fixture(scope="module")
def frames(inputs):
    """The frame untraced; two frames under a timing tracer (the first
    with its diagnostics) and one under a counting tracer, with their
    spans."""
    out = {"plain": _render(inputs)}
    with tracing(FrameTracer(CPU)) as tracer:
        image, out["diagnostics"] = _render(inputs, return_diagnostics=True)
        out["timing"] = [image, _render(inputs)]
    out["timing_spans"] = tracer.read()
    with tracing(FrameTracer(CPU, counting=True)) as tracer:
        out["counting"] = [_render(inputs)]
    out["counting_spans"] = tracer.read()
    return out


@pytest.mark.parametrize("mode", ["timing", "counting"])
def test_image_is_bit_equal_with_a_tracer(frames, mode):
    assert profiling.current_tracer() is None
    for image in frames[mode]:
        assert torch.equal(image, frames["plain"])
    assert frames[f"{mode}_spans"][0].name == FRAME_SPAN


def test_spans_nest_with_frame_ids_and_self_time(frames):
    spans = frames["timing_spans"]
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert [(s.name, s.frame) for s in roots] == [(FRAME_SPAN, 0), (FRAME_SPAN, 1)]
    for s in spans:
        assert s.host_open <= s.host_close
        assert (s.device_open, s.device_close) == (s.host_open, s.host_close)
        if s.parent is None:
            continue
        p = by_id[s.parent]
        assert s.frame == p.frame
        assert p.host_open <= s.host_open and s.host_close <= p.host_close
        # the parent is the innermost span open around this one
        around = [o for o in spans if o.id < s.id and o.host_close >= s.host_close]
        assert max(around, key=lambda o: o.host_open) is p
    # the peel's rounds: render_frame > raster_clip_peel > clip_round_k > clip_alpha_test
    rounds = CFG.alpha_clip_rounds - 1
    for frame in (0, 1):
        peel = [s for s in spans if s.frame == frame and s.name == "raster_clip_peel"]
        assert len(peel) == 2 and all(by_id[s.parent].name == FRAME_SPAN for s in peel)
        tests = [s for s in spans if s.frame == frame and s.name == "clip_alpha_test"]
        assert len(tests) == 2 * (1 + rounds)
        assert sum(by_id[s.parent].name.startswith("clip_round_") for s in tests) == 2 * rounds
    for s in spans:
        kids = sorted((k.host_open, k.host_close) for k in spans if k.parent == s.id)
        covered = sum(b - a for a, b in kids)  # one thread: the children follow each other
        assert all(b0 <= a1 for (_, b0), (a1, _) in zip(kids, kids[1:]))
        assert s.self_host_ms == pytest.approx(s.host_ms - covered * 1e-6, abs=1e-9)
        assert s.self_device_ms == s.self_host_ms >= 0


def test_self_time_leaves_out_the_union_of_overlapping_children():
    """Device intervals of children may overlap; self time subtracts their union."""
    assert profiling._covered(0, 100, [(10, 30), (20, 40), (90, 120), (-5, 2)]) == 30 + 10 + 2


def _ops_sequence():
    x = torch.ones(4)  # ones
    y = x.view(2, 2)  # a view
    z = y + 1  # add
    with pass_scope("inner"):
        z.t()  # a view
        z.sum()  # sum
        x.reshape(4)  # a view
        c = x.clone()  # clone
        c[1:3] = 5  # lift_fresh and slice (views), fill_
        torch.ones(2, device="meta") + 1  # off the tracer's device
    x[x > 1]  # gt, index


def _launch_sequence(stub):
    kernels.launch(stub, lambda *a: 0)
    with pass_scope("inner"):
        kernels.launch(stub, lambda *a: 0)
        kernels.launch(stub, lambda *a: 0)


def _sync_sequence():
    warnings.warn(profiling.SYNC_WARNING)
    with pass_scope("inner"):
        for _ in range(2):
            warnings.warn(profiling.SYNC_WARNING)


@pytest.mark.parametrize("counter, sequence, outer, inner", [
    ("ops", _ops_sequence, 7, 3),
    ("launches", _launch_sequence, 3, 2),
    ("syncs", _sync_sequence, 3, 2),
])
def test_counters_count_a_hand_written_sequence(monkeypatch, counter, sequence, outer, inner):
    stub = kernels.KernelHandle("stub", "-", "-", cuda=None, plain=None)
    monkeypatch.setattr(kernels, "HANDLES", [stub])
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    args = (stub,) if counter == "launches" else ()
    with tracing(FrameTracer(CPU, counting=True)) as tracer:
        sequence(*args)  # outside any span: counted by none
        with pass_scope("outer"):
            sequence(*args)
        with pass_scope("empty"):
            pass
    spans = tracer.read()
    spans = {s.name: s for s in spans if s.parent is None and s.name != "inner"
             or s.name == "inner" and s.parent is not None}
    assert spans["inner"].parent == spans["outer"].id
    got = {name: spans[name].counters[counter] for name in ("outer", "inner", "empty")}
    assert got == {"outer": outer, "inner": inner, "empty": 0}
    if counter == "launches":
        assert spans["outer"].kernels == {"stub": outer} and spans["empty"].kernels == {}
    assert stub.launches == (2 * outer if counter == "launches" else 0)


def test_per_pass_counts_sum_to_the_frame_span(frames):
    spans = frames["counting_spans"]
    frame = spans[0]
    assert frame.name == FRAME_SPAN and frame.counters["ops"] > 0
    for counter in ("ops", "launches", "syncs"):
        self_counts = [s.counters[counter] - sum(k.counters[counter] for k in spans
                                                 if k.parent == s.id) for s in spans]
        assert min(self_counts) >= 0
        assert sum(self_counts) == frame.counters[counter]


def test_host_open_lies_on_the_profilers_clock(inputs, tmp_path):
    """Each span lies within the profiler's range of the same name give or
    take 100 us of clock error (it opens just inside the range), and opens
    within 100 us of it (the median span: a preempted host may stall
    between the two readings)."""
    from torch.profiler import ProfilerActivity, profile

    with tracing(FrameTracer(CPU)) as tracer:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _render(inputs)
    spans = tracer.read()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    ranges = sorted((e["ts"] * 1e3 + base, (e["ts"] + e["dur"]) * 1e3 + base, e["name"])
                    for e in doc["traceEvents"]
                    if e.get("cat") == "user_annotation" and e.get("ph") == "X")
    assert [n for _, _, n in ranges] == [s.name for s in spans]
    for s, (start, end, _) in zip(spans, ranges):
        assert start - 100e3 <= s.host_open and s.host_close <= end + 100e3
    gaps = sorted(abs(s.host_open - start) for s, (start, _, _) in zip(spans, ranges))
    assert gaps[len(gaps) // 2] < 100e3


def test_frame_span_carries_the_frames_diagnostics(frames):
    diag = frames["diagnostics"]
    spans = frames["timing_spans"]
    want = diag.demands()
    assert spans[0].diagnostics == want
    rounds, caps = want["clip_round_demand"]
    assert len(rounds) == len(caps) == CFG.alpha_clip_rounds - 1 and rounds[0] > 0
    assert rounds == [int(d) for d in diag.clip_round_demand]
    assert want["clip_tiles"] == (int(diag.clip_tiles), diag.clip_tile_capacity)
    # the second frame did not ask for them: its span has them all the same
    assert next(s for s in spans if s.frame == 1).diagnostics == want
    assert diag.overflowed() == (any(cap and n > cap for n, cap in list(want.values())[:-3])
                                 or want["clip_unresolved"][0] > 0
                                 or want["tier_overflow"][0] > 0)


def test_cli_spans_writes_host_and_device_tracks(tmp_path):
    path = tmp_path / "spans.json"
    t0 = time.time_ns()
    assert cli.main(["--cpu", "--procedural", "test", "--width", "64", "--height", "16",
                     "--frames", "2", "-o", str(tmp_path / "f.png"),
                     "--spans", str(path)]) == 0
    assert profiling.current_tracer() is None
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e["ph"] == "X"]
    for tid in (0, 1):
        track = [e for e in events if e["tid"] == tid]
        frames = [e for e in track if e["name"] == FRAME_SPAN]
        assert [e["args"]["frame"] for e in frames] == [0, 1]
        assert t0 / 1e3 <= frames[0]["ts"] < time.time_ns() / 1e3
        for e in track:
            f = frames[e["args"]["frame"]]
            assert f["ts"] <= e["ts"] and e["ts"] + e["dur"] <= f["ts"] + f["dur"] + 1e-3
    assert {e["name"] for e in events} >= {"binning", "raster_opaque", "shade_opaque"}
