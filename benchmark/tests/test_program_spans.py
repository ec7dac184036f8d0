"""The program's own spans as the benchmark reads them
(core/program_spans.py and the readers clip_alpha_test.span_ms,
clip_peel.host_ms and render_frame.dispatched_ops), on the small
checkout's foliage frames on the CPU: the program's binning and peel
spans lie within core/spans.py's event wrapper's readings of the same
frames (on the card, marked ``cuda``: within 2% or 0.2 ms of them), and
the readers read the spans and counts they name."""

from __future__ import annotations

import io
from types import SimpleNamespace

import pytest
import torch
from conftest import ROOT

from benchmark.core import program_spans, registry
from transmission_renderer_tpu_torch.render import frame, shading
from transmission_renderer_tpu_torch.utils import profiling

CPU = torch.device("cpu")
READERS = ("clip_alpha_test.span_ms", "clip_peel.host_ms", "render_frame.dispatched_ops")
FRAMES = 2


def _render(v, params):
    return v.render(params)


@pytest.fixture(scope="module")
def stretches(small_root):
    torch.set_num_threads(4)
    bench = registry.load_benchmark(small_root)
    v = program_spans.viewer(bench, "foliage.orbit", 2**31 + 17, CPU, small_root)
    timed = program_spans.timed_stretch(v, _render, lambda: None, CPU, FRAMES)
    counted = program_spans.counted_stretch(v, _render, lambda: None, CPU, frames=1)
    return timed, counted


def _agreement(spans, events, frames):
    """{range name: (the program's device span, the wrapper's) ms per frame}."""
    program = program_spans.ProgramSpans(spans, [])
    return {name: (program.span_ms(name), events[name] / frames)
            for name in ("binning", "raster_clip_peel")}


def test_program_spans_lie_within_the_event_wrapper(stretches):
    """On the CPU both read the host's clock, and the wrapper's reading
    holds the program's span and its range's own cost (record_function's
    enter and exit, under 0.5 ms a span)."""
    (spans, events, times), _ = stretches
    count = {name: sum(s.name == name for s in spans) / FRAMES
             for name in ("binning", "raster_clip_peel")}
    for name, (ours, theirs) in _agreement(spans, events, FRAMES).items():
        assert 0 < ours <= theirs <= ours + 0.5 * count[name], name
    assert len(times) == FRAMES
    # both hand the program its own pass ranges back
    assert frame.pass_scope is profiling.pass_scope is shading.pass_scope
    assert profiling.current_tracer() is None


@pytest.mark.cuda
def test_program_spans_agree_with_the_event_wrapper_on_the_card():
    """On the card's clock the program's binning and peel spans read what
    the wrapper's events read over the same frames: within 2% or 0.2 ms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    v = program_spans.viewer(registry.load_benchmark(), "foliage.orbit", 2**31 + 29, dev)
    spans, events, _ = program_spans.timed_stretch(v, _render, torch.cuda.synchronize, dev, 6)
    for name, (ours, theirs) in _agreement(spans, events, 6).items():
        assert abs(ours - theirs) <= max(0.02 * theirs, 0.2), (name, ours, theirs)


def test_readers_read_the_program_spans(stretches):
    (spans, _, _), counted = stretches
    program = program_spans.ProgramSpans(spans, counted)
    got = {name: registry.metric_reader(name, ROOT)(SimpleNamespace(program=program))
           for name in READERS}
    assert got["clip_alpha_test.span_ms"] == pytest.approx(
        sum(s.device_ms for s in spans if s.name == "clip_alpha_test") / FRAMES)
    assert got["clip_peel.host_ms"] == pytest.approx(
        sum(s.host_ms for s in spans if s.name == "raster_clip_peel") / FRAMES)
    # stretches of their own tracers (frame ids from 0 in each) add up per frame
    twice = program_spans.ProgramSpans(spans + spans, counted)
    assert twice.span_ms("clip_alpha_test") == pytest.approx(got["clip_alpha_test.span_ms"])
    whole = counted[0].counters
    assert counted[0].name == profiling.FRAME_SPAN and whole["ops"] > 0
    assert got["render_frame.dispatched_ops"] == whole["ops"] + whole["launches"]
    # a trace without the program's spans reads nothing
    assert all(registry.metric_reader(name, ROOT)(SimpleNamespace()) is None
               for name in READERS)
    out = io.StringIO()
    program_spans.print_passes(program, out)
    table = out.getvalue()
    assert "clip_alpha_test" in table and "clip_round_1:" in table
    rows = {r["pass"]: r for r in program.passes()}
    rounds = len(program.round_range())
    assert rounds == len(program.round_demand()[0][0]) and rows[profiling.FRAME_SPAN]["per_frame"] == 1
    assert rows["clip_alpha_test"]["per_frame"] == 2 * (1 + rounds)
    assert rows[profiling.FRAME_SPAN]["ops"] == whole["ops"]
