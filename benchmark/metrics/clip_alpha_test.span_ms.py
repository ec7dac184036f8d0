"""The alpha tests' time on the device timeline per frame
(render/frame.py::_clip_alpha_ok_tiles: every ``clip_alpha_test`` span
of the frame, each peel's first test and one per re-race round), from the
program's own spans (its FrameTracer, benchmark/core/program_spans.py)
in frames no profiler slows; nothing where the run handed the trace no
program spans or the scene has no alpha clip."""


def read(trace):
    program = getattr(trace, "program", None)
    return None if program is None else program.span_ms("clip_alpha_test")
