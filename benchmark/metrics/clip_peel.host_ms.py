"""The host's time in the alpha-clip peel per frame
(render/frame.py::_rasterize_clip_peeled: both ``raster_clip_peel``
spans, from entering the range to leaving it), from the program's own
spans (its FrameTracer, benchmark/core/program_spans.py). Beside
``clip_peel.span_ms``, the device's time for the same ranges, it says how
far the peel is bound by its launches; nothing where the run handed the
trace no program spans or the scene has no alpha clip."""


def read(trace):
    program = getattr(trace, "program", None)
    return None if program is None else program.span_ms("raster_clip_peel", "host")
