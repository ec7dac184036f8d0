"""Both ``raster_clip_peel`` ranges' spans on the device timeline per
frame (render/frame.py::_rasterize_clip_peeled: the alpha tests and the
re-race rounds), timed by CUDA events (benchmark/core/spans.py); nothing
where the scene has no alpha clip."""


def read(trace):
    return trace.span_ms({"raster_clip_peel"})
