"""The ``binning`` pass's span on the device timeline per frame
(ops/raster.py::bin_triangles and the triangle set-up), timed by CUDA
events at the range's open and close in frames no profiler slows
(benchmark/core/spans.py)."""


def read(trace):
    return trace.span_ms({"binning"})
