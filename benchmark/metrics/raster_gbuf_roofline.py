"""Kernel 1's share of its roofline, in percent: the least time its calls
could take (benchmark/work/counts.py, from the frame's own arrays) over
the time its kernels (plan, race, resolve) ran, over the profiled
frames."""

from benchmark.work.counts import bound_seconds

KERNELS = ("raster_plan_kernel", "raster_race_kernel", "raster_resolve_kernel")


def read(trace):
    work = trace.work.get("raster_gbuf")
    took = trace.kernel_seconds(KERNELS)
    if not work or took <= 0:
        return None
    return 100.0 * sum(bound_seconds(b, o) for b, o in work) / took
