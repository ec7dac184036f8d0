"""Kernel 5's share of its roofline, in percent: the least time its calls
could take (benchmark/work/walk.py: the table once, the rays, and the
pops and triangle tests the least any-hit walk of the frame's own tree
needs) over the time the kernel ran, over the profiled frames."""

from benchmark.work.counts import bound_seconds

KERNELS = ("bvh_occlusion_kernel",)


def read(trace):
    work = trace.work.get("bvh_occlusion")
    took = trace.kernel_seconds(KERNELS)
    if not work or took <= 0:
        return None
    return 100.0 * sum(bound_seconds(b, o) for b, o in work) / took
