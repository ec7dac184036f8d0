"""The share of a frame the card waits on the host: 1 - the device's busy
time per profiled frame (the union of kernel, memcpy and memset
intervals over the profiled stretch, per frame) over the frame time of
the run's own window, which no profiler slowed. The profiler slows the
host and not the device, so the stretch's own wall span would read the
profiler's cost as idle time."""


def read(trace):
    if trace.frame_ms <= 0:
        return None
    return 1.0 - (trace.busy_s / trace.frames) / (trace.frame_ms * 1e-3)
