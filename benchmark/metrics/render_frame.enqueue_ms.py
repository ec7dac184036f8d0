"""Host milliseconds from render_frame's call to its return, before the
sync, averaged over the traced run's window, which runs before the
profiler starts: the frame driver's host side (render/frame.py::render_frame)."""


def read(trace):
    if not trace.enqueue_ms:
        return None
    return sum(trace.enqueue_ms) / len(trace.enqueue_ms)
