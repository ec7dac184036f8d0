"""What a frame dispatches (render/frame.py::render_frame): the aten ops
dispatched on the card, views excluded, plus the hand-written kernels'
launches, counted inside the ``render_frame`` span by the program's
FrameTracer in counting mode (benchmark/core/program_spans.py) and
averaged over the counted frames. What a CUDA graph, a fused alpha-test
kernel or stacked peel channels would lower; nothing where the run handed
the trace no counted frames."""


def read(trace):
    program = getattr(trace, "program", None)
    ops = program.dispatched_ops() if program is not None else []
    return sum(ops) / len(ops) if ops else None
