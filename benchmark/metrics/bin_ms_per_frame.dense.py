"""Device milliseconds per frame of the activities launched inside
``Trainer.dense_binnings`` (the frame's frozen binnings and compact
capacity): the ``dense_binnings`` span's share of the trace."""


def read(trace):
    ns = sum(op.dur_ns for op in trace.span_ops("dense_binnings"))
    if ns <= 0 or trace.frames <= 0:
        return None
    return ns / 1e6 / trace.frames
