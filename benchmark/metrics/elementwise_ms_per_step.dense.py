"""Device milliseconds per dense step of every kernel launched outside the
blend and blur entries and outside the frame's binnings: the loss's
elementwise work, the update and the constraint writes."""

EXCLUDED = ("blend_fwd", "blend_bwd", "blur", "dense_binnings")  # the spans whose kernels are not counted


def read(trace):
    ns = sum(op.dur_ns for op in trace.ops if op.kind == "kernel" and op.span not in EXCLUDED)
    if ns <= 0 or trace.steps <= 0:
        return None
    return ns / 1e6 / trace.steps
