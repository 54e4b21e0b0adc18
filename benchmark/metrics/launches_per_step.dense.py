"""Device activities (kernels, copies, sets) in the traced window per dense step."""


def read(trace):
    if not trace.ops or trace.steps <= 0:
        return None
    return len(trace.ops) / trace.steps
