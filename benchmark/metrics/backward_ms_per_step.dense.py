"""Device milliseconds per dense step of the activities whose innermost
program span is ``dense.backward``: autograd's backward of the step, its
nodes launched on autograd's device thread while the step's own thread
waits in that span; K2 (``blend.bwd``) and K5 (``blur``) are not counted."""

from benchmark.harness.program_spans import per_step_ms


def read(trace):
    return per_step_ms(trace, "dense.backward")
