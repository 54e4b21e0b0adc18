"""Device milliseconds per dense step of the activities whose innermost
program span is ``render.forward``: the step's projection, pack, composite
and untile; K1, inside ``blend.fwd``, is not counted."""

from benchmark.harness.program_spans import per_step_ms


def read(trace):
    return per_step_ms(trace, "render.forward")
