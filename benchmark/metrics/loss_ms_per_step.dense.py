"""Device milliseconds per dense step of the activities whose innermost
program span is ``dense.loss``: the forward L1, SSIM and soft-colour terms
and their total; K5, inside ``blur``, is not counted."""

from benchmark.harness.program_spans import per_step_ms


def read(trace):
    return per_step_ms(trace, "dense.loss")
