"""Device milliseconds per dense step of the activities whose innermost
program span is ``dense.update`` (Adam) or ``dense.constraints`` (the
pre-step colour zeroing)."""

from benchmark.harness.program_spans import per_step_ms


def read(trace):
    return per_step_ms(trace, "dense.update", "dense.constraints")
