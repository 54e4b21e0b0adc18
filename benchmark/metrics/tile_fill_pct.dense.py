"""The blend's occupied tiles over the rows it launches over, in percent,
over the window's renders through frozen binnings: the program's counters
``blend.tiles_occupied`` and ``blend.rows`` (a compact list sized for the
fullest view runs every view's blend over all its rows)."""

from benchmark.harness.program_spans import program_counters


def read(trace):
    counted = program_counters()
    if not counted or counted.get("blend.rows", 0) <= 0:
        return None
    return 100.0 * counted["blend.tiles_occupied"] / counted["blend.rows"]
