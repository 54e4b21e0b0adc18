"""The SSIM window's share of its roofline: the bound time of every call
into the port's K5 entry (``benchmark/work/blur.py``) over the device time
of the kernels launched inside the ``blur`` span."""

from benchmark.work.blur import blur_bound_s


def read(trace):
    calls = trace.calls.get("blur", [])
    ns = sum(op.dur_ns for op in trace.span_ops("blur"))
    if not calls or ns <= 0:
        return None
    return 100.0 * sum(blur_bound_s(c["args"][0]) for c in calls) / (ns / 1e9)
