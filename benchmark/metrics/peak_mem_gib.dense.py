"""The card's allocated-memory peak over the traced window, GiB."""


def read(trace):
    return trace.peak_bytes / 2**30 if trace.peak_bytes > 0 else None
