"""The card's published peaks (``peaks.json``) and the bound they set on a piece of work."""

from __future__ import annotations

import json
import os

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")) as _fh:
    PEAKS = json.load(_fh)


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: bytes over memory bandwidth or
    FP32 operations over the FP32 rate, whichever is larger."""
    return max(nbytes / PEAKS["hbm_bytes_per_s"], flops / PEAKS["fp32_flops_per_s"])
