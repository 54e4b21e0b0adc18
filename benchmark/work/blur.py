"""The work of the SSIM window (the port's K5 entry, ``losses/blur.py``
``gauss_blur_cuda``) on a (C, H, W) float32 array: the 11-tap separable
blur, zero padded. Each input value read once and each output value
written once; 42 FP32 operations per value (11 multiplies and 10 adds in
each of the two passes)."""

from __future__ import annotations

import math

from .peaks import bound_s

FLOPS_PER_VALUE = 42
BYTES_PER_VALUE = 2 * 4  # read once, written once, float32


def blur_bound_s(shape) -> float:
    n = math.prod(shape)
    return bound_s(BYTES_PER_VALUE * n, FLOPS_PER_VALUE * n)
