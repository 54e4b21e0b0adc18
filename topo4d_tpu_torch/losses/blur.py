"""The SSIM window: CUDA kernel K5 and its plain PyTorch version.

Replaces ``losses/blur_pallas.py``. ``gauss_blur(x)`` is the depthwise
11-tap, sigma 1.5, zero-padded "same" separable Gaussian blur of a
(C, H, W) float32 array: down the columns, then along the rows.

Dispatch: a CUDA tensor goes to ``csrc/blur.cu`` (K5) at every size, or
raises; a CPU tensor goes to ``gauss_blur_plain``, the tap-weighted shifted
slices (``_shift_pass``), which is also the kernel's oracle on the card.
The kernel accumulates in the plain version's order, so the two agree bit
for bit. The backward is the blur of the cotangent (symmetric taps, zero
padding: the blur is its own transpose). ``LAUNCHES`` counts kernel
launches and plain calls. Under a profiler K5's entry is the span ``blur``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from topo4d_tpu_torch import kernels
from topo4d_tpu_torch.utils.profiling import traced

KERNEL_TAPS = 11  # the window size csrc/blur.cu is built for

# launches of the kernel and calls of the plain version, since the last reset
LAUNCHES: Dict[str, int] = {"gauss_blur": 0, "gauss_blur_plain": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=8)
def _gaussian_1d(window_size: int, sigma: float) -> np.ndarray:
    """Normalized 1-D Gaussian taps (reference external.py:73-75)."""
    xs = np.arange(window_size) - window_size // 2
    g = np.exp(-(xs**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _shift_pass(x: torch.Tensor, axis: int, window_size: int, sigma: float) -> torch.Tensor:
    """'same' zero-padded 1-D Gaussian conv along ``axis`` as shifted slices."""
    g = _gaussian_1d(window_size, sigma)
    half = window_size // 2
    pads = [0, 0] * x.dim()
    # F.pad lists (left, right) pairs from the LAST axis backwards
    pads[2 * (x.dim() - 1 - axis)] = half
    pads[2 * (x.dim() - 1 - axis) + 1] = half
    xp = F.pad(x, pads)
    n = x.shape[axis]
    out = None
    for k in range(window_size):
        term = float(g[k]) * xp.narrow(axis, k, n)
        out = term if out is None else out + term
    return out


def gauss_blur_plain(x: torch.Tensor, window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Plain PyTorch blur of (C, H, W), differentiable by autograd."""
    LAUNCHES["gauss_blur_plain"] += 1
    return _shift_pass(_shift_pass(x, 1, window_size, sigma), 2, window_size, sigma)


@traced("blur")
def gauss_blur_cuda(x: torch.Tensor, window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Launch K5 on (C, H, W) float32 -> (C, H, W) float32."""
    if x.device.type != "cuda":
        raise ValueError(f"blur kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"blur input must be contiguous float32 (C, H, W), got {x.dtype} {tuple(x.shape)}")
    if window_size != KERNEL_TAPS:
        raise ValueError(f"the blur kernel is built for {KERNEL_TAPS} taps, got {window_size}")
    c, h, w = x.shape
    if c > 65535:
        raise ValueError(f"the blur kernel takes at most 65535 channels, got {c}")
    out = torch.empty_like(x)
    taps = (ctypes.c_float * KERNEL_TAPS)(*_gaussian_1d(window_size, sigma).tolist())
    fn = kernels.kernel("gauss_blur")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = fn(x.data_ptr(), out.data_ptr(), c, h, w, ctypes.addressof(taps), stream)
    kernels.check(status, "gauss_blur")
    LAUNCHES["gauss_blur"] += 1
    return out


class SelfAdjointBlur(torch.autograd.Function):
    """``blur(x)`` whose backward is ``blur(cotangent)``: the zero-padded
    'same' blur with symmetric taps is its own transpose
    (``blur_pallas.py:20-22``). Nothing is saved for the backward."""

    @staticmethod
    def forward(ctx, x, blur: Callable[[torch.Tensor], torch.Tensor]):
        ctx.blur = blur
        return blur(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.blur(g.contiguous()), None


def gauss_blur(x: torch.Tensor, window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Blur (C, H, W): K5 on CUDA at every size, the plain version on CPU."""
    if x.device.type == "cpu":
        return gauss_blur_plain(x, window_size, sigma)
    return SelfAdjointBlur.apply(x.contiguous(), functools.partial(gauss_blur_cuda, window_size=window_size, sigma=sigma))
