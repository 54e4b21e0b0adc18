"""The dense phase's loss in plain PyTorch (Topo4D ``train.py:315``, ``:541-543``).

total = w_im (0.8 L1 + 0.2 (1 - SSIM)) + w_soft mean_points(sum_rgb |c - anchor|)

L1 terms take the derivative +1 at a residual of exactly 0, as JAX's
``jnp.abs`` does. SSIM: an 11-tap Gaussian window of sigma 1.5, zero
padded, separable, over the stacked maps, c1 = 0.01^2, c2 = 0.03^2. The
window runs as two depthwise convolutions, with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


class _Abs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.abs()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def abs_jax(x: torch.Tensor) -> torch.Tensor:
    return _Abs.apply(x)


def window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(size) - size // 2
    g = np.exp(-(xs**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def blur(x: torch.Tensor) -> torch.Tensor:
    """(C, H, W) -> (C, H, W): the window down the columns, then along the rows."""
    c = x.shape[0]
    g = torch.as_tensor(window(), device=x.device, dtype=x.dtype)
    half = g.shape[0] // 2
    y = F.conv2d(x[None], g.view(1, 1, -1, 1).expand(c, 1, -1, 1), padding=(half, 0), groups=c)
    return F.conv2d(y, g.view(1, 1, 1, -1).expand(c, 1, 1, -1), padding=(0, half), groups=c)[0]


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    c = a.shape[0]
    mu = blur(torch.cat([a, b, a * a, b * b, a * b]))
    m1, m2 = mu[:c], mu[c:2 * c]
    s1, s2, s12 = mu[2 * c:3 * c] - m1 * m1, mu[3 * c:4 * c] - m2 * m2, mu[4 * c:] - m1 * m2
    c1, c2 = 0.01**2, 0.03**2
    return (((2 * m1 * m2 + c1) * (2 * s12 + c2)) / ((m1 * m1 + m2 * m2 + c1) * (s1 + s2 + c2))).mean()


def dense_loss(image, target, colors, anchor, weights):
    """-> the total loss (0-d)."""
    photometric = 0.8 * abs_jax(image - target).mean() + 0.2 * (1.0 - ssim(image, target))
    soft = abs_jax(colors - anchor.to(colors.dtype)).sum(-1).mean()
    return weights["im"] * photometric + weights["soft_color"] * soft
