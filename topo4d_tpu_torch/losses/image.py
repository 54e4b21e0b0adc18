"""Photometric losses: L1, SSIM, PSNR on (C, H, W) images (losses/image.py).

The SSIM window is the separable 11-tap Gaussian of ``losses/blur.py``:
kernel K5 on CUDA tensors, the tap-weighted shifted slices (``_shift_pass``)
on CPU tensors; exact float32 either way, no convolution library, no TF32.
"""

from __future__ import annotations

import torch

from topo4d_tpu_torch.losses.blur import _shift_pass, gauss_blur  # noqa: F401 (_shift_pass: the plain form)


class _L1Abs(torch.autograd.Function):
    """|x| differentiated as ``jnp.abs`` is: +1 where x >= 0, zero included,
    and -1 below. ``torch.abs`` gives 0 at 0, and a residual that is exactly
    0 is common in these losses: the soft-color anchor at a frame's first
    dense step, the background pixels of a render and its target."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def l1_abs(x: torch.Tensor) -> torch.Tensor:
    """|x|, with the derivative at 0 that the JAX package's losses take (+1)."""
    return _L1Abs.apply(x)


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """mean |x - y| (reference ``l1_loss_v1``)."""
    return torch.mean(l1_abs(x - y))


def l1_loss_sum_last(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """mean over the leading dims of sum_last |x - y| (reference ``l1_loss_v2``)."""
    return torch.mean(torch.sum(l1_abs(x - y), dim=-1))


def l2_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """mean sqrt((x - y)^2 + 1e-20) (reference ``l2_loss``)."""
    return torch.mean(torch.sqrt((x - y) ** 2 + 1e-20))


def weighted_l2_loss_v1(x: torch.Tensor, y: torch.Tensor, w) -> torch.Tensor:
    """mean sqrt((x - y)^2 * w + 1e-20) (reference helpers.py:126-127)."""
    return torch.mean(torch.sqrt((x - y) ** 2 * w + 1e-20))


def weighted_l2_loss_v2(x: torch.Tensor, y: torch.Tensor, w) -> torch.Tensor:
    """mean sqrt(sum_last((x - y)^2) * w + 1e-20) (reference helpers.py:130-131)."""
    return torch.mean(torch.sqrt(torch.sum((x - y) ** 2, dim=-1) * w + 1e-20))


def mse(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Per-leading-dim MSE: (C, ...) -> (C, 1)."""
    d = (img1 - img2) ** 2
    return d.reshape(d.shape[0], -1).mean(dim=1, keepdim=True)


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """20 log10(1 / sqrt(mse)) per leading dim (reference ``calc_psnr``)."""
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse(img1, img2)))


def _window_conv(img: torch.Tensor, window_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Depthwise 'same' Gaussian window of (C, H, W): K5 on the card at every
    size (one launch forward, one backward), the shifted slices on the CPU."""
    return gauss_blur(img, window_size, sigma)


def ssim(
    img1: torch.Tensor,
    img2: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
    size_average: bool = True,
) -> torch.Tensor:
    """SSIM of (C, H, W) images: Gaussian window with zero padding,
    c1 = 0.01^2, c2 = 0.03^2 (reference ``calc_ssim``)."""
    c = img1.shape[0]
    stacked = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2], dim=0)
    conv = _window_conv(stacked, window_size, sigma)
    mu1 = conv[0:c]
    mu2 = conv[c : 2 * c]
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = conv[2 * c : 3 * c] - mu1_sq
    sigma2_sq = conv[3 * c : 4 * c] - mu2_sq
    sigma12 = conv[4 * c : 5 * c] - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2))


def photometric_loss(pred: torch.Tensor, target: torch.Tensor, l1_weight: float = 0.8) -> torch.Tensor:
    """The reference image loss 0.8 L1 + 0.2 (1 - SSIM) (train.py:315)."""
    return l1_weight * l1_loss(pred, target) + (1.0 - l1_weight) * (1.0 - ssim(pred, target))
