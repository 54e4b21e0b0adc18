"""Face-parsing masks (``pipeline/masks.py``).

The reference's ``label_colormap`` (helpers.py:725-798, the bit-twiddling
branch for 14 labels), its channel-swapped use, ``get_mask`` (a pixel is in
a label when every channel of ``rgb * 255`` lies within 1 of the label's
color, helpers.py:811-823) and the inner-mouth dimming of tracked frames'
targets (train.py:320-327). The colormap is host NumPy; the masks are
tensors on the parsing image's device.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence

import numpy as np
import torch


@functools.lru_cache(maxsize=4)
def label_colormap(n_label: int = 14) -> np.ndarray:
    """(N, 3) uint8 label colormap (reference helpers.py:725-798)."""
    if n_label == 11:  # helen / ibugmask
        return np.array(
            [
                (0, 0, 0), (255, 255, 0), (139, 76, 57), (139, 54, 38),
                (0, 205, 0), (0, 138, 0), (154, 50, 205), (72, 118, 255),
                (255, 165, 0), (0, 0, 139), (255, 0, 0),
            ],
            dtype=np.uint8,
        )
    if n_label == 19:  # celebamask-hq
        return np.array(
            [
                (0, 0, 0), (204, 0, 0), (76, 153, 0), (204, 204, 0),
                (51, 51, 255), (204, 0, 204), (0, 255, 255), (255, 204, 204),
                (102, 51, 0), (255, 0, 0), (102, 204, 0), (255, 255, 0),
                (0, 0, 153), (0, 0, 204), (255, 51, 153), (0, 204, 204),
                (0, 51, 0), (255, 153, 51), (0, 204, 0),
            ],
            dtype=np.uint8,
        )
    cmap = np.zeros((n_label, 3), dtype=np.uint8)
    for i in range(n_label):
        ident = i
        r = g = b = 0
        for j in range(8):
            r |= (ident & 1) << (7 - j)
            g |= ((ident >> 1) & 1) << (7 - j)
            b |= ((ident >> 2) & 1) << (7 - j)
            ident >>= 3
        cmap[i] = (r, g, b)
    return cmap


def bgr_colormap(n_label: int = 14) -> np.ndarray:
    """The reference uses the colormap channel-swapped (helpers.py:806)."""
    return label_colormap(n_label)[:, [2, 1, 0]]


def get_mask(
    target_labels: Sequence[str],
    mask_rgb: torch.Tensor,  # (3, H, W) float in [0, 1]
    cmap_index: Dict[str, int],
    n_label: int = 14,
) -> torch.Tensor:
    """(3, H, W) in ``mask_rgb``'s dtype: 1 where the parsing image matches
    any target label's color, tiled over the channels as the reference's."""
    cmap = bgr_colormap(n_label)
    scaled = mask_rgb * 255.0
    hit = torch.zeros(mask_rgb.shape[1:], dtype=torch.bool, device=mask_rgb.device)
    for label in target_labels:
        color = torch.as_tensor(cmap[cmap_index[label]].astype(np.float32), device=mask_rgb.device).reshape(3, 1, 1)
        hit = hit | torch.all(torch.abs(scaled - color) < 1.0, dim=0)
    return hit[None].to(mask_rgb.dtype).expand(3, -1, -1)


def dim_inner_mouth(gt: torch.Tensor, mask_rgb: torch.Tensor, cmap_index: Dict[str, int]) -> torch.Tensor:
    """The target with its inner-mouth pixels x0.1 (reference train.py:320-327)."""
    m = get_mask(["inner_mouth"], mask_rgb, cmap_index)
    return torch.where(m > 0.5, gt * 0.1, gt)
