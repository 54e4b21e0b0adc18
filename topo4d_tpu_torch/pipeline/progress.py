"""Progress renders (``pipeline/progress.py``): at each geometry log row,
the configured log views rendered with the current parameters (exposure
applied), saved as ``<out>/%06d/vis<name>_<iter>.png`` through
``utils/png.py``, with their PSNR against the frame's targets (reference
``report_progress``, train.py:454-495)."""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from topo4d_tpu_torch.core.gaussian import activate_params
from topo4d_tpu_torch.losses.image import psnr
from topo4d_tpu_torch.utils.png import write_png


def save_render_png(image: torch.Tensor, path: str) -> None:
    """(3, H, W) float -> an 8-bit RGB PNG (clipped to [0, 1], x 255
    truncated, as the JAX package's PIL save)."""
    arr = torch.clamp(image, 0.0, 1.0).detach().cpu().numpy()
    write_png(path, (arr.transpose(1, 2, 0) * 255).astype(np.uint8))


@torch.no_grad()
def report_progress(
    params: Dict[str, torch.Tensor],
    render_fn,
    cams,
    images: torch.Tensor,  # (V, 3, H, W) targets
    view_names: Sequence[str],
    log_views: Sequence[str],
    out_dir: str,
    frame: int,
    iteration: int,
    apply_exposure: bool = True,
) -> Optional[float]:
    """Render and save each of ``log_views`` that is among ``view_names``
    under ``out_dir/%06d`` % ``frame`` -> the last saved view's PSNR (None
    when no log view is in the sequence)."""
    last = None
    frame_dir = os.path.join(out_dir, "%06d" % frame)
    os.makedirs(frame_dir, exist_ok=True)
    views = [(name, list(view_names).index(name)) for name in log_views if name in view_names]
    rv = activate_params(params) if views else None
    for name, vid in views:
        im = render_fn(rv, cams[vid]).image
        if apply_exposure and "cam_m" in params:
            im = torch.exp(params["cam_m"][vid])[:, None, None] * im + params["cam_c"][vid][:, None, None]
        last = float(torch.mean(psnr(im, images[vid])))
        save_render_png(im, os.path.join(frame_dir, f"vis{name}_{iteration}.png"))
    return last
