"""Target views: the known scene rendered by the benchmark's own renderer
(``reference/render.py``), quantised to uint8 and kept on the host, as a
decoded capture is. The program's renderer never makes them."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import render as R

TARGET_SPAN = 4  # tiles per axis of a target Gaussian, as the port's synthetic targets are binned
TARGET_LOGIT_OPACITY = 6.0


@torch.no_grad()
def render_views(scene, rig, head: np.ndarray, device):
    """Every view of ``rig`` of the known scene on ``head`` -> [(H, W, 3) uint8]."""
    n = head.shape[0]
    means = torch.as_tensor(head, device=device)
    quats = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device).repeat(n, 1)
    scales = torch.full((n, 3), float(np.exp(scene.log_scale)), device=device)
    colors = torch.as_tensor(scene.colors, device=device)
    opacity = torch.sigmoid(torch.full((n,), TARGET_LOGIT_OPACITY, device=device))
    out = []
    for v in range(rig.w2c.shape[0]):
        cam = R.rig_camera(rig, v, device)
        xy, depth, conic, radius, visible = R.project(means, quats, scales, cam)
        bins = R.bin_tiles(xy, depth, radius, visible, cam.width, cam.height, TARGET_SPAN)
        image = R.render(bins, xy, conic, opacity, colors, cam.width, cam.height)
        out.append((torch.clamp(image, 0.0, 1.0) * 255).to(torch.uint8).permute(1, 2, 0).contiguous())
    return [v.cpu().numpy() for v in out]
