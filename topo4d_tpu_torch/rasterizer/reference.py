"""The oracle renderer (``rasterizer/reference.py``): every pixel blends
every Gaussian in depth order, O(N x pixels) per view, in blocks of image
rows.

Plain PyTorch on the tensors' device: the JAX package's semantic contract,
not a TPU kernel, selected by name (``raster.backend = "oracle"``).
Backward is autograd except for the blending weights, whose adjoint is the
hand-derived one of ``rasterizer.blend.blend_weights`` (the JAX oracle's
custom VJP). A splat blends only inside its 3-sigma tile rect, as in CUDA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.utils.checkpoint

from topo4d_tpu_torch.core.camera import Camera
from topo4d_tpu_torch.core.gaussian import ALPHA_MAX, ALPHA_MIN, GaussianRenderVars, project_gaussians
from topo4d_tpu_torch.rasterizer.blend import blend_weights
from topo4d_tpu_torch.rasterizer.render import RenderOutput
from topo4d_tpu_torch.rasterizer.tiles import TILE, depth_sorted_order, tile_rect


def _alpha_at_pixels(
    pix: torch.Tensor,  # (P, 2) pixel centers
    means2d: torch.Tensor,  # (M, 2)
    conics: torch.Tensor,  # (M, 3)
    opacities: torch.Tensor,  # (M,)
    valid: torch.Tensor,  # (M,)
    rect=None,
) -> torch.Tensor:
    """Per (pixel, Gaussian) alpha with the CUDA skip rules -> (P, M);
    ``rect`` (x0, y0, x1, y1), each Gaussian's touched tile rect, or None
    (no rect test)."""
    d = means2d[None, :, :] - pix[:, None, :]
    dx, dy = d[..., 0], d[..., 1]
    power = -0.5 * (conics[None, :, 0] * dx * dx + conics[None, :, 2] * dy * dy) - conics[None, :, 1] * dx * dy
    raw = opacities[None, :] * torch.exp(power)
    alpha = raw + (torch.clamp(raw, max=ALPHA_MAX) - raw).detach()
    keep = (power <= 0.0) & (alpha >= ALPHA_MIN) & valid[None, :]
    if rect is not None:
        x0, y0, x1, y1 = rect
        tx = torch.floor(pix[:, 0] / TILE).to(torch.int64)[:, None]
        ty = torch.floor(pix[:, 1] / TILE).to(torch.int64)[:, None]
        keep = keep & (tx >= x0[None, :]) & (tx < x1[None, :]) & (ty >= y0[None, :]) & (ty < y1[None, :])
    return torch.where(keep, alpha, torch.zeros_like(alpha))


def _render_rows(
    ys: torch.Tensor, width: int, means2d, conics, colors, depths, opacities, valid, bg, rect
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A block of image rows -> (rgb (R, W, 3), depth (R, W), alpha (R, W))."""
    xs = torch.arange(width, dtype=means2d.dtype, device=means2d.device)
    pix = torch.stack(torch.broadcast_tensors(xs[None, :], ys[:, None].to(means2d.dtype)), dim=-1).reshape(-1, 2)
    alpha = _alpha_at_pixels(pix, means2d, conics, opacities, valid, rect)
    w, t_final = blend_weights(alpha)
    rgb = w @ colors + t_final[:, None] * bg[None, :]
    depth = w @ depths[:, None]
    r = ys.shape[0]
    return rgb.reshape(r, width, 3), depth.reshape(r, width), (1.0 - t_final).reshape(r, width)


def render_gaussians(
    rv: GaussianRenderVars,
    cam: Camera,
    bg: Optional[torch.Tensor] = None,
    means2d_offset: Optional[torch.Tensor] = None,
    row_block: int = 16,
    remat: bool = False,
) -> RenderOutput:
    """One view through the oracle, on the device of ``rv``'s tensors.

    ``row_block``: rows per block, which bounds the (rows x W, N) working
    set. ``remat``: recompute each block in the backward instead of saving
    its residuals (at 8,280 Gaussians and 375x512 they are tens of GB).
    ``num_cropped`` and ``num_overflow`` are 0: the oracle neither crops nor
    caps.
    """
    dev = rv.means3d.device
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=dev)
    proj = project_gaussians(rv, cam, means2d_offset)
    order = depth_sorted_order(proj)
    means2d = proj.means2d[order]
    conics = proj.conics[order]
    colors = rv.colors[order]
    depths = proj.depths[order]
    opacities = rv.opacities[order]
    valid = proj.mask[order]
    rx0, ry0, rx1, ry1, _, _ = tile_rect(proj, cam.width, cam.height)
    rect = (rx0[order], ry0[order], rx1[order], ry1[order])

    h, w = cam.height, cam.width
    all_ys = torch.arange(h + (-h) % row_block, device=dev).reshape(-1, row_block)

    def body(ys, means2d, conics, colors, depths, opacities, bg):
        return _render_rows(ys, w, means2d, conics, colors, depths, opacities, valid, bg, rect)

    blocks = []
    for ys in all_ys:
        args = (ys, means2d, conics, colors, depths, opacities, bg)
        blocks.append(torch.utils.checkpoint.checkpoint(body, *args, use_reentrant=False) if remat else body(*args))
    rgb = torch.cat([b[0] for b in blocks])[:h]
    depth = torch.cat([b[1] for b in blocks])[:h]
    alpha = torch.cat([b[2] for b in blocks])[:h]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return RenderOutput(image=rgb.permute(2, 0, 1), radii=proj.radii, depth=depth[None], alpha=alpha[None],
                        num_cropped=zero, num_overflow=zero)
