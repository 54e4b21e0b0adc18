"""The renderer front end (counterpart of ``rasterizer/pallas.py``).

project -> bin (fresh, on detached inputs) -> pack -> tile blend ->
composite the background -> untile, for one full-canvas view. The binning
is not differentiated; gradients reach the Gaussians through the pack's
inverse gather and the projection.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from topo4d_tpu_torch.core.camera import Camera
from topo4d_tpu_torch.core.gaussian import GaussianRenderVars, project_gaussians
from topo4d_tpu_torch.rasterizer.blend import tile_blend
from topo4d_tpu_torch.rasterizer.tiles import (
    TILE,
    compute_binning,
    num_tiles,
    pack_with_binning,
)


class RenderOutput(NamedTuple):
    image: torch.Tensor  # (3, H, W)
    radii: torch.Tensor  # (N,) int32
    depth: torch.Tensor  # (1, H, W)
    alpha: torch.Tensor  # (1, H, W)
    num_cropped: torch.Tensor  # () int32 Gaussians cropped to max_span^2 tiles


def render_gaussians(
    rv: GaussianRenderVars,
    cam: Camera,
    bg: Optional[torch.Tensor] = None,
    means2d_offset: Optional[torch.Tensor] = None,
    max_span: int = 4,
) -> RenderOutput:
    """Render one view (the contract of ``render_gaussians_pallas``).

    Runs where ``rv``'s tensors live: the CUDA kernels on the card, the
    plain blend on the CPU.
    """
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=rv.means3d.device)
    width, height = cam.width, cam.height
    proj = project_gaussians(rv, cam, means2d_offset)
    binning = compute_binning(proj.detach(), width, height, max_span)
    bins = pack_with_binning(proj, rv.colors, rv.opacities, binning)
    tiles_x, tiles_y = num_tiles(width, height)
    out = tile_blend(bins.packed, bins.tile_start, bins.tile_count, tiles_x, tiles_y)

    def untile(x):
        """(T, C, 256) -> (C, H, W)."""
        c = x.shape[1]
        x = x.reshape(tiles_y, tiles_x, c, TILE, TILE)
        x = x.permute(2, 0, 3, 1, 4).reshape(c, tiles_y * TILE, tiles_x * TILE)
        return x[:, :height, :width]

    return RenderOutput(
        image=untile(out[:, 0:3, :] + out[:, 4:5, :] * bg[None, :, None]),
        radii=proj.radii,
        depth=untile(out[:, 3:4, :]),
        alpha=untile(1.0 - out[:, 4:5, :]),
        num_cropped=bins.num_cropped,
    )
