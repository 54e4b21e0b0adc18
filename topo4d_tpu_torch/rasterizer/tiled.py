"""Tiled renderer (``rasterizer/tiled.py``): binning, then each 16x16 tile
blends a fixed capacity of its entries front to back, in chunks that carry
(transmittance, frozen transmittance) across them.

Plain PyTorch on the tensors' device, differentiable by autograd: the
JAX package's XLA algorithm, not a TPU kernel, selected by name
(``raster.backend = "tiled"``). Per tile, entries past ``capacity`` are
dropped and counted in ``num_overflow``; Gaussians whose tile rect exceeds
``max_span`` are cropped and counted in ``num_cropped``.
"""

from __future__ import annotations

from typing import Optional

import torch

from topo4d_tpu_torch.core.camera import Camera
from topo4d_tpu_torch.core.gaussian import (
    ALPHA_MAX,
    ALPHA_MIN,
    TRANSMITTANCE_MIN,
    GaussianRenderVars,
    Projected,
    project_gaussians,
)
from topo4d_tpu_torch.rasterizer.render import RenderOutput
from topo4d_tpu_torch.rasterizer.tiles import TILE, compute_binning, num_tiles


def _chunk_alpha(pix_x: torch.Tensor, pix_y: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Per (tile, chunk entry, pixel) alpha with the CUDA skip rules ->
    (T, C, PX); ``data`` (T, C, 8): x, y, conic a, b, c, opacity, valid, 0."""
    dx = data[:, :, 0:1] - pix_x[:, None, :]
    dy = data[:, :, 1:2] - pix_y[:, None, :]
    power = -0.5 * (data[:, :, 2:3] * dx * dx + data[:, :, 4:5] * dy * dy) - data[:, :, 3:4] * dx * dy
    raw = data[:, :, 5:6] * torch.exp(power)
    # straight-through 0.99 clamp (the CUDA backward ignores the min)
    alpha = raw + (torch.clamp(raw, max=ALPHA_MAX) - raw).detach()
    keep = (power <= 0.0) & (alpha >= ALPHA_MIN) & (data[:, :, 6:7] > 0.5)
    return torch.where(keep, alpha, torch.zeros_like(alpha))


def render_binned(
    proj: Projected,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    bg: torch.Tensor,
    width: int,
    height: int,
    max_span: int = 4,
    capacity: int = 1024,
    chunk: int = 64,
):
    """Blend projected Gaussians through the tile pipeline -> (image
    (3, H, W), depth (1, H, W), alpha (1, H, W), num_cropped, num_overflow)."""
    chunk = min(chunk, capacity)
    dev = colors.device
    bins = compute_binning(proj.detach(), width, height, max_span)
    tiles_x, tiles_y = num_tiles(width, height)
    t = tiles_x * tiles_y
    px = TILE * TILE
    e = bins.sorted_gid.shape[0]

    gid = bins.sorted_gid
    valid_e = bins.entry_valid & proj.mask[gid]
    data_e = torch.stack(
        [
            proj.means2d[gid, 0], proj.means2d[gid, 1],
            proj.conics[gid, 0], proj.conics[gid, 1], proj.conics[gid, 2],
            opacities[gid], valid_e.to(torch.float32), torch.zeros_like(opacities[gid]),
        ],
        dim=-1,
    )  # (E, 8)
    feat_e = torch.stack([colors[gid, 0], colors[gid, 1], colors[gid, 2], proj.depths[gid]], dim=-1)  # (E, 4)

    # fixed-capacity per-tile entry indices, padded to whole chunks (a
    # clamped last chunk would otherwise blend entries twice)
    cap_pad = -(-capacity // chunk) * chunk
    k = torch.arange(cap_pad, device=dev)
    idx = torch.clamp(bins.tile_start.long()[:, None] + k[None, :], 0, max(e - 1, 0))
    in_range = k[None, :] < torch.clamp(bins.tile_count.long(), max=capacity)[:, None]
    num_overflow = torch.sum(torch.clamp(bins.tile_count - capacity, min=0)).to(torch.int32)

    tid = torch.arange(t, device=dev)
    p = torch.arange(px, device=dev)
    pix_x = ((tid % tiles_x)[:, None] * TILE + (p % TILE)[None, :]).to(torch.float32)
    pix_y = ((tid // tiles_x)[:, None] * TILE + (p // TILE)[None, :]).to(torch.float32)

    t_unfrozen = torch.ones((t, px), device=dev)
    t_frozen = torch.ones((t, px), device=dev)
    accum = torch.zeros((t, px, 4), device=dev)
    for c in range(-(-capacity // chunk)):
        sl = idx[:, c * chunk : (c + 1) * chunk]
        msk = in_range[:, c * chunk : (c + 1) * chunk]
        data = data_e[sl] * msk[..., None]  # (T, C, 8)
        feat = feat_e[sl]  # (T, C, 4)
        alpha = _chunk_alpha(pix_x, pix_y, data)
        t_incl_local = torch.cumprod(1.0 - alpha, dim=1)
        t_excl_local = torch.cat([torch.ones_like(t_incl_local[:, :1]), t_incl_local[:, :-1]], dim=1)
        t_incl = t_unfrozen[:, None, :] * t_incl_local
        t_excl = t_unfrozen[:, None, :] * t_excl_local
        keep = t_incl >= TRANSMITTANCE_MIN
        w = alpha * t_excl * keep
        accum = accum + torch.einsum("tcp,tcf->tpf", w, feat)
        t_unfrozen = t_incl[:, -1, :]
        t_frozen = torch.minimum(t_frozen, torch.amin(torch.where(keep, t_incl, torch.ones_like(t_incl)), dim=1))

    rgb_tiles = accum[:, :, :3] + t_frozen[:, :, None] * bg[None, None, :]

    def untile(x_tiles, channels):
        """(T, PX, C) -> (C, H, W)."""
        x = x_tiles.reshape(tiles_y, tiles_x, TILE, TILE, channels)
        x = x.permute(0, 2, 1, 3, 4).reshape(tiles_y * TILE, tiles_x * TILE, channels)
        return x[:height, :width].permute(2, 0, 1)

    image = untile(rgb_tiles, 3)
    depth = untile(accum[:, :, 3:4], 1)
    alpha = untile((1.0 - t_frozen)[..., None], 1)
    return image, depth, alpha, bins.num_cropped, num_overflow


def render_gaussians_tiled(
    rv: GaussianRenderVars,
    cam: Camera,
    bg: Optional[torch.Tensor] = None,
    means2d_offset: Optional[torch.Tensor] = None,
    max_span: int = 4,
    capacity: int = 1024,
    chunk: int = 64,
) -> RenderOutput:
    """One view through the tiled renderer (the oracle's contract), on the
    device of ``rv``'s tensors."""
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=rv.means3d.device)
    proj = project_gaussians(rv, cam, means2d_offset)
    image, depth, alpha, ncrop, nover = render_binned(
        proj, rv.colors, rv.opacities, bg, cam.width, cam.height, max_span=max_span, capacity=capacity, chunk=chunk
    )
    return RenderOutput(image=image, radii=proj.radii, depth=depth, alpha=alpha, num_cropped=ncrop,
                        num_overflow=nover)
