"""The work of the tile blend's forward and backward entries (the port's
K1 and K2, ``rasterizer/blend.py`` ``tile_blend_fwd_cuda`` and
``tile_blend_bwd_cuda``) for one view: what these inputs need, whichever
kernel serves the entry.

Counted with the benchmark's own renderer (``reference/render.py``) from
the view's binning (its tiles' entry lists) and the Gaussians' pixel
centres, conics and opacities:

- a pixel evaluates its tile's entries up to and including the one that
  stops it (all of them if none does); a pair contributes when its alpha
  passes the skip rules before the stop; the backward visits each pixel's
  entries up to its last contributor;
- FP32 operations per pair: 16 for each pair evaluated and 11 more for each
  contributing one in the forward; 16 for each pair the backward visits
  without a contribution and 55 for each contributing one;
- bytes: each entry's ten float32 fields (position, conic, opacity,
  colour, depth) read once, as far into its tile's list as the furthest
  pixel goes, and in the backward its gradient written once; each
  occupied tile's start and count; the forward writes the tile's colour,
  depth and final transmittance (5 values a pixel) once; the backward
  reads the output's gradient of those 5 and the final transmittance.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference import render as R

from .peaks import bound_s

FWD_FLOPS_EVAL, FWD_FLOPS_CONTRIB = 16, 11
BWD_FLOPS_VISIT, BWD_FLOPS_CONTRIB = 16, 55
ENTRY_BYTES = 10 * 4
RANGE_BYTES = 2 * 4
PIXELS = R.TILE * R.TILE


@dataclasses.dataclass
class ViewWork:
    evaluated: int = 0  # pairs the forward evaluates
    contributing: int = 0  # pairs drawn
    visited: int = 0  # pairs the backward visits
    fwd_entries: int = 0  # entries the forward reads
    bwd_entries: int = 0  # entries the backward reads
    tiles: int = 0  # occupied tiles

    def fwd_bound_s(self) -> float:
        nbytes = self.fwd_entries * ENTRY_BYTES + self.tiles * (RANGE_BYTES + 5 * 4 * PIXELS)
        return bound_s(nbytes, FWD_FLOPS_EVAL * self.evaluated + FWD_FLOPS_CONTRIB * self.contributing)

    def bwd_bound_s(self) -> float:
        nbytes = 2 * self.bwd_entries * ENTRY_BYTES + self.tiles * (RANGE_BYTES + 6 * 4 * PIXELS)
        flops = BWD_FLOPS_VISIT * (self.visited - self.contributing) + BWD_FLOPS_CONTRIB * self.contributing
        return bound_s(nbytes, flops)


@torch.no_grad()
def view_work(bins: R.Bins, xy, conic, opacity) -> ViewWork:
    w = ViewWork()
    for tiles, m in R.chunks(bins):
        alpha, _, valid = R.tile_alpha(bins, tiles, m, xy, conic, opacity)
        count = valid.sum(-1)[:, None]  # (R, 1)
        stopped = torch.cumprod(1.0 - alpha, -1) < R.T_MIN
        j = torch.arange(1, m + 1, device=alpha.device)
        reach = torch.where(stopped.any(-1), stopped.to(torch.int64).argmax(-1) + 1, count)
        drawn = (alpha > 0) & ~stopped
        last = torch.amax(drawn * j, -1)
        w.evaluated += int(reach.sum())
        w.contributing += int(drawn.sum())
        w.visited += int(last.sum())
        w.fwd_entries += int(reach.amax(-1).sum())
        w.bwd_entries += int(last.amax(-1).sum())
        w.tiles += int(tiles.shape[0])
    return w
