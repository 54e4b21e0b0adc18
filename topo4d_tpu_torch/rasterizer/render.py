"""The renderer front end (counterpart of ``rasterizer/pallas.py``).

project -> bin (fresh, on detached inputs) or take a frozen binning ->
pack -> tile blend -> composite the background -> untile, for one view
(``render_gaussians``) or for every view of a batched camera in one blend
launch on a tall canvas (``render_gaussians_multiview``). The binning is
not differentiated; gradients reach the Gaussians through the pack's
inverse gather and the projection.

Compact mode (``tile_capacity``, or a frozen binning that carries a compact
tile list): only the non-empty tiles are blended, and their rows are
scattered into a background template whose other rows composite to the
background (T_final 1). Non-empty tiles past the capacity are dropped and
counted in ``num_overflow``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from topo4d_tpu_torch.core.camera import Camera
from topo4d_tpu_torch.core.gaussian import GaussianRenderVars, project_gaussians
from topo4d_tpu_torch.parallel.mesh import AssembleRows, SumGradAcrossRanks
from topo4d_tpu_torch.rasterizer.blend import PX, tile_blend
from topo4d_tpu_torch.rasterizer.tiles import (
    TILE,
    Binning,
    compact_nonempty_tiles,
    compute_binning,
    num_tiles,
    pack_static_rows,
    pack_with_binning,
)


class RenderOutput(NamedTuple):
    image: torch.Tensor  # (3, H, W)
    radii: torch.Tensor  # (N,) int32
    depth: torch.Tensor  # (1, H, W)
    alpha: torch.Tensor  # (1, H, W)
    num_cropped: torch.Tensor  # () int32 Gaussians cropped to max_span^2 tiles
    num_overflow: Optional[torch.Tensor] = None  # () int32 tiles dropped by compact mode


class _ScatterTiles(torch.autograd.Function):
    """Compact rows (R, C >= 5, 256) -> the full (T, C, 256) canvas.

    Rows of global tile ids[r] < T are copied into a template whose other
    rows read T_final 1 (pure background, ``pallas.py:93``); padding rows
    (id T) land on a spare row that is cut off. The backward gathers the
    cotangent's rows back, zero for padding rows.
    """

    @staticmethod
    def forward(ctx, rows, ids, t: int):
        template = rows.new_zeros((t + 1,) + tuple(rows.shape[1:]))
        template[:, 4, :] = 1.0
        template.index_copy_(0, ids.long(), rows)
        ctx.save_for_backward(ids)
        return template[:t]

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        g_pad = torch.cat([g, g.new_zeros((1,) + g.shape[1:])], dim=0)
        return g_pad[ids.long()].contiguous(), None, None


def render_gaussians(
    rv: GaussianRenderVars,
    cam: Camera,
    bg: Optional[torch.Tensor] = None,
    means2d_offset: Optional[torch.Tensor] = None,
    max_span: int = 4,
    binning: Optional[Binning] = None,
    tile_capacity: Optional[int] = None,
    variant: str = "auto",
    tps: Optional[int] = None,
) -> RenderOutput:
    """Render one view (the contract of ``render_gaussians_pallas``).

    ``binning``: a frozen permutation from ``binning_for`` (its static rows
    and compact tile list are used when present). ``tile_capacity``: blend
    at most this many non-empty tiles (compact mode; implied by a frozen
    compact list). ``variant``: the blend kernels on the card, "auto",
    "resident" or "stream" for K1/K2 (the JAX package's K1/K2 and K3, one
    contract), "v3" for the window-span pair K4f/K4b, in full-canvas and
    compact mode alike; any other value raises ValueError. ``tps``: K4's
    rows per block (None: JAX's ``_tiles_per_step``, 4); K1/K2 ignore it,
    their block is one tile. Runs where ``rv``'s tensors live: the CUDA
    kernels on the card, the plain blend on the CPU under every variant.
    """
    dev = rv.means3d.device
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=dev)
    width, height = cam.width, cam.height
    proj = project_gaussians(rv, cam, means2d_offset)
    if binning is None:
        binning = compute_binning(proj.detach(), width, height, max_span)
    bins = pack_with_binning(proj, rv.colors, rv.opacities, binning)
    tiles_x, tiles_y = num_tiles(width, height)
    t = tiles_x * tiles_y
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if tile_capacity is None and binning.compact is not None:
        tile_capacity = binning.compact.ids.shape[0]
    if tile_capacity is not None and tile_capacity < t:
        compact = binning.compact
        if compact is None or compact.ids.shape[0] != tile_capacity:
            compact = compact_nonempty_tiles(bins.tile_start, bins.tile_count, tile_capacity)
        overflow = compact.overflow
        out_c = tile_blend(
            bins.packed, compact.start, compact.count, tiles_x, tiles_y, compact.ids, variant=variant, tps=tps
        )
        out = _ScatterTiles.apply(out_c, compact.ids, t)
    else:
        out = tile_blend(bins.packed, bins.tile_start, bins.tile_count, tiles_x, tiles_y, variant=variant, tps=tps)
    return _composite(out, bg, tiles_x, tiles_y, width, height, proj.radii, bins.num_cropped, overflow)


CAPPED_SPAN, CAPPED_ENTRIES = 4, 512  # JAX's render_gaussians_tiled(max_span=4, capacity=512)


def render_gaussians_capped(rv: GaussianRenderVars, cam: Camera) -> RenderOutput:
    """``render_gaussians`` at ``max_span`` ``CAPPED_SPAN`` with at most
    ``CAPPED_ENTRIES`` entries blended per tile, its first in depth order,
    the rest dropped: the contract of JAX's ``render_gaussians_tiled``
    (``rasterizer/tiled.py:201``) as the JAX package renders its synthetic
    targets, its validation datasets and its scorer. The cap acts where a
    view sees a surface edge-on. Blended by K1 on the card; no gradient."""
    with torch.no_grad():
        binning = compute_binning(project_gaussians(rv, cam), cam.width, cam.height, CAPPED_SPAN)
        binning = binning._replace(tile_count=torch.clamp(binning.tile_count, max=CAPPED_ENTRIES))
        return render_gaussians(rv, cam, max_span=CAPPED_SPAN, binning=binning)


def _composite(out, bg, tiles_x: int, tiles_y: int, width: int, height: int, radii, num_cropped, overflow):
    """Tile rows (T, C >= 5, 256) -> the view's RenderOutput: the
    background composited, untiled and cropped."""

    def untile(x):
        """(T, C, 256) -> (C, H, W)."""
        c = x.shape[1]
        x = x.reshape(tiles_y, tiles_x, c, TILE, TILE)
        x = x.permute(2, 0, 3, 1, 4).reshape(c, tiles_y * TILE, tiles_x * TILE)
        return x[:, :height, :width]

    return RenderOutput(
        image=untile(out[:, 0:3, :] + out[:, 4:5, :] * bg[None, :, None]),
        radii=radii,
        depth=untile(out[:, 3:4, :]),
        alpha=untile(1.0 - out[:, 4:5, :]),
        num_cropped=num_cropped,
        num_overflow=overflow,
    )


def render_gaussians_tile_sharded(
    rv: GaussianRenderVars,
    cam: Camera,
    bg: Optional[torch.Tensor] = None,
    max_span: int = 4,
    binning: Optional[Binning] = None,
    group=None,
) -> RenderOutput:
    """One view's render with its tiles sharded over the ranks of ``group``
    (the default process group: every rank), the contract of
    ``render_gaussians_pallas_tile_sharded`` (``pallas.py:335-470``).

    Projection, binning and pack run replicated on every rank. Rank r
    blends the contiguous block r of the tile rows through the blend
    (K1/K2 on the card): on the full canvas tiles ``r * tl .. r * tl + tl -
    1``, in compact mode (a frozen ``binning`` with a compact list) that
    slice of the list, padded with the sentinel id T and count 0 to ``tl``
    rows per rank. The blocks meet in an ``all_reduce`` (SUM) of
    zero-filled buffers of rows 0-4; each row has one writer, so the sum is
    exact. The backward blends the rank's own block (K2) and sums the
    packed entries' cotangents over the ranks, which holds each entry's on
    one rank. Forward and gradients equal the single render's in value.
    """
    dev = rv.means3d.device
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=dev)
    width, height = cam.width, cam.height
    proj = project_gaussians(rv, cam)
    if binning is None:
        binning = compute_binning(proj.detach(), width, height, max_span)
    bins = pack_with_binning(proj, rv.colors, rv.opacities, binning)
    tiles_x, tiles_y = num_tiles(width, height)
    t = tiles_x * tiles_y
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    compact = binning.compact
    if compact is not None:
        ids, starts, counts, overflow = compact.ids, compact.start, compact.count, compact.overflow
    else:
        ids = torch.arange(t, dtype=torch.int32, device=dev)
        starts, counts = bins.tile_start, bins.tile_count
        overflow = torch.zeros((), dtype=torch.int32, device=dev)
    rows = ids.shape[0]
    tl = -(-rows // world)  # rows per rank
    pad = world * tl - rows
    if pad:
        ids = torch.cat([ids, torch.full((pad,), t, dtype=torch.int32, device=dev)])
        starts = torch.cat([starts, torch.zeros(pad, dtype=torch.int32, device=dev)])
        counts = torch.cat([counts, torch.zeros(pad, dtype=torch.int32, device=dev)])
    block = slice(rank * tl, rank * tl + tl)
    packed = SumGradAcrossRanks.apply(bins.packed, group)
    local = tile_blend(packed, starts[block].contiguous(), counts[block].contiguous(), tiles_x, tiles_y,
                       ids[block].contiguous(), bucket_counts=counts)
    out = AssembleRows.apply(local[:, :5], rank * tl, world * tl, group)[:rows]
    if compact is not None:
        out = _ScatterTiles.apply(out, compact.ids, t)
    return _composite(out, bg, tiles_x, tiles_y, width, height, proj.radii, bins.num_cropped, overflow)


def render_gaussians_multiview(
    rv: GaussianRenderVars,
    cams: Camera,
    bg: Optional[torch.Tensor] = None,
    max_span: int = 4,
    tile_capacity: Optional[int] = None,
    variant: str = "auto",
) -> RenderOutput:
    """Every view of the batched camera ``cams`` in one blend launch (the
    contract of ``render_gaussians_pallas_multiview``,
    ``pallas.py:192-332``).

    Each view is projected, binned afresh and packed; then the views stand
    on a tall canvas of V * tiles_y tile rows: view v's packed y row moves
    down by v * tiles_y * 16 pixels (a float32 add, which rounds as JAX's
    does), its tile-id row by v * T (its invalid sentinel T becomes -2,
    which matches no tile), its entry ranges by v * E_pad, and the entries
    are concatenated. Views share no tile, so one ``tile_blend`` over the
    V * T tiles gives each view its own render. ``tile_capacity``: compact
    mode across all views (non-empty tiles past it dropped and counted in
    ``num_overflow``). The outputs have a leading view axis: images (V, 3,
    H, W), radii (V, N); ``num_cropped`` is the sum over the views.
    """
    dev = rv.means3d.device
    if bg is None:
        bg = torch.zeros(3, dtype=torch.float32, device=dev)
    width, height = cams.width, cams.height
    v = int(cams.fx.shape[0])
    tiles_x, tiles_y = num_tiles(width, height)
    t = tiles_x * tiles_y
    packed, starts, counts, radii, cropped = [], [], [], [], []
    for i in range(v):
        proj = project_gaussians(rv, cams[i])
        bins = pack_with_binning(proj, rv.colors, rv.opacities, compute_binning(proj.detach(), width, height, max_span))
        e_pad = bins.packed.shape[1]
        tile_row = bins.packed[6:7]
        tile_row = torch.where(
            tile_row >= float(t), torch.full_like(tile_row, -2.0), torch.where(tile_row >= 0.0, tile_row + float(i * t), tile_row)
        )
        y_off = torch.tensor(float(i * tiles_y * TILE), dtype=torch.float32, device=dev)
        packed.append(torch.cat([bins.packed[0:1], bins.packed[1:2] + y_off, bins.packed[2:6], tile_row, bins.packed[7:]]))
        starts.append(bins.tile_start + i * e_pad)
        counts.append(bins.tile_count)
        radii.append(proj.radii)
        cropped.append(bins.num_cropped)
    packed = torch.cat(packed, dim=1)
    tile_start, tile_count = torch.cat(starts), torch.cat(counts)
    t_all = v * t
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if tile_capacity is not None and tile_capacity < t_all:
        compact = compact_nonempty_tiles(tile_start, tile_count, tile_capacity)
        overflow = compact.overflow
        out_c = tile_blend(packed, compact.start, compact.count, tiles_x, v * tiles_y, compact.ids, variant=variant)
        out = _ScatterTiles.apply(out_c, compact.ids, t_all)
    else:
        out = tile_blend(packed, tile_start, tile_count, tiles_x, v * tiles_y, variant=variant)
    out = out.reshape(v, t, 8, PX)

    def untile(x):
        """(V, T, C, 256) -> (V, C, H, W)."""
        c = x.shape[2]
        x = x.reshape(v, tiles_y, tiles_x, c, TILE, TILE)
        x = x.permute(0, 3, 1, 4, 2, 5).reshape(v, c, tiles_y * TILE, tiles_x * TILE)
        return x[:, :, :height, :width]

    return RenderOutput(
        image=untile(out[:, :, 0:3, :] + out[:, :, 4:5, :] * bg[None, None, :, None]),
        radii=torch.stack(radii),
        depth=untile(out[:, :, 3:4, :]),
        alpha=untile(1.0 - out[:, :, 4:5, :]),
        num_cropped=torch.sum(torch.stack(cropped)).to(torch.int32),
        num_overflow=overflow,
    )


@torch.no_grad()
def attach_compact(binning: Binning, capacity: int) -> Binning:
    """Freeze a compact tile list of ``capacity`` rows onto ``binning``
    (the trainer's auto capacity); at or above the canvas size compact mode
    stays off and the binning is returned as it is."""
    if capacity >= binning.tile_count.shape[0]:
        return binning
    return binning._replace(compact=compact_nonempty_tiles(binning.tile_start, binning.tile_count, capacity))


@torch.no_grad()
def binning_for(
    rv: GaussianRenderVars,
    cam: Camera,
    max_span: int = 4,
    with_static: bool = False,
    tile_capacity: Optional[int] = None,
) -> Binning:
    """The reusable frozen binning of the current geometry for one view.

    ``with_static`` (dense texture loop): also capture the frame-constant
    packed rows (``pack_static_rows``), so each step gathers only the
    learned conic and color rows. ``tile_capacity``: also freeze the
    compact list of non-empty tiles (below the canvas size).
    """
    proj = project_gaussians(rv, cam).detach()
    b = compute_binning(proj, cam.width, cam.height, max_span)
    if with_static:
        b = b._replace(static_rows=pack_static_rows(proj, rv.opacities.detach(), b))
    if tile_capacity is not None:
        b = attach_compact(b, tile_capacity)
    return b
