"""Duplicate-and-sort tile binning and entry packing (rasterizer/tiles.py).

Each Gaussian is duplicated into ``max_span``^2 (tile, depth-rank) entries
(cropped to its top-left ``max_span`` x ``max_span`` tile sub-rect and
counted in ``num_cropped`` when its rect is larger), entries are sorted by
(tile, stable depth rank), and each tile blends its contiguous range.

The dense texture loop freezes a view's binning for a frame: the packed
rows that stay constant there can be captured once (``pack_static_rows``,
the split pack), and so can the list of non-empty tiles that compact mode
blends (``compact_nonempty_tiles``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from topo4d_tpu_torch.core.gaussian import Projected

TILE = 16  # pixels per tile side
PACK_FIELDS = 16  # rows of the transposed packed-entry layout
PACK_CHUNK = 128  # tail padding quantum of the packed layout


class CompactTiles(NamedTuple):
    """The non-empty tiles of a frozen binning (``compact_nonempty_tiles``)."""

    ids: torch.Tensor  # (capacity,) int32 global tile ids (T = padding row)
    start: torch.Tensor  # (capacity,) int32
    count: torch.Tensor  # (capacity,) int32
    overflow: torch.Tensor  # () int32 non-empty tiles past the capacity


class Binning(NamedTuple):
    """The entry permutation + tile ranges of one view (values-free)."""

    sorted_gid: torch.Tensor  # (E,) int64 entry -> gaussian id
    sorted_tile: torch.Tensor  # (E,) int64 entry -> tile id (T = invalid)
    entry_valid: torch.Tensor  # (E,) bool
    tile_start: torch.Tensor  # (T,) int32
    tile_count: torch.Tensor  # (T,) int32
    num_cropped: torch.Tensor  # () int32
    inv_positions: torch.Tensor  # (N, R) int64: each gaussian's R entry slots
    # split pack: the frame-constant packed rows [x, y, opacity, tile, depth,
    # zero], captured at binning time (``pack_static_rows``)
    static_rows: Optional[torch.Tensor] = None  # (6, E_pad) float32
    # frozen compact-mode tile list; its length is the capacity
    compact: Optional[CompactTiles] = None


class TileBins(NamedTuple):
    """Sorted entries and per-tile ranges (``bin_gaussians``)."""

    gauss_id: torch.Tensor  # (E,) int32 gaussian of each sorted entry
    entry_valid: torch.Tensor  # (E,) bool
    tile_start: torch.Tensor  # (T,) int32 first entry of each tile
    tile_count: torch.Tensor  # (T,) int32 entries of each tile
    num_cropped: torch.Tensor  # () int32 gaussians whose tile rect was cropped


class PackedBins(NamedTuple):
    """Depth-sorted per-tile entry ranges with packed per-entry data.

    packed layout (PACK_FIELDS, E_pad):
      0:x 1:y 2:conic_a 3:conic_b 4:conic_c 5:opacity 6:tile_id 7:0
      8:r 9:g 10:b 11:depth 12..15:0, tail padded with -1.
    """

    packed: torch.Tensor
    tile_start: torch.Tensor
    tile_count: torch.Tensor
    num_cropped: torch.Tensor


def num_tiles(width: int, height: int):
    """(tiles_x, tiles_y) for an image size."""
    return -(-width // TILE), -(-height // TILE)


def tile_rect(proj: Projected, width: int, height: int):
    """Per-Gaussian touched tile rect [x0, x1) x [y0, y1) (CUDA getRect)."""
    tiles_x, tiles_y = num_tiles(width, height)
    r = proj.radii.to(torch.float32)
    mx = proj.means2d[:, 0]
    my = proj.means2d[:, 1]
    x0 = torch.clamp(torch.floor((mx - r) / TILE), 0, tiles_x).to(torch.int64)
    y0 = torch.clamp(torch.floor((my - r) / TILE), 0, tiles_y).to(torch.int64)
    x1 = torch.clamp(torch.floor((mx + r + TILE - 1) / TILE), 0, tiles_x).to(torch.int64)
    y1 = torch.clamp(torch.floor((my + r + TILE - 1) / TILE), 0, tiles_y).to(torch.int64)
    zero = torch.zeros_like(x0)
    m = proj.mask
    return (
        torch.where(m, x0, zero), torch.where(m, y0, zero),
        torch.where(m, x1, zero), torch.where(m, y1, zero),
        tiles_x, tiles_y,
    )


def depth_sorted_order(proj: Projected) -> torch.Tensor:
    """Front-to-back Gaussian order: stable sort by view z, culled last."""
    key = torch.where(proj.mask, proj.depths, torch.full_like(proj.depths, float("inf")))
    return torch.argsort(key, stable=True)


def _binning_keys(proj: Projected, width: int, height: int, max_span: int):
    """-> (flat_tile (N*R,), flat_rank (N*R,), order (N,), num_cropped, T)."""
    n = proj.means2d.shape[0]
    dev = proj.means2d.device
    x0, y0, x1, y1, tiles_x, tiles_y = tile_rect(proj, width, height)
    span_w = x1 - x0
    span_h = y1 - y0
    cropped = (span_w > max_span) | (span_h > max_span)
    num_cropped = torch.sum(cropped & proj.mask).to(torch.int32)

    r = max_span * max_span
    k = torch.arange(r, device=dev)
    di = k // max_span
    dj = k % max_span
    ty = y0[:, None] + di[None, :]
    tx = x0[:, None] + dj[None, :]
    valid = proj.mask[:, None] & (di[None, :] < span_h[:, None]) & (dj[None, :] < span_w[:, None])
    t = tiles_x * tiles_y
    tile_id = torch.where(valid, ty * tiles_x + tx, torch.full_like(tx, t))

    order = depth_sorted_order(proj)
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(n, device=dev)
    flat_tile = tile_id.reshape(-1)
    flat_rank = rank[:, None].expand(n, r).reshape(-1)
    return flat_tile, flat_rank, order, num_cropped, t


def _tile_ranges(sorted_tile: torch.Tensor, t: int):
    ids = torch.arange(t, device=sorted_tile.device, dtype=sorted_tile.dtype)
    start = torch.searchsorted(sorted_tile, ids, right=False)
    end = torch.searchsorted(sorted_tile, ids, right=True)
    return start.to(torch.int32), (end - start).to(torch.int32)


@torch.no_grad()
def compute_binning(proj: Projected, width: int, height: int, max_span: int = 4) -> Binning:
    """Duplicate-and-sort once; returns the permutation and tile ranges.

    One sort of the fused int64 key tile * N + depth_rank: keys are unique
    per (tile, gaussian), so this equals the stable lexicographic order.
    """
    n = proj.means2d.shape[0]
    flat_tile, flat_rank, order, num_cropped, t = _binning_keys(
        proj, width, height, max_span
    )
    sorted_key, _ = torch.sort(flat_tile * n + flat_rank, stable=True)
    sorted_tile = sorted_key // n
    sorted_rank = sorted_key - sorted_tile * n
    tile_start, tile_count = _tile_ranges(sorted_tile, t)
    sorted_gid = order[sorted_rank]
    # every gaussian owns exactly R sorted slots: the stable argsort by id
    # lists them, giving the dense inverse of the permutation
    inv = torch.argsort(sorted_gid, stable=True)
    return Binning(
        sorted_gid=sorted_gid,
        sorted_tile=sorted_tile,
        entry_valid=sorted_tile < t,
        tile_start=tile_start,
        tile_count=tile_count,
        num_cropped=num_cropped,
        inv_positions=inv.reshape(n, max_span * max_span),
    )


def bin_gaussians(proj: Projected, width: int, height: int, max_span: int = 4) -> TileBins:
    """The duplicate-and-sort binning as sorted entries and tile ranges: a
    Gaussian spanning more than ``max_span`` tiles on an axis is cropped to
    its top-left ``max_span`` x ``max_span`` tiles and counted."""
    b = compute_binning(proj, width, height, max_span)
    return TileBins(
        gauss_id=b.sorted_gid.to(torch.int32), entry_valid=b.entry_valid, tile_start=b.tile_start,
        tile_count=b.tile_count, num_cropped=b.num_cropped,
    )


def bin_gaussians_packed(
    proj: Projected,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    width: int,
    height: int,
    max_span: int = 4,
    chunk: int = PACK_CHUNK,
) -> PackedBins:
    """The binning with every entry's fields packed (``PackedBins``), tail
    padded with -1 by (-E) % ``chunk`` + ``chunk`` columns (``chunk`` a
    multiple of 128): ``compute_binning`` then ``pack_with_binning``, whose
    backward folds the entries' gradients back to the Gaussians by a gather.
    Invalid entries (tile T) carry zeros where the JAX package's carry the
    sorted data; no blend reads them."""
    if chunk % PACK_CHUNK:
        raise ValueError(f"chunk must be a multiple of {PACK_CHUNK}")
    bins = pack_with_binning(proj, colors, opacities, compute_binning(proj, width, height, max_span))
    if chunk != PACK_CHUNK:
        e = proj.means2d.shape[0] * max_span * max_span
        packed = torch.nn.functional.pad(bins.packed[:, :e], (0, (-e) % chunk + chunk), value=-1.0)
        bins = bins._replace(packed=packed)
    return bins


class _GatherEntries(torch.autograd.Function):
    """(10, N) fields -> (10, E) sorted-entry rows (invalid entries zeroed).

    The backward folds entry gradients back to Gaussians as a dense gather
    along ``inv_positions`` summed over each Gaussian's R slots, not as a
    scatter-add (``index_add_``) over E entries.
    """

    @staticmethod
    def forward(ctx, fields, sorted_gid, entry_valid, inv_positions):
        rows = fields[:, sorted_gid]
        ctx.save_for_backward(entry_valid, inv_positions)
        return torch.where(entry_valid[None, :], rows, torch.zeros_like(rows))

    @staticmethod
    def backward(ctx, g):
        entry_valid, inv = ctx.saved_tensors
        return fold_entry_grads(g, entry_valid, inv), None, None, None


def fold_entry_grads(g: torch.Tensor, entry_valid: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """(C, E) per-entry gradients -> (C, N) per-Gaussian sums (dense gather-sum)."""
    gv = torch.where(entry_valid[None, :], g, torch.zeros_like(g))
    return gv[:, inv.reshape(-1)].reshape(g.shape[0], *inv.shape).sum(dim=-1)


# packed rows carrying the ten differentiable per-Gaussian fields
FIELD_ROWS = (0, 1, 2, 3, 4, 5, 8, 9, 10, 11)


def _pad_entries(rows: torch.Tensor) -> torch.Tensor:
    """Tail-pad (C, E) entry rows with -1 to the packed layout's E_pad."""
    e = rows.shape[1]
    return torch.nn.functional.pad(rows, (0, (-e) % PACK_CHUNK + PACK_CHUNK), value=-1.0)


@torch.no_grad()
def pack_static_rows(proj: Projected, opacities: torch.Tensor, binning: Binning) -> torch.Tensor:
    """The frame-constant packed rows of the dense split pack -> (6, E_pad).

    In the texture loop only colors and rotations learn (train.py:281-286):
    means2d, depth and opacity are frame constants, like the frozen binning
    itself. Rows [x, y, opacity, tile, depth, zero], padded like the full
    pack; captured from the binning's own projection, so they may differ
    from a step's by an ulp.
    """
    fields = torch.stack([proj.means2d[:, 0], proj.means2d[:, 1], opacities, proj.depths], dim=0)
    rows = fields[:, binning.sorted_gid]
    rows = torch.where(binning.entry_valid[None, :], rows, torch.zeros_like(rows))
    tile_row = binning.sorted_tile.to(torch.float32)[None, :]
    zero = rows.new_zeros((1, rows.shape[1]))
    return _pad_entries(torch.cat([rows[0:2], rows[2:3], tile_row, rows[3:4], zero], dim=0))


def pack_with_binning(
    proj: Projected,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    binning: Binning,
) -> PackedBins:
    """Pack the current values along ``binning``'s permutation: one gather.

    With ``binning.static_rows`` (the dense split pack) only the six learned
    rows, conics and colors, are gathered; the frozen fields take no
    gradient.
    """
    if binning.static_rows is not None:
        learned = torch.stack(
            [proj.conics[:, 0], proj.conics[:, 1], proj.conics[:, 2], colors[:, 0], colors[:, 1], colors[:, 2]],
            dim=0,
        )  # (6, N)
        rows6 = _pad_entries(
            _GatherEntries.apply(learned, binning.sorted_gid, binning.entry_valid, binning.inv_positions)
        )
        s = binning.static_rows
        zero = s[5:6]
        packed = torch.cat(
            [s[0:2], rows6[0:3], s[2:3], s[3:4], zero, rows6[3:6], s[4:5], zero, zero, zero, zero], dim=0
        )  # (16, E_pad)
        return PackedBins(
            packed=packed, tile_start=binning.tile_start, tile_count=binning.tile_count,
            num_cropped=binning.num_cropped,
        )
    fields = torch.stack(
        [
            proj.means2d[:, 0], proj.means2d[:, 1],
            proj.conics[:, 0], proj.conics[:, 1], proj.conics[:, 2],
            opacities,
            colors[:, 0], colors[:, 1], colors[:, 2],
            proj.depths,
        ],
        dim=0,
    )  # (10, N)
    rows10 = _GatherEntries.apply(
        fields, binning.sorted_gid, binning.entry_valid, binning.inv_positions
    )
    e = rows10.shape[1]
    zeros = rows10.new_zeros((1, e))
    packed = torch.cat(
        [
            rows10[0:6],
            binning.sorted_tile.to(torch.float32)[None, :],
            zeros,
            rows10[6:10],
            rows10.new_zeros((4, e)),
        ],
        dim=0,
    )  # (16, E)
    packed = _pad_entries(packed)
    return PackedBins(
        packed=packed,
        tile_start=binning.tile_start,
        tile_count=binning.tile_count,
        num_cropped=binning.num_cropped,
    )


@torch.no_grad()
def compact_nonempty_tiles(tile_start: torch.Tensor, tile_count: torch.Tensor, capacity: int) -> CompactTiles:
    """The non-empty tiles in ascending id order, at most ``capacity`` of them.

    Row i describes global tile ids[i]; padding rows carry the sentinel id
    T and count 0. Non-empty tiles past the capacity are dropped and
    counted in ``overflow`` (the caller must surface it).
    """
    t = tile_count.shape[0]
    if not 0 < capacity <= t:
        raise ValueError(f"capacity must be in [1, {t}], got {capacity}")
    nonempty = tile_count > 0
    m = torch.sum(nonempty.to(torch.int32))
    # a stable sort on the "empty" flag keeps the non-empty ids ascending in front
    order = torch.argsort((~nonempty).to(torch.int32), stable=True)[:capacity]
    valid = torch.arange(capacity, device=tile_count.device) < m
    zero = torch.zeros_like(tile_start[order])
    return CompactTiles(
        ids=torch.where(valid, order, torch.full_like(order, t)).to(torch.int32),
        start=torch.where(valid, tile_start[order], zero).to(torch.int32),
        count=torch.where(valid, tile_count[order], zero).to(torch.int32),
        overflow=torch.clamp(m - capacity, min=0).to(torch.int32),
    )
