"""The tiled UV z-buffer bake: CUDA kernel K6 and its plain PyTorch version.

Counterpart of ``topo4d_tpu/texture/bake_pallas.py``. The host bins the
triangles into (16 x 16 tile, triangle id) entries sorted by tile, then by
id (``compute_bake_binning``); the bake walks each occupied tile's entries
in ascending id order. For each pixel centre (px, py) it takes the
Gram/Cramer barycentrics (u, w1, w0 = 1 - u - w1, with ``inv = 0`` when the
denominator is 0), the inner bbox ``ceil(min)..floor(max)`` of the float32
corners, the inclusive inside test ``u >= 0, w1 >= 0, w1 + u <= 1`` within
the bbox and the canvas, and the depth ``w0 z0 + w1 z1 + u z2``. A bigger z
wins and, on equal z, the first triangle (the scanline renderer's strict
``>``); the color is interpolated with the same weights; a pixel no triangle
covers stays 0. These are the semantics of the reference's scanline
renderer (face3d/mesh_numpy/render.py): integer pixel centres, the inner
bbox, the inclusive-edge inside test, bigger z wins.

The binning is a sequence constant (the UV layout does not change between
frames), so ``BakeBinning`` keeps its geometry rows, corner color indices
and compact tile map on the device and each frame only gathers colors.
Unlike the TPU version it keeps the exact entry and tile counts: there is
no padding for recompile reuse or DMA windows. It also lists the tiles
with no entry, which K6 writes as zeros, so the canvas needs no fill.

Dispatch: ``bake_canvas`` sends a CUDA tensor to ``csrc/bake.cu`` (K6) or
raises; a CPU tensor goes to ``bake_canvas_plain``, which is also the
kernel's oracle on the card. ``LAUNCHES`` counts kernel launches and plain
calls. ``bake_warp_cull_plain`` mirrors K6's per-warp cull and
``bake_inside_plain`` gives the contract's inside test per (entry, pixel),
for the tests and chip_smoke.py's counts; no bake calls them.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from topo4d_tpu_torch import kernels
from topo4d_tpu_torch.device import resolve_device

TILE = 16
PX = TILE * TILE
WARP_W = 8  # K6's warps each own an 8 x 8 pixel block of a tile
PLAIN_ENTRIES_PER_CHUNK = 1 << 16  # the plain version's (entry, pixel) pairs are made this many entries at a time
_NEG = -1e30  # the depth of "no triangle" (the TPU kernel's z-buffer fill)

# launches of the kernel and calls of the plain version, since the last reset
LAUNCHES: Dict[str, int] = {"uv_bake": 0, "uv_bake_plain": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def process_uv(uv_coords: np.ndarray, uv_h: int, uv_w: int) -> np.ndarray:
    """UVs -> pixel coords with the V flip and a zero z (reference
    helpers.py:945-950), float64 (V, 3)."""
    out = np.array(uv_coords, np.float64, copy=True)
    out[:, 0] = out[:, 0] * (uv_w - 1)
    out[:, 1] = out[:, 1] * (uv_h - 1)
    out[:, 1] = uv_h - out[:, 1] - 1
    return np.hstack([out, np.zeros((out.shape[0], 1))])


class BakeBinning(NamedTuple):
    """A per-sequence bake binning, on the device of its tensors.

    ``geom`` rows are, per sorted entry, the corners' x0, y0, x1, y1, x2, y2,
    their depths z0, z1, z2 and the entry's tile id (exact in float32 up to
    2^24 tiles). ``corner_idx[k, e]`` is the color row of corner k of entry
    e; built with a ``corner_map`` it already composes the UV-slot -> vertex
    re-indexing, so a frame gathers straight from the per-vertex colors.
    Occupied tile ``tile_ids[i]`` owns entries ``start[i] .. start[i] +
    count[i] - 1``; ``empty_ids`` lists the canvas's other tiles.
    """

    geom: torch.Tensor  # (10, E) float32
    corner_idx: torch.Tensor  # (3, E) int32
    tile_ids: torch.Tensor  # (M,) int32, ascending
    start: torch.Tensor  # (M,) int32
    count: torch.Tensor  # (M,) int32
    empty_ids: torch.Tensor  # (tiles_x * tiles_y - M,) int32, ascending
    tiles_x: int
    tiles_y: int


def _bin_core(verts_px: np.ndarray, tris: np.ndarray, height: int, width: int):
    """Host binning: geometry rows and corner ids, no colors.

    Returns (geom (10, E) float32, fe (E, 3) sorted-entry corner indices,
    tile_ids, start, count, tiles_x, tiles_y).
    """
    v = np.asarray(verts_px, np.float32)
    f = np.asarray(tris, np.int64)
    tiles_x = -(-width // TILE)
    tiles_y = -(-height // TILE)

    tx = v[:, 0][f]  # (F, 3)
    ty = v[:, 1][f]
    umin = np.ceil(tx.min(1))
    umax = np.floor(tx.max(1))
    vmin = np.ceil(ty.min(1))
    vmax = np.floor(ty.max(1))
    # clamp to the canvas and cull empty bboxes
    umin_c = np.maximum(umin, 0)
    umax_c = np.minimum(umax, width - 1)
    vmin_c = np.maximum(vmin, 0)
    vmax_c = np.minimum(vmax, height - 1)
    keep = (umax_c >= umin_c) & (vmax_c >= vmin_c)

    tx0 = (umin_c // TILE).astype(np.int64)
    tx1 = (umax_c // TILE).astype(np.int64)
    ty0 = (vmin_c // TILE).astype(np.int64)
    ty1 = (vmax_c // TILE).astype(np.int64)
    span_x = np.where(keep, tx1 - tx0 + 1, 0)
    span_y = np.where(keep, ty1 - ty0 + 1, 0)
    counts = (span_x * span_y).astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(counts)])
    e = int(offs[-1])

    # expand (triangle, tile) pairs, then sort by (tile, triangle)
    tri_of = np.repeat(np.arange(f.shape[0]), counts)
    local = np.arange(e) - offs[tri_of]
    sx = span_x[tri_of]
    tile_ids = (ty0[tri_of] + local // sx) * tiles_x + (tx0[tri_of] + local % sx)
    order = np.lexsort((tri_of, tile_ids))
    s_tile = tile_ids[order]
    s_tri = tri_of[order]

    occupied, start = np.unique(s_tile, return_index=True)
    count = np.diff(np.concatenate([start, [e]]))

    fe = f[s_tri]
    geom = np.empty((10, e), np.float32)
    for k in range(3):
        geom[2 * k] = v[:, 0][fe[:, k]]
        geom[2 * k + 1] = v[:, 1][fe[:, k]]
        geom[6 + k] = v[:, 2][fe[:, k]]
    geom[9] = s_tile.astype(np.float32)
    return (geom, fe, occupied.astype(np.int32), start.astype(np.int32), count.astype(np.int32),
            tiles_x, tiles_y)


ROWS = 24  # rows of the JAX package's packed layout (``bin_triangles_np``)


def bin_triangles_np(
    verts_px: np.ndarray,  # (V, 3) pixel-space uv coords + z
    tris: np.ndarray,  # (F, 3) int
    colors: np.ndarray,  # (V, C >= 3)
    height: int,
    width: int,
    chunk: int = 128,
    e_round: int = 1 << 17,
    m_round: int = 8192,
):
    """The host binning in the JAX package's packed layout -> (packed (24,
    E_pad) float32, tmap (M_pad,) int32, start, count, tiles_x, tiles_y, m).

    Rows 0-5 the corners' x, y; 6-8 their depths; 9-17 their colors (3
    channels per corner); 18 the tile id; the rest and the padding -1.
    Occupied tile ``tmap[i]`` owns entries ``start[i] .. start[i] + count[i]
    - 1`` for i < m; padding rows name tile tiles_x * tiles_y. E_pad and
    M_pad round up to ``e_round`` (past E + ``chunk``) and ``m_round``.
    """
    geom, fe, tile_ids, start, count, tiles_x, tiles_y = _bin_core(verts_px, tris, height, width)
    e, m = geom.shape[1], tile_ids.size
    e_pad = max(-(-(e + chunk) // e_round) * e_round, e_round)
    packed = np.full((ROWS, e_pad), -1.0, np.float32)
    packed[0:9, :e] = geom[0:9]
    packed[18, :e] = geom[9]
    c = np.asarray(colors, np.float32)
    for k in range(3):
        for ch in range(3):
            packed[9 + 3 * k + ch, :e] = c[:, ch][fe[:, k]]
    m_pad = max(-(-m // m_round) * m_round, m_round)
    tmap = np.full(m_pad, tiles_x * tiles_y, np.int32)
    tmap[:m] = tile_ids
    start_a = np.zeros(m_pad, np.int32)
    start_a[:m] = start
    count_a = np.zeros(m_pad, np.int32)
    count_a[:m] = count
    return packed, tmap, start_a, count_a, tiles_x, tiles_y, m


def compute_bake_binning(
    verts_px: np.ndarray,
    tris: np.ndarray,
    height: int,
    width: int,
    corner_map: Optional[np.ndarray] = None,
    device="cuda",
) -> BakeBinning:
    """Bin once per sequence on the host; the result lives on ``device``.

    ``corner_map`` (U,) int composes a UV-slot -> color-row re-indexing into
    the cached corner ids.
    """
    dev = resolve_device(device)
    geom, fe, tile_ids, start, count, tiles_x, tiles_y = _bin_core(verts_px, tris, height, width)
    if corner_map is not None:
        fe = np.asarray(corner_map, np.int64)[fe]
    empty_ids = np.setdiff1d(np.arange(tiles_x * tiles_y, dtype=np.int32), tile_ids, assume_unique=True)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return BakeBinning(
        geom=t(geom), corner_idx=t(fe.T.astype(np.int32)), tile_ids=t(tile_ids), start=t(start),
        count=t(count), empty_ids=t(empty_ids.astype(np.int32)), tiles_x=tiles_x, tiles_y=tiles_y,
    )


def _pair_terms(gs, tiles_x: int):
    """The kernel's terms for a chunk of entries ``gs`` (10, n, 1) at the 256
    pixels of each entry's tile, in its operation order -> (pxi, pyi (n,
    256) int64, u, w1, w0, depth, inside (n, 256)); ``inside`` is the
    contract's test (barycentric and inner bbox), without the canvas."""
    x0, y0, x1, y1, x2, y2, z0, z1, z2, tile = gs
    p = torch.arange(PX, device=gs.device)
    tile_i = tile.to(torch.int64)
    pxi = (tile_i % tiles_x) * TILE + p % TILE  # (n, 256)
    pyi = (tile_i // tiles_x) * TILE + p // TILE
    px, py = pxi.to(torch.float32), pyi.to(torch.float32)
    # per-entry terms, as the kernel stages them
    v0x, v0y = x2 - x0, y2 - y0
    v1x, v1y = x1 - x0, y1 - y0
    dot00 = v0x * v0x + v0y * v0y
    dot01 = v0x * v1x + v0y * v1y
    dot11 = v1x * v1x + v1y * v1y
    denom = dot00 * dot11 - dot01 * dot01
    inv = torch.where(denom == 0.0, torch.zeros_like(denom), 1.0 / denom)
    umin, umax, vmin, vmax = _inner_bbox(gs)
    # per-pair terms
    dpx, dpy = px - x0, py - y0
    dot02 = v0x * dpx + v0y * dpy
    dot12 = v1x * dpx + v1y * dpy
    u = (dot11 * dot02 - dot01 * dot12) * inv
    w1 = (dot00 * dot12 - dot01 * dot02) * inv
    w0 = 1.0 - u - w1
    depth = w0 * z0 + w1 * z1 + u * z2
    inside = (u >= 0) & (w1 >= 0) & (w1 + u <= 1.0) & (px >= umin) & (px <= umax) & (py >= vmin) & (py <= vmax)
    return pxi, pyi, u, w1, w0, depth, inside


def _inner_bbox(g):
    """(umin, umax, vmin, vmax): ceil(min) .. floor(max) of the corners of
    geometry rows ``g`` (10, ...)."""
    x0, y0, x1, y1, x2, y2 = g[:6]
    return (
        torch.ceil(torch.minimum(torch.minimum(x0, x1), x2)), torch.floor(torch.maximum(torch.maximum(x0, x1), x2)),
        torch.ceil(torch.minimum(torch.minimum(y0, y1), y2)), torch.floor(torch.maximum(torch.maximum(y0, y1), y2)),
    )


@torch.no_grad()
def bake_canvas_plain(binning: BakeBinning, colors: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Plain PyTorch K6: (V, C >= 3) colors -> (height, width, 3) float32.

    Expands (entry, pixel of its tile) pairs ``PLAIN_ENTRIES_PER_CHUNK``
    entries at a time with the kernel's per-pair terms in its operation
    order, keeps the pairs inside their triangle, then scatter-maxes the
    depth per canvas pixel, scatter-mins the entry index among the pairs at
    that depth (entries ascend by triangle id within a tile, so this is the
    first-wins rule), and writes the winning pair's color.
    """
    LAUNCHES["uv_bake_plain"] += 1
    dev = colors.device
    g = binning.geom
    e = g.shape[1]
    if e == 0:
        return torch.zeros((height, width, 3), device=dev)
    kept = {k: [] for k in ("pix", "entry", "depth", "w0", "w1", "u")}
    for s in range(0, e, PLAIN_ENTRIES_PER_CHUNK):
        pxi, pyi, u, w1, w0, depth, inside = _pair_terms(g[:, s : s + PLAIN_ENTRIES_PER_CHUNK, None], binning.tiles_x)
        hit = inside & (pxi < width) & (pyi < height) & (depth > _NEG)
        ent, pix = torch.nonzero(hit, as_tuple=True)
        kept["pix"].append(pyi[ent, pix] * width + pxi[ent, pix])
        kept["entry"].append(ent + s)
        for name, val in (("depth", depth), ("w0", w0), ("w1", w1), ("u", u)):
            kept[name].append(val[ent, pix])
    pix, entry, depth, w0, w1, u = (torch.cat(kept[k]) for k in ("pix", "entry", "depth", "w0", "w1", "u"))

    npx = height * width
    zbuf = torch.full((npx,), _NEG, device=dev).scatter_reduce_(0, pix, depth, "amax")
    first = torch.full((npx,), e, dtype=torch.int64, device=dev)
    at_max = depth == zbuf[pix]
    first.scatter_reduce_(0, pix[at_max], entry[at_max], "amin")
    win = at_max & (entry == first[pix])  # one pair per covered pixel
    pix, entry, w0, w1, u = pix[win], entry[win], w0[win, None], w1[win, None], u[win, None]
    ci = binning.corner_idx.to(torch.int64)
    col = [colors[ci[k, entry], :3] for k in range(3)]
    canvas = torch.zeros((npx, 3), device=dev)
    canvas[pix] = w0 * col[0] + w1 * col[1] + u * col[2]
    return canvas.reshape(height, width, 3)


@torch.no_grad()
def bake_inside_plain(binning: BakeBinning) -> torch.Tensor:
    """The contract's inside test of every entry at every pixel of its tile
    -> (E, 256) bool, pixels row-major; the canvas is not applied. For the
    tests and chip_smoke.py's counts."""
    g = binning.geom
    out = torch.empty((g.shape[1], PX), dtype=torch.bool, device=g.device)
    for s in range(0, g.shape[1], PLAIN_ENTRIES_PER_CHUNK):
        out[s : s + PLAIN_ENTRIES_PER_CHUNK] = _pair_terms(g[:, s : s + PLAIN_ENTRIES_PER_CHUNK, None], binning.tiles_x)[6]
    return out


@torch.no_grad()
def bake_warp_cull_plain(binning: BakeBinning) -> torch.Tensor:
    """Plain mirror of K6's per-warp cull -> (E, 4) bool: entry e is culled
    for the warp block w (columns 8 (w % 2) + 0..7, rows 8 (w // 2) + 0..7
    of its tile) when the block lies outside its inner bbox (csrc/bake.cu).
    For the tests and chip_smoke.py's counts."""
    g = binning.geom
    umin, umax, vmin, vmax = (v[:, None] for v in _inner_bbox(g))
    tile = g[9].to(torch.int64)[:, None]
    w = torch.arange(4, device=g.device)
    bx0 = ((tile % binning.tiles_x) * TILE + (w % 2) * WARP_W).to(torch.float32)  # (E, 4)
    by0 = ((tile // binning.tiles_x) * TILE + (w // 2) * WARP_W).to(torch.float32)
    bx1, by1 = bx0 + (WARP_W - 1), by0 + (WARP_W - 1)
    return (umax < bx0) | (umin > bx1) | (vmax < by0) | (vmin > by1)


def bake_canvas_cuda(binning: BakeBinning, colors: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Launch K6: (V, C >= 3) float32 colors on the card -> (height, width,
    3) float32, zero where no triangle covers the pixel. The kernel writes
    every pixel, so the canvas is allocated without a fill."""
    if colors.device.type != "cuda":
        raise ValueError(f"the bake kernel needs a CUDA tensor, got {colors.device}")
    if colors.dtype != torch.float32 or colors.dim() != 2 or colors.shape[1] < 3 or not colors.is_contiguous():
        raise ValueError(f"colors must be contiguous float32 (V, C >= 3), got {colors.dtype} {tuple(colors.shape)}")
    g, ci = binning.geom, binning.corner_idx
    for name, a, dt in (("geom", g, torch.float32), ("corner_idx", ci, torch.int32),
                        ("tile_ids", binning.tile_ids, torch.int32), ("start", binning.start, torch.int32),
                        ("count", binning.count, torch.int32), ("empty_ids", binning.empty_ids, torch.int32)):
        if a.device != colors.device or a.dtype != dt or not a.is_contiguous():
            raise ValueError(f"binning.{name} must be contiguous {dt} on {colors.device}, got {a.dtype} on {a.device}")
    if -(-width // TILE) != binning.tiles_x or -(-height // TILE) != binning.tiles_y:
        raise ValueError(f"a binning of {binning.tiles_x}x{binning.tiles_y} tiles cannot bake a {width}x{height} canvas")
    m, n_empty = binning.tile_ids.shape[0], binning.empty_ids.shape[0]
    if m + n_empty != binning.tiles_x * binning.tiles_y:
        raise ValueError(f"{m} occupied and {n_empty} empty tiles do not cover the {binning.tiles_x}x{binning.tiles_y} "
                         "tiles of the canvas")
    if m + n_empty >= 2**30 or g.shape[1] > 2**31 - 1:
        raise ValueError("the bake kernel takes fewer than 2^30 tiles and 2^31 entries")
    out = torch.empty((height, width, 3), device=colors.device)
    fn = kernels.kernel("uv_bake")
    stream = torch.cuda.current_stream(colors.device).cuda_stream
    status = fn(
        g.data_ptr(), ci.data_ptr(), g.shape[1], colors.data_ptr(), colors.shape[1],
        binning.tile_ids.data_ptr(), binning.start.data_ptr(), binning.count.data_ptr(), m,
        binning.empty_ids.data_ptr(), n_empty, binning.tiles_x, width, height, out.data_ptr(), stream,
    )
    kernels.check(status, "uv_bake")
    LAUNCHES["uv_bake"] += 1
    return out


def bake_canvas(binning: BakeBinning, colors: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """The bake of ``colors`` over ``binning``: K6 on CUDA, the plain
    version on CPU -> (height, width, 3) float32."""
    if colors.device.type == "cpu":
        return bake_canvas_plain(binning, colors, height, width)
    return bake_canvas_cuda(binning, colors.contiguous(), height, width)


def bake_texture_tiled(
    uv_px: Optional[np.ndarray],
    tris: Optional[np.ndarray],
    colors,
    height: int,
    width: int,
    binning: Optional[BakeBinning] = None,
    device="cuda",
) -> torch.Tensor:
    """Rasterize vertex colors over the UV canvas -> (H, W, 3) float32 on
    ``device``, with no window limit: a triangle bins into every tile it
    touches. With a per-sequence ``binning``, ``uv_px`` and ``tris`` may be
    None."""
    dev = resolve_device(device)
    if binning is None:
        binning = compute_bake_binning(uv_px, tris, height, width, device=dev)
    return bake_canvas(binning, torch.as_tensor(colors, dtype=torch.float32, device=dev), height, width)


def band_binning(binning: BakeBinning, height: int, bands: int, band_ids) -> BakeBinning:
    """The part of ``binning`` that row bands ``band_ids`` own: the occupied
    tiles whose first pixel row falls in one of them (bands of ``ceil(height
    / bands)`` rows, so each tile has one owner) and their entries, a
    contiguous run since entries are sorted by tile. Its ``empty_ids`` are
    every other tile of the canvas, which the bake writes as zeros."""
    band_h = -(-height // bands)
    tile_band = (binning.tile_ids // binning.tiles_x) * TILE // band_h
    mine = torch.isin(tile_band, torch.as_tensor(list(band_ids), dtype=tile_band.dtype, device=tile_band.device))
    tile_ids, start, count = binning.tile_ids[mine], binning.start[mine], binning.count[mine]
    e0 = int(start[0]) if tile_ids.shape[0] else 0
    e1 = int(start[-1] + count[-1]) if tile_ids.shape[0] else 0
    every = torch.arange(binning.tiles_x * binning.tiles_y, dtype=torch.int32, device=tile_ids.device)
    return BakeBinning(
        geom=binning.geom[:, e0:e1].contiguous(), corner_idx=binning.corner_idx[:, e0:e1].contiguous(),
        tile_ids=tile_ids.contiguous(), start=(start - e0).contiguous(), count=count.contiguous(),
        empty_ids=every[~torch.isin(every, tile_ids)], tiles_x=binning.tiles_x, tiles_y=binning.tiles_y,
    )


def bake_texture_sharded(
    uv_px: Optional[np.ndarray],
    tris: Optional[np.ndarray],
    colors,
    height: int,
    width: int,
    bands: int = 8,
    binning: Optional[BakeBinning] = None,
    group=None,
    device="cuda",
) -> torch.Tensor:
    """The bake with the canvas's row bands sharded over the ranks of
    ``group`` (the default process group) -> the (H, W, 3) float32 canvas on
    every rank, equal bit for bit to ``bake_texture_tiled``'s
    (``texture/bake.py:252``).

    ``bands`` row bands are padded with empty ones to a multiple of the
    world size (``:283-291``); rank r takes the r-th contiguous run of them
    and bakes the tiles they own through the bake (K6 on the card) on a
    canvas that is zero elsewhere. One ``all_reduce`` (SUM) assembles the
    canvases: each pixel has one writer, so the sum is exact."""
    dev = resolve_device(device)
    if binning is None:
        binning = compute_bake_binning(uv_px, tris, height, width, device=dev)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    per = -(-bands // world)  # bands per rank, the last ones padding
    mine = range(rank * per, min(rank * per + per, bands))
    canvas = bake_canvas(band_binning(binning, height, bands, mine),
                         torch.as_tensor(colors, dtype=torch.float32, device=dev), height, width)
    dist.all_reduce(canvas, op=dist.ReduceOp.SUM, group=group)
    return canvas
