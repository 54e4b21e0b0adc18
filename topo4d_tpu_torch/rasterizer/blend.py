"""The tile blend: CUDA kernels K1/K2 and K4f/K4b and their plain PyTorch version.

Replaces ``rasterizer/pallas_blend.py`` (and ``pallas_resident.py``, whose
contract is the same). ``tile_blend(packed, tile_start, tile_count,
tiles_x, tiles_y)`` blends (tile, depth)-sorted packed entries into
(T, 8, 256) tile buffers: rows 0-2 rgb, 3 depth, 4 T_final (rows 0-4 as in
JAX), row 5 the count of entries up to each pixel's last contributor (the
backward's residual), rows 6-7 zero.

Compact mode: with ``tile_ids`` ((R,) int32), row r blends global tile
``tile_ids[r]`` (which sets its pixel coordinates) over the range
``tile_start[r]``, ``tile_count[r]``, and the output has R rows. Padding
rows carry the sentinel id T = tiles_x * tiles_y and count 0. Without
``tile_ids``, row r is tile r.

Dispatch (``variant``, as ``render_gaussians_pallas`` takes it): a CUDA
tensor goes to ``csrc/blend_fwd.cu`` (K1) and ``csrc/blend_bwd.cu`` (K2)
under "auto", "resident" and "stream" (the JAX package's K1/K2 and its
VMEM-resident K3, one contract), or to the window-span pair
``csrc/blend_v3_fwd.cu`` (K4f) and ``csrc/blend_v3_bwd.cu`` (K4b) under
"v3", or raises; a CPU tensor goes to ``tile_blend_plain`` under every
variant, which is also each kernel's oracle on the card. ``LAUNCHES``
counts kernel launches and plain calls. Under a profiler K1's and K2's
entries are the spans ``blend.fwd`` and ``blend.bwd``. ``warp_block_cull_plain`` mirrors
K1's per-warp bounding-box cull, for the tests and chip_smoke.py's counts;
no blend calls it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from topo4d_tpu_torch import kernels
from topo4d_tpu_torch.core.gaussian import ALPHA_MAX, ALPHA_MIN, TRANSMITTANCE_MIN
from topo4d_tpu_torch.rasterizer.tiles import PACK_FIELDS, TILE
from topo4d_tpu_torch.utils.profiling import traced

PX = TILE * TILE  # 256 pixels per tile

# launches of each kernel and calls of the plain version, since the last reset
LAUNCHES: Dict[str, int] = {
    "tile_blend_fwd": 0, "tile_blend_bwd": 0, "tile_blend_v3_fwd": 0, "tile_blend_v3_bwd": 0,
    "tile_blend_plain": 0,
}

VARIANTS = ("auto", "resident", "stream", "v3")
TILES_PER_STEP = 4  # K4's rows per block by default (pallas_blend.py:931)
MAX_TPS = 8  # the largest block of rows K4's kernels are built for


def check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown blend variant {variant!r}; expected one of {VARIANTS}")


def tiles_per_step(num_rows: int) -> int:
    """K4's rows per block when the caller gives none: JAX's
    ``_tiles_per_step`` (``pallas_blend.py:931-939``), 4 or fewer when
    there are fewer rows."""
    for tps in (TILES_PER_STEP, 4, 2, 1):
        if num_rows >= tps:
            return tps
    return 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch version (CPU path, and the kernels' oracle on the card)
# ---------------------------------------------------------------------------


def _blend_weights_core(alpha):
    t_incl = torch.cumprod(1.0 - alpha, dim=-1)  # T after entry i
    t_excl = torch.cat([torch.ones_like(t_incl[..., :1]), t_incl[..., :-1]], dim=-1)
    # alpha <= 0.99 => t_incl is non-increasing, so "terminated at or before
    # i" == t_incl_i < 1e-4, and the terminating entry is not drawn
    keep = t_incl >= TRANSMITTANCE_MIN
    w = alpha * t_excl * keep
    t_final = torch.amin(torch.where(keep, t_incl, torch.ones_like(t_incl)), dim=-1)
    return w, t_final, t_incl, keep


class BlendWeights(torch.autograd.Function):
    """Front-to-back weights (w (..., M), T_final (...)) from alphas in depth order.

    Port of ``reference.py:blend_weights`` with its hand-derived backward:
    the termination mask is piecewise constant, the T_final cotangent lands
    on the last kept entry, and the cumprod adjoint is a suffix sum divided
    by (1 - alpha) >= 0.01.
    """

    @staticmethod
    def forward(ctx, alpha):
        w, t_final, t_incl, _ = _blend_weights_core(alpha)
        ctx.save_for_backward(alpha, t_incl)
        return w, t_final

    @staticmethod
    def backward(ctx, gw, gtf):
        alpha, t_incl = ctx.saved_tensors
        t_excl = torch.cat([torch.ones_like(t_incl[..., :1]), t_incl[..., :-1]], dim=-1)
        keep = t_incl >= TRANSMITTANCE_MIN
        keepf = keep.to(alpha.dtype)
        g_direct = gw * t_excl * keepf
        c_shift = gw * alpha * keepf
        c_incl = torch.cat([c_shift[..., 1:], torch.zeros_like(c_shift[..., :1])], dim=-1)
        keep_next = torch.cat([keep[..., 1:], torch.zeros_like(keep[..., :1])], dim=-1)
        last_kept = (keep & ~keep_next).to(alpha.dtype)
        c_incl = c_incl + gtf[..., None] * last_kept
        s = torch.flip(torch.cumsum(torch.flip(c_incl * t_incl, [-1]), dim=-1), [-1])
        return g_direct - s / (1.0 - alpha)


def blend_weights(alpha: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return BlendWeights.apply(alpha)


def _pixel_coords(tile_ids: torch.Tensor, tiles_x: int):
    """Pixel-center coordinates (T, 256) of each tile's pixels, row-major."""
    p = torch.arange(PX, device=tile_ids.device)
    px = (tile_ids[:, None] % tiles_x) * TILE + p[None, :] % TILE
    py = (tile_ids[:, None] // tiles_x) * TILE + p[None, :] // TILE
    return px.to(torch.float32), py.to(torch.float32)


def tile_alpha(packed, tile_start, tile_count, tiles_x, tile_ids=None, m=None):
    """Per (row, pixel, entry) alphas with the CUDA skip rules -> ((R, 256, M), entries).

    Each row's range padded to ``m`` entries (default: the rows' largest
    count) as a dense batch;
    ``entries`` is the gathered (16, T, M) packed data (padding zeroed).
    The 0.99 clamp is straight-through in the backward
    (``reference.py:_alpha_at_pixels``).
    """
    t = tile_start.shape[0]
    dev = packed.device
    if m is None:
        m = max(int(tile_count.max()), 1) if t else 1
    j = torch.arange(m, device=dev)
    valid = j[None, :] < tile_count[:, None].to(torch.int64)
    idx = torch.where(valid, tile_start[:, None].to(torch.int64) + j[None, :], 0)
    ent = packed[:, idx] * valid  # (16, T, M)
    px, py = _pixel_coords(torch.arange(t, device=dev) if tile_ids is None else tile_ids, tiles_x)
    dx = ent[0][:, None, :] - px[:, :, None]  # (T, 256, M)
    dy = ent[1][:, None, :] - py[:, :, None]
    ca, cb, cc, op = (ent[k][:, None, :] for k in (2, 3, 4, 5))
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    raw = op * torch.exp(power)
    alpha = raw + (torch.clamp(raw, max=ALPHA_MAX) - raw).detach()
    keep = (power <= 0.0) & (alpha >= ALPHA_MIN) & valid[:, None, :]
    return torch.where(keep, alpha, torch.zeros_like(alpha)), ent


# K1's conservative cull (csrc/blend_fwd.cu, "The cull"): its ranges and margins
WARP_W = 8  # K1's and K2's warps each own an 8 x 8 pixel block of a tile
_COORD_MAX = 2.0**20
_CONIC_MAX = 2.0**40
_CONIC_MIN = 2.0**-40
_COND_MAX = 65536.0
_OPACITY_NONE = float(torch.tensor(ALPHA_MIN, dtype=torch.float32) * torch.tensor(0.99999, dtype=torch.float32))
_TAU_SLACK = 1e-5
_TAU_SCALE = 1.0625
_BOX_SCALE = 1.01


def cull_box_plain(x, y, a, b, c, o):
    """K1's cull box per entry, float32 -> half-widths (hx, hy): +inf culls
    nothing, -inf culls every pixel (csrc/blend_fwd.cu ``cull_box``)."""
    inf = torch.full_like(x, float("inf"))
    tame = (x.abs() <= _COORD_MAX) & (y.abs() <= _COORD_MAX) & (a.abs() <= _CONIC_MAX)
    tame &= (b.abs() <= _CONIC_MAX) & (c.abs() <= _CONIC_MAX)
    none_pass = tame & (o < _OPACITY_NONE)
    det = a * c - b * b
    tr = a + c
    t = torch.log(255.0 * o) + _TAU_SLACK
    boxed = tame & ~none_pass & (o <= 1.0) & (a >= _CONIC_MIN) & (c >= _CONIC_MIN)
    boxed &= (det > 0.0) & (tr * tr <= _COND_MAX * det) & (t > 0.0)
    t2 = 2.0 * (_TAU_SCALE * t)
    hx = torch.where(boxed, _BOX_SCALE * torch.sqrt(t2 * c / det), inf)
    hy = torch.where(boxed, _BOX_SCALE * torch.sqrt(t2 * a / det), inf)
    return torch.where(none_pass, -inf, hx), torch.where(none_pass, -inf, hy)


@torch.no_grad()
def warp_block_cull_plain(packed, tile_start, tile_count, tiles_x: int, tile_ids=None):
    """Plain mirror of K1's warp-uniform cull -> (R, 4, M) bool: entry j of
    row r's range is culled for the warp block w (columns 8 (w % 2) + 0..7,
    rows 8 (w // 2) + 0..7 of the tile), M the largest count as in
    ``tile_alpha``. For the tests and chip_smoke.py's counts only."""
    t = tile_start.shape[0]
    dev = packed.device
    m = max(int(tile_count.max()), 1) if t else 1
    j = torch.arange(m, device=dev)
    valid = j[None, :] < tile_count[:, None].to(torch.int64)
    idx = torch.where(valid, tile_start[:, None].to(torch.int64) + j[None, :], 0)
    x, y, a, b, c, o = (packed[k][idx] for k in range(6))  # (R, M)
    hx, hy = cull_box_plain(x, y, a, b, c, o)
    ids = torch.arange(t, device=dev) if tile_ids is None else tile_ids.to(torch.int64)
    w = torch.arange(4, device=dev)
    bx0 = ((ids[:, None] % tiles_x) * TILE + (w % 2) * WARP_W).to(torch.float32)[..., None]  # (R, 4, 1)
    by0 = ((ids[:, None] // tiles_x) * TILE + (w // 2) * WARP_W).to(torch.float32)[..., None]
    bx1, by1 = bx0 + (WARP_W - 1), by0 + (WARP_W - 1)
    x, y, hx, hy = (v[:, None, :] for v in (x, y, hx, hy))
    culled = (bx0 - x > hx) | (x - bx1 > hx) | (by0 - y > hy) | (y - by1 > hy)
    return culled & valid[:, None, :]


def _bucket_keys(tile_count: torch.Tensor) -> torch.Tensor:
    c = tile_count.detach().cpu().to(torch.int64).clamp(min=1)
    return torch.ceil(torch.log2(c.to(torch.float64))).to(torch.int64)


def _count_buckets(tile_count: torch.Tensor, bucket_counts=None):
    """Row indices grouped by entry count, each group's counts within
    (2^(k-1), 2^k] (0 and 1 together) -> [(rows, m)], the group padded to
    m, its largest count, so each row to at most twice its own. With
    ``bucket_counts`` (the counts of a larger set of rows that these rows
    belong to), m is the largest count of the group's bucket in that set."""
    key = _bucket_keys(tile_count)
    ref = key if bucket_counts is None else _bucket_keys(bucket_counts)
    ref_counts = (tile_count if bucket_counts is None else bucket_counts).detach().cpu().to(torch.int64).clamp(min=1)
    m_of = torch.zeros(int(max(key.max(), ref.max())) + 1 if key.numel() else 1, dtype=torch.int64)
    m_of.scatter_reduce_(0, ref, ref_counts, "amax")
    order = torch.argsort(key, stable=True)
    sizes = torch.bincount(key)
    return [(idx.to(tile_count.device), int(m_of[k]))
            for idx, k in zip(torch.split(order, sizes[sizes > 0].tolist()), torch.nonzero(sizes).flatten().tolist())]


def _blend_rows(packed, tile_start, tile_count, tiles_x: int, tile_ids, m: int):
    """The blend of the given rows, each padded to ``m`` entries."""
    alpha, ent = tile_alpha(packed, tile_start, tile_count, tiles_x, tile_ids, m)
    w, t_final = blend_weights(alpha)  # (R, 256, M), (R, 256)
    feat = ent[8:12].permute(1, 2, 0)  # (R, M, 4): r, g, b, depth
    acc = torch.matmul(w, feat).transpose(1, 2)  # (R, 4, 256)
    m = alpha.shape[-1]
    pos = torch.arange(1, m + 1, device=packed.device, dtype=torch.float32)
    n_contrib = torch.amax((w > 0) * pos, dim=-1)  # entries up to the last contributor
    zeros = torch.zeros_like(t_final)
    return torch.cat([acc, torch.stack([t_final, n_contrib, zeros, zeros], dim=1)], dim=1)


def tile_blend_plain(packed, tile_start, tile_count, tiles_x: int, tiles_y: int, tile_ids=None, bucket_counts=None):
    """Plain PyTorch tile blend, differentiable by autograd -> (R, 8, 256).

    The one oracle of every blend kernel: K1/K2 and K4f/K4b share this
    contract (K4 differs only in the order blocks walk the entries). Rows
    are blended in groups of similar entry count (``_count_buckets``), each
    padded to its group's largest count, not to the canvas's: each row's
    math is that of a lone row. A caller that blends a block of a larger
    set of rows passes the set's counts as ``bucket_counts``: each row then
    pads as it would among them, and its sums run in the same order."""
    LAUNCHES["tile_blend_plain"] += 1
    rows = tile_start.shape[0]
    ids = torch.arange(rows, device=packed.device) if tile_ids is None else tile_ids
    if rows == 0:
        return packed.new_zeros((0, 8, PX))
    groups = _count_buckets(tile_count, bucket_counts)
    parts = [_blend_rows(packed, tile_start[g], tile_count[g], tiles_x, ids[g], m) for g, m in groups]
    order = torch.cat([g for g, _ in groups])
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(rows, device=order.device)
    return torch.cat(parts)[inverse]


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------


def _check_inputs(packed, tile_start, tile_count, tiles_x, tiles_y, tile_ids) -> int:
    """Validate the kernels' inputs -> the number of output rows R."""
    rows = tiles_x * tiles_y if tile_ids is None else tile_ids.shape[0]
    if packed.device.type != "cuda":
        raise ValueError(f"tile blend kernel needs CUDA tensors, got {packed.device}")
    if packed.dtype != torch.float32 or packed.dim() != 2 or packed.shape[0] != PACK_FIELDS:
        raise ValueError(f"packed must be float32 ({PACK_FIELDS}, E_pad), got {packed.dtype} {tuple(packed.shape)}")
    named = [("tile_start", tile_start), ("tile_count", tile_count)]
    if tile_ids is not None:
        named.append(("tile_ids", tile_ids))
    for name, r in named:
        if r.dtype != torch.int32 or r.shape != (rows,) or r.device != packed.device:
            raise ValueError(f"{name} must be int32 ({rows},) on {packed.device}, got {r.dtype} {tuple(r.shape)} {r.device}")
        if not r.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    return rows


def _check_grad_inputs(fwd_out, g_out, rows: int, device) -> None:
    for name, a in (("fwd_out", fwd_out), ("g_out", g_out)):
        if a.dtype != torch.float32 or a.shape != (rows, 8, PX) or a.device != device:
            raise ValueError(f"{name} must be float32 ({rows}, 8, {PX}) on {device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


@traced("blend.fwd")
def tile_blend_fwd_cuda(packed, tile_start, tile_count, tiles_x: int, tiles_y: int, tile_ids=None):
    """Launch K1 -> (R, 8, 256) float32."""
    rows = _check_inputs(packed, tile_start, tile_count, tiles_x, tiles_y, tile_ids)
    out = torch.empty((rows, 8, PX), dtype=torch.float32, device=packed.device)
    fn = kernels.kernel("tile_blend_fwd")
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    status = fn(
        packed.data_ptr(), packed.shape[1], tile_start.data_ptr(), tile_count.data_ptr(),
        _ptr(tile_ids), tiles_x, rows, out.data_ptr(), stream,
    )
    kernels.check(status, "tile_blend_fwd")
    LAUNCHES["tile_blend_fwd"] += 1
    return out


@traced("blend.bwd")
def tile_blend_bwd_cuda(packed, tile_start, tile_count, fwd_out, g_out, tiles_x: int, tiles_y: int, tile_ids=None):
    """Launch K2 -> dpacked (16, E_pad) float32 (zero outside the tile ranges)."""
    rows = _check_inputs(packed, tile_start, tile_count, tiles_x, tiles_y, tile_ids)
    _check_grad_inputs(fwd_out, g_out, rows, packed.device)
    dpacked = torch.zeros_like(packed)
    fn = kernels.kernel("tile_blend_bwd")
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    status = fn(
        packed.data_ptr(), packed.shape[1], tile_start.data_ptr(), tile_count.data_ptr(),
        _ptr(tile_ids), tiles_x, rows, fwd_out.data_ptr(), g_out.data_ptr(), dpacked.data_ptr(), stream,
    )
    kernels.check(status, "tile_blend_bwd")
    LAUNCHES["tile_blend_bwd"] += 1
    return dpacked


def _check_tps(tps: int) -> None:
    if not 1 <= tps <= MAX_TPS:
        raise ValueError(f"tps (K4's rows per block) must be in [1, {MAX_TPS}], got {tps}")


def tile_blend_v3_fwd_cuda(packed, tile_start, tile_count, tiles_x: int, tiles_y: int, tile_ids=None, tps=None):
    """Launch K4f, ``tps`` rows per block (None: ``tiles_per_step``) -> (R, 8, 256) float32."""
    rows = _check_inputs(packed, tile_start, tile_count, tiles_x, tiles_y, tile_ids)
    tps = tiles_per_step(rows) if tps is None else tps
    _check_tps(tps)
    out = torch.empty((rows, 8, PX), dtype=torch.float32, device=packed.device)
    fn = kernels.kernel("tile_blend_v3_fwd")
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    status = fn(
        packed.data_ptr(), packed.shape[1], tile_start.data_ptr(), tile_count.data_ptr(),
        _ptr(tile_ids), tiles_x, rows, tps, out.data_ptr(), stream,
    )
    kernels.check(status, "tile_blend_v3_fwd")
    LAUNCHES["tile_blend_v3_fwd"] += 1
    return out


def tile_blend_v3_bwd_cuda(
    packed, tile_start, tile_count, fwd_out, g_out, tiles_x: int, tiles_y: int, tile_ids=None, tps=None
):
    """Launch K4b, ``tps`` rows per block -> dpacked (16, E_pad) float32 (zero outside the tile ranges)."""
    rows = _check_inputs(packed, tile_start, tile_count, tiles_x, tiles_y, tile_ids)
    _check_grad_inputs(fwd_out, g_out, rows, packed.device)
    tps = tiles_per_step(rows) if tps is None else tps
    _check_tps(tps)
    dpacked = torch.zeros_like(packed)
    fn = kernels.kernel("tile_blend_v3_bwd")
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    status = fn(
        packed.data_ptr(), packed.shape[1], tile_start.data_ptr(), tile_count.data_ptr(),
        _ptr(tile_ids), tiles_x, rows, tps, fwd_out.data_ptr(), g_out.data_ptr(), dpacked.data_ptr(), stream,
    )
    kernels.check(status, "tile_blend_v3_bwd")
    LAUNCHES["tile_blend_v3_bwd"] += 1
    return dpacked


class _TileBlendCUDA(torch.autograd.Function):
    """K1/K2 (``tps`` None) or K4f/K4b with ``tps`` rows per block."""

    @staticmethod
    def forward(ctx, packed, tile_start, tile_count, tiles_x, tiles_y, tile_ids, tps):
        args = (packed, tile_start, tile_count, tiles_x, tiles_y, tile_ids)
        out = tile_blend_fwd_cuda(*args) if tps is None else tile_blend_v3_fwd_cuda(*args, tps)
        ctx.save_for_backward(packed, tile_start, tile_count, out)
        ctx.tile_ids = tile_ids
        ctx.tiles = (tiles_x, tiles_y)
        ctx.tps = tps
        return out

    @staticmethod
    def backward(ctx, g_out):
        packed, tile_start, tile_count, out = ctx.saved_tensors
        args = (packed, tile_start, tile_count, out, g_out.contiguous(), *ctx.tiles, ctx.tile_ids)
        dpacked = tile_blend_bwd_cuda(*args) if ctx.tps is None else tile_blend_v3_bwd_cuda(*args, ctx.tps)
        return dpacked, None, None, None, None, None, None


def tile_blend(
    packed, tile_start, tile_count, tiles_x: int, tiles_y: int, tile_ids=None, variant: str = "auto", tps=None,
    bucket_counts=None,
):
    """Blend packed entries -> (R, 8, 256); kernels on CUDA, plain version on CPU.

    ``variant`` "v3" launches K4f/K4b with ``tps`` rows per block (None:
    ``tiles_per_step``); "auto", "resident" and "stream" launch K1/K2,
    whose block is one tile, so they ignore ``tps``. ``bucket_counts``
    reaches the plain version only (``tile_blend_plain``): a kernel's tile
    math does not depend on the other rows.
    """
    check_variant(variant)
    if packed.device.type == "cpu":
        return tile_blend_plain(packed, tile_start, tile_count, tiles_x, tiles_y, tile_ids, bucket_counts)
    if variant == "v3" and tps is None:
        tps = tiles_per_step(tile_start.shape[0])
    return _TileBlendCUDA.apply(
        packed, tile_start, tile_count, tiles_x, tiles_y, tile_ids, tps if variant == "v3" else None
    )
