"""Row gathers whose backward is a gather, not a scatter (losses/neighbors.py).

``table[idx]``'s default backward is a scatter-add over every gathered row
(``index_add_``, float atomics on the card, in no fixed order). Two
backwards that gather instead, deterministic:

- ``gather_neighbors``: one-ring adjacency is symmetric, so the transpose
  of ``x[indices]`` is itself a gather over precomputed inverse slots
  (``topology.adjacency.inverse_slots``):
  dx[v] = sum_j dy[indices[v, j], inv_slot[v, j]];
- ``gather_rows_inv``: for any static index vector the host precomputes,
  for each row, every position that gathers it (``build_inverse_incidence``,
  or ``build_inverse_incidence_split``'s dense table plus overflow lists);
  the backward gathers those positions' gradients and sums them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class _GatherNeighbors(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, indices, inv_slot):
        ctx.save_for_backward(indices, inv_slot)
        return x[indices]

    @staticmethod
    def backward(ctx, dy):
        indices, inv_slot = ctx.saved_tensors
        return torch.sum(dy[indices, inv_slot], dim=1), None, None


def gather_neighbors(x: torch.Tensor, indices: torch.Tensor, inv_slot: torch.Tensor) -> torch.Tensor:
    """``x[indices]`` ((N, C) rows, (N, K) int64 symmetric one-ring indices
    padded with self) whose backward gathers through ``inv_slot``
    (``topology.adjacency.inverse_slots``) instead of scattering."""
    return _GatherNeighbors.apply(x, indices, inv_slot)


def build_inverse_incidence(idx_flat: np.ndarray, n: int) -> np.ndarray:
    """(n, dmax) int64 positions into ``idx_flat`` per referenced row: the
    single dense table of ``build_inverse_incidence_split``.

    ``inv[v]`` lists every position p with ``idx_flat[p] == v``, padded with
    ``len(idx_flat)`` (the backward appends a zero row to the gradient).
    Entries >= n (explicit sentinels) are ignored.
    """
    inv, extra_pos, _ = build_inverse_incidence_split(idx_flat, n, slots=None)
    assert extra_pos.size == 0  # slots=None leaves no overflow
    return inv.astype(np.int64)


class _GatherRowsInv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, inv):
        ctx.save_for_backward(inv)
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (inv,) = ctx.saved_tensors
        gpad = torch.cat([g, g.new_zeros((1,) + g.shape[1:])], dim=0)
        n, s = inv.shape
        dtable = gpad[inv.reshape(-1)].reshape(n, s, *g.shape[1:]).sum(dim=1)
        return dtable, None, None


def gather_rows_inv(table: torch.Tensor, idx: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (idx (L,) int64 < N) with the inverse-incidence backward."""
    return _GatherRowsInv.apply(table, idx, inv)


# The JAX package's cost model for the split, microseconds per 1k rows of a
# row gather and of an unsorted scatter-add as measured on a TPU v5e; kept
# so that the split equals the JAX package's, not as a model of the card
_GATHER_US_PER_KROW = 2.9
_SCATTER_US_PER_KROW = 8.6


def build_inverse_incidence_split(idx_flat: np.ndarray, n: int, slots: Optional[int] = 0):
    """Inverse incidence as a dense (n, S) table plus overflow lists ->
    (inv, extra_pos, extra_vert).

    ``inv[v]`` lists the first S positions p with ``idx_flat[p] == v``,
    padded with ``len(idx_flat)``; a vertex's later positions go to
    ``extra_pos`` with the vertex in ``extra_vert``. ``slots=None`` takes the
    single dense table (S = the largest count, no overflow); otherwise S
    minimizes n * S * gather + overflow * scatter under the JAX package's
    cost model. Entries >= n (explicit sentinels) are ignored.
    """
    idx_flat = np.asarray(idx_flat, np.int64).reshape(-1)
    length = idx_flat.shape[0]
    pos = np.nonzero(idx_flat < n)[0]
    vals = idx_flat[pos]
    order = np.argsort(vals, kind="stable")
    sorted_v = vals[order]
    sorted_p = pos[order].astype(np.int32)
    counts = np.bincount(sorted_v, minlength=n)
    dmax = max(int(counts.max()) if counts.size else 0, 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(sorted_v.shape[0]) - np.repeat(starts, counts)
    if slots is None:
        s = dmax
    else:
        cands = np.arange(1, dmax + 1)
        overflow = np.array([np.maximum(counts - c, 0).sum() for c in cands])
        cost = n * cands * _GATHER_US_PER_KROW + overflow * _SCATTER_US_PER_KROW
        s = int(cands[int(np.argmin(cost))])
    main = slot < s
    inv = np.full((n, s), length, np.int32)
    inv[sorted_v[main], slot[main]] = sorted_p[main]
    return inv, sorted_p[~main], sorted_v[~main].astype(np.int32)
