"""Row gathers whose backward is a gather over an inverse-incidence table.

``table[idx]``'s default backward is a scatter-add over every gathered row
(``index_add_``, float atomics on the card, in no fixed order). For a
static index vector the host precomputes, for each row, every position that
gathers it (``build_inverse_incidence``); the backward then gathers those
positions' gradients and sums them: the same sum, deterministic, no
scatter (losses/neighbors.py).
"""

from __future__ import annotations

import numpy as np
import torch


def build_inverse_incidence(idx_flat: np.ndarray, n: int) -> np.ndarray:
    """(n, dmax) positions into ``idx_flat`` per referenced row.

    ``inv[v]`` lists every position p with ``idx_flat[p] == v``, padded with
    ``len(idx_flat)`` (the backward appends a zero row to the gradient).
    Entries >= n (explicit sentinels) are ignored.
    """
    idx_flat = np.asarray(idx_flat, np.int64).reshape(-1)
    length = idx_flat.shape[0]
    pos = np.nonzero(idx_flat < n)[0]
    vals = idx_flat[pos]
    order = np.argsort(vals, kind="stable")
    sorted_v = vals[order]
    sorted_p = pos[order]
    counts = np.bincount(sorted_v, minlength=n)
    dmax = max(int(counts.max()) if counts.size else 0, 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(sorted_v.shape[0]) - np.repeat(starts, counts)
    inv = np.full((n, dmax), length, np.int64)
    inv[sorted_v, slot] = sorted_p
    return inv


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
