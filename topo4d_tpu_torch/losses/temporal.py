"""Temporal / topological regularizers: rigid, rot, iso (losses/temporal.py).

Transposed layout kept from the reference at the public functions:
components lead, vertices ride the last axis ((3, N), (K, N), (3, K, N)).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from topo4d_tpu_torch.losses.neighbors import gather_rows_inv


def _gather_rows_t(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, C) table, (K, N) indices -> (C, K, N) transposed neighbor data."""
    k, n = idx.shape
    rows = table[idx.reshape(-1)]  # (K*N, C)
    return rows.T.reshape(table.shape[1], k, n)


class TemporalPriors(NamedTuple):
    """Previous-frame pose cached at the start of each tracked frame."""

    prev_inv_rot: torch.Tensor  # (4, N) conjugate of previous normalized quats
    prev_offset: torch.Tensor  # (3, K, N) one-ring offsets in the previous frame


def _quat_mult_t(q1, q2):
    """Hamilton product in (4, N) component layout."""
    w1, x1, y1, z1 = q1[0], q1[1], q1[2], q1[3]
    w2, x2, y2, z2 = q2[0], q2[1], q2[2], q2[3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


@torch.no_grad()
def make_temporal_priors(
    means3d: torch.Tensor,  # (N, 3)
    rotations: torch.Tensor,  # (N, 4) normalized quats
    neighbor_indices: torch.Tensor,  # (K, N)
) -> TemporalPriors:
    """Cache the previous-frame pose for the rigid loss (train.py:420-432)."""
    xt = means3d.T
    nb = _gather_rows_t(means3d, neighbor_indices)
    qt = rotations.T
    return TemporalPriors(
        prev_inv_rot=torch.stack([qt[0], -qt[1], -qt[2], -qt[3]]),
        prev_offset=nb - xt[:, None, :],
    )


def rigid_rot_iso_losses(
    means3d: torch.Tensor,  # (N, 3)
    rotations: torch.Tensor,  # (N, 4) normalized
    priors: TemporalPriors,
    neighbor_indices: torch.Tensor,  # (K, N)
    neighbor_dist: torch.Tensor,  # (K, N)
    rig_w: torch.Tensor,
    rot_w: torch.Tensor,
    iso_w: torch.Tensor,
    extra: Optional[Callable] = None,  # fn(nb (7, K, N), xt (3, N)) -> scalar
    ring_inv: Optional[torch.Tensor] = None,  # inverse incidence of the flat (K*N,) table
) -> Dict[str, torch.Tensor]:
    """The three temporal losses of train.py:331-346 (+ an optional one-ring
    loss ``extra`` that reuses the neighbor gather, returned pre-weighted
    under "extra")."""
    eps = 1e-20
    idx = neighbor_indices
    qt = rotations.T
    rel = _quat_mult_t(qt, priors.prev_inv_rot)  # (4, N) unnormalized product

    nrm = torch.sqrt(rel[0] ** 2 + rel[1] ** 2 + rel[2] ** 2 + rel[3] ** 2)
    r, x, y, z = (rel[c] / nrm for c in range(4))
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - r * z)
    r02 = 2 * (x * z + r * y)
    r10 = 2 * (x * y + r * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - r * x)
    r20 = 2 * (x * z - r * y)
    r21 = 2 * (y * z + r * x)
    r22 = 1 - 2 * (x * x + y * y)

    xt = means3d.T
    tbl = torch.cat([means3d, rel.T], dim=1)  # (N, 7)
    k, n = idx.shape
    if ring_inv is not None:
        rows = gather_rows_inv(tbl, idx.reshape(-1), ring_inv)
        nb = rows.T.reshape(tbl.shape[1], k, n)
    else:
        nb = _gather_rows_t(tbl, idx)
    off = [nb[c] - xt[c][None, :] for c in range(3)]

    o0 = r00 * off[0] + r10 * off[1] + r20 * off[2]
    o1 = r01 * off[0] + r11 * off[1] + r21 * off[2]
    o2 = r02 * off[0] + r12 * off[1] + r22 * off[2]
    d0 = o0 - priors.prev_offset[0]
    d1 = o1 - priors.prev_offset[1]
    d2 = o2 - priors.prev_offset[2]
    rigid = torch.mean(torch.sqrt((d0 * d0 + d1 * d1 + d2 * d2) * rig_w + eps))

    s4 = torch.zeros_like(rot_w)
    for c in range(4):
        dq = nb[3 + c] - rel[c][None, :]
        s4 = s4 + dq * dq
    rot = torch.mean(torch.sqrt(s4 * rot_w + eps))

    mag = torch.sqrt(off[0] ** 2 + off[1] ** 2 + off[2] ** 2 + eps)
    dd = mag - neighbor_dist
    iso = torch.mean(torch.sqrt(dd * dd * iso_w + eps))

    out = {"rigid": rigid, "rot": rot, "iso": iso}
    if extra is not None:
        out["extra"] = extra(nb, xt)
    return out
