"""Flatten (dihedral-angle) and umbrella losses (losses/flatten.py).

Host NumPy builders precompute the index sets once; the per-step losses
are a few gathers and elementwise math. ``prepare_quad_gather`` and
``to_device`` move a loss's static tables to the device once, so a step
copies nothing from the host.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from topo4d_tpu_torch.losses.neighbors import build_inverse_incidence, gather_rows_inv
from topo4d_tpu_torch.losses.temporal import _gather_rows_t


class DihedralQuadruples(NamedTuple):
    """Shared-edge quadruples: edge (v0, v1) with opposite vertices (v2, v3)."""

    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    v3: np.ndarray


def build_dihedral_quadruples(faces: np.ndarray) -> DihedralQuadruples:
    """The FlattenLoss constructor's shared-edge set (loss_util.py:121-169).

    Candidate edges are (f0, f1) and (f1, f2) of each triangle, not (f0, f2);
    an edge is kept iff exactly two faces contain both endpoints, and v2/v3
    are those faces' third vertices in ascending face order.
    """
    faces = np.asarray(faces, np.int64)
    cand = np.sort(np.concatenate([faces[:, 0:2], faces[:, 1:3]], axis=0), axis=1)
    cand = np.unique(cand, axis=0)
    f_pairs = np.sort(
        np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [0, 2]]], axis=0),
        axis=1,
    )
    face_ids = np.tile(np.arange(faces.shape[0]), 3)
    nmax = int(faces.max()) + 1
    cand_keys = cand[:, 0] * nmax + cand[:, 1]
    pair_keys = f_pairs[:, 0] * nmax + f_pairs[:, 1]
    order = np.lexsort((face_ids, pair_keys))
    pair_keys_s = pair_keys[order]
    face_ids_s = face_ids[order]
    left = np.searchsorted(pair_keys_s, cand_keys, side="left")
    right = np.searchsorted(pair_keys_s, cand_keys, side="right")
    keep = (right - left) == 2
    v0 = cand[keep, 0]
    v1 = cand[keep, 1]
    fa = face_ids_s[left[keep]]
    fb = face_ids_s[left[keep] + 1]

    def third_vertex(face_rows, a, b):
        f = faces[face_rows]
        mask = (f != a[:, None]) & (f != b[:, None])
        return f[np.arange(f.shape[0]), np.argmax(mask, axis=1)]

    return DihedralQuadruples(
        v0.astype(np.int32), v1.astype(np.int32),
        third_vertex(fa, v0, v1).astype(np.int32),
        third_vertex(fb, v0, v1).astype(np.int32),
    )


class QuadGather(NamedTuple):
    """Device tables for gathering the four corners of E quadruples."""

    idx: torch.Tensor  # (4 * ep,) int64, sentinel slots clamped to N - 1
    inv: torch.Tensor  # (N, S) inverse incidence (sentinel slots excluded)
    e: int
    ep: int


def prepare_quad_gather(quads: DihedralQuadruples, n: int, device) -> QuadGather:
    e = int(np.asarray(quads.v0).shape[0])
    ep = -(-max(e, 1) // 128) * 128
    idx = np.full(4 * ep, n, np.int64)
    for j, f in enumerate((quads.v0, quads.v1, quads.v2, quads.v3)):
        idx[j * ep : j * ep + e] = np.asarray(f)
    inv = build_inverse_incidence(idx, n)
    return QuadGather(
        idx=torch.as_tensor(np.minimum(idx, n - 1), device=device),
        inv=torch.as_tensor(inv, device=device),
        e=e,
        ep=ep,
    )


def _dihedral_cos(vertices: torch.Tensor, qg: QuadGather, eps: float) -> torch.Tensor:
    ep = qg.ep
    g = gather_rows_inv(vertices, qg.idx, qg.inv).T  # (3, 4*ep)
    v0 = g[:, 0:ep]
    v1 = g[:, ep : 2 * ep]
    v2 = g[:, 2 * ep : 3 * ep]
    v3 = g[:, 3 * ep : 4 * ep]
    a = [v1[c] - v0[c] for c in range(3)]
    b1 = [v2[c] - v0[c] for c in range(3)]
    b2 = [v3[c] - v0[c] for c in range(3)]

    def residual(a, b):
        al2 = a[0] * a[0] + a[1] * a[1] + a[2] * a[2]
        bl2 = b[0] * b[0] + b[1] * b[1] + b[2] * b[2]
        al1 = torch.sqrt(al2 + eps)
        bl1 = torch.sqrt(bl2 + eps)
        ab = a[0] * b[0] + a[1] * b[1] + a[2] * b[2]
        cos = ab / (al1 * bl1 + eps)
        sin = torch.sqrt(1 - cos**2 + eps)
        s = ab / (al2 + eps)
        cb = [b[c] - a[c] * s for c in range(3)]
        return cb, bl1 * sin

    cb1, cb1l1 = residual(a, b1)
    cb2, cb2l1 = residual(a, b2)
    dot = cb1[0] * cb2[0] + cb1[1] * cb2[1] + cb1[2] * cb2[2]
    return (dot / (cb1l1 * cb2l1 + eps))[: qg.e]


def dihedral_cos(vertices: torch.Tensor, quads: DihedralQuadruples, eps: float = 1e-6) -> torch.Tensor:
    """Cosine of the dihedral angle across each shared edge -> (E,)
    (the double projection of loss_util.py:171-208)."""
    qg = prepare_quad_gather(quads, vertices.shape[0], vertices.device)
    return _dihedral_cos(vertices, qg, eps)


def flatten_loss(
    vertices: torch.Tensor, quads: DihedralQuadruples, threshold_deg: float = 0.0, eps: float = 1e-6
) -> torch.Tensor:
    """The hard flatten penalty sum (cos + 1)^2 over the shared edges, edges
    whose cosine is above cos(threshold_deg) exempt (FlattenLoss.forward);
    the unfused form of ``fused_flatten_loss``."""
    cos = dihedral_cos(vertices, quads, eps)
    threshold = math.cos(threshold_deg * math.pi / 180.0)
    cos = torch.where(cos > threshold, torch.full_like(cos, -1.0), cos)
    return torch.sum((cos + 1.0) ** 2)


def soft_flatten_loss(
    vertices: torch.Tensor, quads: DihedralQuadruples, cos_init: Optional[torch.Tensor] = None, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The soft flatten penalty against the initial dihedral angles
    (SoftFlattenLoss) -> (loss, the current cosines, detached), so that
    frame 0 can keep them as ``cos_init`` (reference train.py:364-368).
    Without ``cos_init`` it is the hard penalty sum (cos + 1)^2."""
    cos = dihedral_cos(vertices, quads, eps)
    if cos_init is not None:
        angle = torch.arccos(torch.clamp(cos, -1.0, 1.0))
        angle0 = torch.arccos(torch.clamp(cos_init, -1.0, 1.0))
        loss = torch.sum(1.0 - torch.cos(torch.abs(angle - angle0)))
    else:
        loss = torch.sum((cos + 1.0) ** 2)
    return loss, cos.detach()


class FusedFlatten(NamedTuple):
    """All dihedral flatten sets concatenated for one fused evaluation."""

    quads: DihedralQuadruples
    hard_sets: tuple
    soft_sets: tuple
    hard_segment: np.ndarray  # (Eh,) set index into hard_sets
    soft_segment: np.ndarray  # (Es,) set index into soft_sets
    num_hard: int


def build_fused_flatten(
    quadruples: Dict[str, DihedralQuadruples],
    hard_sets: Sequence[str],
    soft_sets: Sequence[str],
) -> FusedFlatten:
    hard_sets = tuple(k for k in hard_sets if k in quadruples)
    soft_sets = tuple(k for k in soft_sets if k in quadruples)

    def cat(names):
        qs = [quadruples[k] for k in names]
        seg = (
            np.concatenate([np.full(q.v0.shape[0], i, np.int32) for i, q in enumerate(qs)])
            if qs else np.zeros(0, np.int32)
        )
        fields = [
            np.concatenate([getattr(q, f) for q in qs]) if qs else np.zeros(0, np.int32)
            for f in ("v0", "v1", "v2", "v3")
        ]
        return DihedralQuadruples(*fields), seg

    hq, hseg = cat(hard_sets)
    sq, sseg = cat(soft_sets)
    quads = DihedralQuadruples(*(np.concatenate([h, s]) for h, s in zip(hq, sq)))
    return FusedFlatten(
        quads=quads, hard_sets=hard_sets, soft_sets=soft_sets,
        hard_segment=hseg, soft_segment=sseg, num_hard=int(hq.v0.shape[0]),
    )


def _segment_weights(names, segment, weights, like):
    seg = torch.as_tensor(segment, device=like.device)
    w = torch.zeros(seg.shape, dtype=torch.float32, device=like.device)
    for i, k in enumerate(names):
        w = torch.where(seg == i, weights[k], w)
    return w


def fused_flatten_loss(
    vertices: torch.Tensor,
    fused: FusedFlatten,
    weights: Dict[str, float],
    soft_cos_init: Optional[torch.Tensor] = None,  # (Es,) or None (frame 0)
    eps: float = 1e-6,
    gather: Optional[QuadGather] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (weighted total over all sets, detached current soft cosines (Es,)).

    Frame 0 (``soft_cos_init=None``): soft sets use (cos + 1)^2; later frames
    use 1 - cos|theta - theta_0|. ``gather`` is ``fused.quads``'s prepared
    corner gather (built here when absent).
    """
    if gather is None:
        gather = prepare_quad_gather(fused.quads, vertices.shape[0], vertices.device)
    cos = _dihedral_cos(vertices, gather, eps)
    nh = fused.num_hard
    hard_cos = torch.where(cos[:nh] > 1.0, torch.full_like(cos[:nh], -1.0), cos[:nh])
    hard_vals = (hard_cos + 1.0) ** 2
    hard_w = _segment_weights(fused.hard_sets, fused.hard_segment, weights, cos)
    soft_cos = cos[nh:]
    if soft_cos_init is None:
        soft_vals = (soft_cos + 1.0) ** 2
    else:
        soft_vals = 1.0 - torch.cos(
            torch.abs(
                torch.arccos(torch.clamp(soft_cos, -1.0, 1.0))
                - torch.arccos(torch.clamp(soft_cos_init, -1.0, 1.0))
            )
        )
    soft_w = _segment_weights(fused.soft_sets, fused.soft_segment, weights, cos)
    total = torch.sum(hard_vals * hard_w) + torch.sum(soft_vals * soft_w)
    return total, soft_cos.detach()


class FusedUmbrella(NamedTuple):
    """Umbrella sets fused via per-vertex coefficients:
    sum_k w_k MSE_k == sum_v c_v |ave_v - v|^2, c_v = sum_k w_k [v in R_k] / (3 |R_k|)."""

    neighbor_indices: np.ndarray  # (N, K)
    neighbor_mask: np.ndarray  # (N, K)
    neighbor_num: np.ndarray  # (N,)
    set_names: tuple
    coeff: np.ndarray  # (S, N)


def build_fused_umbrella(
    umbrellas: Dict[str, "UmbrellaFlatten"], set_names: Sequence[str]
) -> Optional[FusedUmbrella]:
    names = tuple(k for k in set_names if k in umbrellas)
    if not names:
        return None
    first = umbrellas[names[0]]
    n = first.neighbor_indices.shape[0]
    coeff = np.zeros((len(names), n), np.float32)
    for i, k in enumerate(names):
        reg = umbrellas[k].region
        coeff[i, reg] = 1.0 / (3.0 * reg.shape[0])
    return FusedUmbrella(
        neighbor_indices=first.neighbor_indices,
        neighbor_mask=first.neighbor_mask,
        neighbor_num=first.neighbor_num,
        set_names=names,
        coeff=coeff,
    )


def to_device(fused: FusedUmbrella, device) -> FusedUmbrella:
    """The umbrella tables as device tensors, transposed to (K, N)."""
    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return fused._replace(
        neighbor_indices=t(np.asarray(fused.neighbor_indices).T).to(torch.int64),
        neighbor_mask=t(np.asarray(fused.neighbor_mask).T),
        neighbor_num=t(fused.neighbor_num),
        coeff=t(fused.coeff),
    )


def fused_umbrella_loss(
    vertices: torch.Tensor, fused: FusedUmbrella, weights: Dict[str, float]
) -> torch.Tensor:
    """``fused`` in its device form (``to_device``)."""
    nb = _gather_rows_t(vertices, fused.neighbor_indices)  # (3, K, N)
    return fused_umbrella_from_nb(nb, vertices.T, fused, weights)


def fused_umbrella_from_nb(
    nb: torch.Tensor,  # (C >= 3, K, N) gathered one-ring data, comps 0-2 = xyz
    xt: torch.Tensor,  # (3, N)
    fused: FusedUmbrella,  # device form (``to_device``)
    weights: Dict[str, float],
) -> torch.Tensor:
    """Umbrella total from an existing one-ring gather (shared with the
    temporal losses when the index tables match)."""
    msk = fused.neighbor_mask
    num = fused.neighbor_num
    sq = torch.zeros_like(num)
    for c in range(3):
        # isolated vertices (num == 0) yield 0, not 0/0
        ave = torch.sum(nb[c] * msk, dim=0) / torch.clamp(num, min=1.0)
        d = ave - xt[c]
        sq = sq + d * d
    cf = None
    for s, k in enumerate(fused.set_names):
        term = weights[k] * fused.coeff[s]
        cf = term if cf is None else cf + term
    return torch.sum(cf * sq)


class UmbrellaFlatten(NamedTuple):
    """Precomputed state for FlattenLoss_v2 (loss_util.py:223-251)."""

    neighbor_indices: np.ndarray  # (N, K) padded with self
    neighbor_mask: np.ndarray  # (N, K) 1 for real neighbors
    neighbor_num: np.ndarray  # (N,)
    region: np.ndarray  # (R,) vertex indices the MSE runs over


def build_umbrella_flatten(
    neighbor_indices_ragged: Sequence[Sequence[int]],
    num_vertices: int,
    region: Optional[Sequence[int]] = None,
    ex_mask: Sequence[int] = (),
) -> UmbrellaFlatten:
    """Padded one-ring state + region selection (``region=None``: all vertices)."""
    max_k = max(len(lst) for lst in neighbor_indices_ragged)
    idx = np.zeros((num_vertices, max_k), np.int32)
    msk = np.zeros((num_vertices, max_k), np.float32)
    num = np.zeros((num_vertices,), np.float32)
    for i, lst in enumerate(neighbor_indices_ragged):
        k = len(lst)
        idx[i, :k] = lst
        idx[i, k:] = i
        msk[i, :k] = 1.0
        num[i] = k
    if region is None:
        reg = np.arange(num_vertices)
    else:
        reg = np.asarray(sorted(set(int(r) for r in region) - set(ex_mask)))
        if reg.size == 0:
            reg = np.arange(num_vertices)
    return UmbrellaFlatten(idx, msk, num, reg.astype(np.int32))


def umbrella_flatten_loss(vertices: torch.Tensor, state: UmbrellaFlatten) -> torch.Tensor:
    """The MSE between each region vertex and the mean of its one-ring
    (FlattenLoss_v2.forward); the unfused form of ``fused_umbrella_loss``."""
    dev = vertices.device
    idx = torch.as_tensor(state.neighbor_indices, dtype=torch.int64, device=dev)
    mask = torch.as_tensor(state.neighbor_mask, device=dev)
    num = torch.as_tensor(state.neighbor_num, device=dev)
    nbr = vertices[idx] * mask[..., None]
    ave = torch.sum(nbr, dim=1) / torch.clamp(num[:, None], min=1.0)
    reg = torch.as_tensor(state.region, dtype=torch.int64, device=dev)
    return torch.mean((ave[reg] - vertices[reg]) ** 2)
