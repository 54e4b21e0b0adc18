"""One-ring adjacency (host NumPy precompute; topology/adjacency.py).

Reference quirk kept: a quad connects all four of its vertices mutually,
diagonals included, since the rigid/rot/iso losses were tuned against it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Set

import numpy as np


def find_adjacent_vertices(
    num_vertices: int, faces: Sequence[Sequence[int]]
) -> List[List[int]]:
    """Per-vertex one-ring sets, sorted (all consumers are order-invariant sums)."""
    adj: List[Set[int]] = [set() for _ in range(num_vertices)]
    for face in faces:
        for v in face:
            adj[v].update(int(u) for u in face if u != v)
    return [sorted(s) for s in adj]


@dataclasses.dataclass
class OneRing:
    """Padded one-ring with the reference's neighbor weights."""

    indices: np.ndarray  # (N, K) int32, padded with self index
    dist: np.ndarray  # (N, K) float32 rest distances
    weight: np.ndarray  # (N, K) float32 exp(-2000 d^2), self-pads zeroed
    ragged: List[List[int]]


def pad_one_ring(ragged: List[List[int]]) -> np.ndarray:
    """Pad ragged neighbor lists with the vertex's own index (train.py:173-176)."""
    max_k = max(len(lst) for lst in ragged)
    out = np.empty((len(ragged), max_k), np.int32)
    for i, lst in enumerate(ragged):
        out[i, : len(lst)] = lst
        out[i, len(lst):] = i
    return out


def build_one_ring(
    vertices: np.ndarray,
    faces: Sequence[Sequence[int]],
    boundary_mask: Sequence[int] = (),
) -> OneRing:
    """One-ring indices + rest distances + Gaussian weights.

    For a vertex outside ``boundary_mask`` with a neighbor inside it, the
    weight uses the distance inflated x1000 (train.py:183-186); self-pads
    get weight 0 (train.py:196-197).
    """
    ragged = find_adjacent_vertices(vertices.shape[0], faces)
    idx = pad_one_ring(ragged)
    n = idx.shape[0]
    diffs = vertices[idx] - vertices[:, None]
    sq = np.sum(diffs * diffs, axis=-1)
    dist = np.sqrt(sq)
    wh_sq = sq.copy()
    if len(boundary_mask):
        inside = np.zeros(n, bool)
        inside[np.asarray(boundary_mask, np.int64)] = True
        cross = inside[idx] & ~inside[:, None]
        wh_sq = np.where(cross, sq * 1000.0**2, sq)
    weight = np.exp(-2000.0 * wh_sq)
    weight[weight == 1.0] = 0.0
    return OneRing(
        indices=idx.astype(np.int32),
        dist=dist.astype(np.float32),
        weight=weight.astype(np.float32),
        ragged=ragged,
    )


def inverse_slots(indices: np.ndarray) -> np.ndarray:
    """For each (v, j): the slot s with indices[indices[v, j], s] == v (the
    first such slot), or j where the slot pads v with itself.

    One-ring adjacency is symmetric and self-pads point at themselves, so
    the inverse exists; it turns the backward of ``x[indices]`` into a
    gather (``losses.neighbors.gather_neighbors``).
    """
    indices = np.asarray(indices, np.int64)
    n, k = indices.shape
    # (u, w) -> the first slot s of w in u's ring
    keys = np.arange(n)[:, None] * n + indices
    uniq, first = np.unique(keys.reshape(-1), return_index=True)
    want = indices * n + np.arange(n)[:, None]
    at = np.searchsorted(uniq, want)
    if not np.array_equal(uniq[np.minimum(at, uniq.size - 1)], want):
        raise ValueError("the one-ring indices are not symmetric")
    slot = first[at] % k
    return np.where(indices == np.arange(n)[:, None], np.arange(k)[None, :], slot).astype(np.int32)


def triangulate_faces(faces: Sequence[Sequence[int]]) -> List[List[int]]:
    """Fan-triangulate quads (q0,q1,q2)+(q0,q2,q3); keep triangles."""
    out: List[List[int]] = []
    for face in faces:
        if len(face) == 4:
            out.append([face[0], face[1], face[2]])
            out.append([face[0], face[2], face[3]])
        elif len(face) == 3:
            out.append(list(face))
    return out


def split_faces_by_mask(faces: np.ndarray, face_idx: np.ndarray, mask: Sequence[int]):
    """(faces touching the mask, their ids, the others, their ids): the
    reference's ``get_face_faces`` (helpers.py:361-378), which picks the
    frontal quads for UV densification (train.py:222-224)."""
    faces = np.asarray(faces)
    face_idx = np.asarray(face_idx)
    touching = _to_bool(faces, mask).any(axis=1)
    return (
        faces[touching],
        face_idx[touching].astype(np.int32),
        faces[~touching],
        face_idx[~touching].astype(np.int32),
    )


def faces_fully_inside(faces: np.ndarray, mask: Sequence[int]) -> np.ndarray:
    """The faces whose vertices are all in ``mask`` (reference ``vertex2face``)."""
    return np.asarray(faces)[_to_bool(faces, mask).all(axis=1)]


def faces_touching(faces: np.ndarray, mask: Sequence[int]) -> np.ndarray:
    """The faces with any vertex in ``mask`` (reference ``vertex2face_more``)."""
    return np.asarray(faces)[_to_bool(faces, mask).any(axis=1)]


def _to_bool(faces: np.ndarray, mask: Sequence[int]) -> np.ndarray:
    """Per face corner: is its vertex in ``mask``."""
    faces = np.asarray(faces)
    mask_ids = np.asarray(list(mask), np.int64)
    if faces.size == 0:
        return np.zeros(faces.shape, bool)
    # size by both: a masked id may exceed every id of this face subset
    n = int(faces.max()) + 1
    if mask_ids.size:
        n = max(n, int(mask_ids.max()) + 1)
    lut = np.zeros(n, bool)
    lut[mask_ids] = True
    return lut[faces]
