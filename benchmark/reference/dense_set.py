"""The dense texture Gaussians, worked out from the mesh in plain NumPy.

The reference's UV densification (Topo4D ``helpers.py`` ``build_dense_vertices_2``):
every frontal quad (a quad with a vertex in ``face_masks``) is cut into a
(d + 1) x (d + 1) grid of quads by bilinear interpolation. The d points
inside an edge are shared by the quads on either side, unless the edge
crosses a UV seam (both of its vertices carry more than one UV
coordinate), where each quad keeps its own. The dense set is every mesh
vertex, then the edge points, then each quad's d^2 interior points.

Each dense point is a weighted sum of at most four mesh vertices (``idx``,
``w``), so its position, and its first colour, follow the mesh. The
initial attributes are the reference's (``train.py:244-263``): colours
interpolated from the mesh's with the static, dynamic and inner-mouth
vertices black, opacity 0.9999, isotropic scales sqrt(mean squared
distance to the 4 nearest other points), identity rotations.

The order of the points is this module's own; every comparison the
benchmark makes is of norms and sums, which no order changes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.spatial import cKDTree

EDGES = ((0, 1), (1, 2), (3, 2), (0, 3))  # quad corner pairs: (t: 0 -> 1, u = 0), ...
OPACITY = 0.9999


@dataclasses.dataclass
class DenseSet:
    idx: np.ndarray  # (P, 4) int64 mesh vertices of each dense point
    w: np.ndarray  # (P, 4) float32 their weights
    pos0: np.ndarray  # (P, 3) float32 positions on the template mesh
    num_mesh: int


def uv_multiplicity(n: int, faces, uv_faces, uvs) -> np.ndarray:
    """Distinct UV coordinates (to 8 decimals) of each vertex."""
    seen = [set() for _ in range(n)]
    for f, uf in zip(faces, uv_faces):
        for v, t in zip(f, uf):
            seen[v].add(tuple(np.round(uvs[t], 8)))
    return np.array([len(s) for s in seen], np.int64)


def bilinear(t: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Weights of corners c0..c3 at (t, u): t runs c0 -> c1, u runs c0 -> c3."""
    return np.stack([(1 - t) * (1 - u), t * (1 - u), t * u, (1 - t) * u], -1)


def densify(verts, faces, uvs, uv_faces, face_mask, density: int) -> DenseSet:
    n = verts.shape[0]
    d = int(density)
    quads = np.asarray([f for f in faces if len(f) == 4], np.int64)
    mark = np.zeros(n, bool)
    mark[np.asarray(face_mask, np.int64)] = True
    quads = quads[mark[quads].any(1)]
    mult = uv_multiplicity(n, faces, uv_faces, uvs)
    m = np.arange(1, d + 1, dtype=np.float64) / (d + 1)

    idx_parts, w_parts = [np.arange(n)[:, None].repeat(4, 1)], [np.tile([1.0, 0.0, 0.0, 0.0], (n, 1))]
    # edges: a shared edge once, from its lower vertex id to its higher; a
    # seam edge once per quad, from its first corner to its second
    a = np.concatenate([quads[:, i] for i, _ in EDGES])
    b = np.concatenate([quads[:, j] for _, j in EDGES])
    shared = (mult[a] == 1) | (mult[b] == 1)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    keys = np.unique(lo[shared] * (n + 1) + hi[shared])
    ends = [(keys // (n + 1), keys % (n + 1)), (a[~shared], b[~shared])]
    for ea, eb in ends:
        e = ea.shape[0]
        idx_parts.append(np.stack([np.repeat(ea, d), np.repeat(eb, d), np.repeat(ea, d), np.repeat(ea, d)], 1))
        mm = np.tile(m, e)
        w_parts.append(np.stack([1 - mm, mm, np.zeros_like(mm), np.zeros_like(mm)], 1))
    # interiors: row-major grid points (i, j), 1 <= i, j <= d, of every quad
    ii, jj = np.meshgrid(m, m, indexing="ij")
    wq = bilinear(ii.reshape(-1), jj.reshape(-1))
    idx_parts.append(np.repeat(quads, d * d, axis=0))
    w_parts.append(np.tile(wq, (quads.shape[0], 1)))

    idx = np.concatenate(idx_parts)
    w = np.concatenate(w_parts)
    pos0 = np.einsum("pk,pkc->pc", w, verts[idx].astype(np.float64)).astype(np.float32)
    pos0[:n] = verts
    return DenseSet(idx=idx, w=w.astype(np.float32), pos0=pos0, num_mesh=n)


def knn_log_scales(points: np.ndarray, k: int = 4) -> np.ndarray:
    """log sqrt(mean squared distance to the k nearest other points,
    clipped at 1e-7), per point, from a float64 KD-tree; the query point is
    dropped by index, a coincident copy of it is another point."""
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    dist, nbr = cKDTree(pts).query(pts, k=k + 1)
    own = nbr == np.arange(n)[:, None]
    drop = np.where(own.any(1), own.argmax(1), k)
    keep = np.ones_like(own)
    keep[np.arange(n), drop] = False
    msq = (dist[keep].reshape(n, k) ** 2).mean(1).clip(min=1e-7).astype(np.float32)
    return np.log(np.sqrt(msq)).astype(np.float32)


def black_vertices(regions) -> np.ndarray:
    """The mesh vertices whose dense colour is held at 0: static, dynamic
    and inner mouth."""
    return np.unique(np.concatenate([regions[k] for k in ("static_masks", "dynamic_masks", "mouth_inner_masks")]))
