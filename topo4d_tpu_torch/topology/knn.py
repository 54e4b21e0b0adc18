"""Nearest-neighbor distances for the init scales (topology/knn.py:59).

Exact float64 distances from a KD-tree (``scipy.spatial.cKDTree``): k = 1
for the ~8k geometry vertices, k = 4 for the ~280k dense texture points,
where a brute-force (N, N) pass would compare ~8e10 pairs.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def knn_sq_dists(points: np.ndarray, k: int) -> np.ndarray:
    """Squared distances to each point's k nearest OTHER points -> (N, k).

    The query point is excluded by index, as the reference's KD-tree query
    (helpers.py:154) drops it; a coincident duplicate is another point and
    stays.
    """
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    k_eff = min(k, n - 1)
    dist, idx = cKDTree(pts).query(pts, k=k_eff + 1)
    dist = dist.reshape(n, k_eff + 1)
    idx = idx.reshape(n, k_eff + 1)
    # drop the query's own column; where a duplicate displaced it from the
    # k + 1 results, drop the farthest instead
    own = idx == np.arange(n)[:, None]
    drop = np.where(own.any(axis=1), own.argmax(axis=1), k_eff)
    keep = np.ones_like(own)
    keep[np.arange(n), drop] = False
    return dist[keep].reshape(n, k_eff) ** 2


def mean_knn_sq_dist(points: np.ndarray, k: int) -> np.ndarray:
    """Mean of k-NN squared distances, clipped at 1e-7 (reference train.py:133)."""
    return knn_sq_dists(points, k).mean(axis=-1).clip(min=1e-7).astype(np.float32)
