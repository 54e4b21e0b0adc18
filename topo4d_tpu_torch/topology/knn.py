"""Brute-force nearest-neighbor distances for the init scale (topology/knn.py:59)."""

from __future__ import annotations

import numpy as np


def knn_sq_dists(points: np.ndarray, k: int, block: int = 512) -> np.ndarray:
    """Squared distances to each point's k nearest OTHER points -> (N, k).

    Exact float64 differences (no expanded-form cancellation); the query
    point is excluded by index, as the reference's KD-tree query does.
    """
    pts = np.asarray(points, np.float64)
    n = pts.shape[0]
    k_eff = min(k, n - 1)
    out = np.empty((n, k_eff), np.float64)
    for start in range(0, n, block):
        q = pts[start : start + block]
        d = np.sum((q[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
        d[np.arange(q.shape[0]), np.arange(start, start + q.shape[0])] = np.inf
        out[start : start + q.shape[0]] = np.sort(
            np.partition(d, k_eff - 1, axis=1)[:, :k_eff], axis=1
        )
    return out


def mean_knn_sq_dist(points: np.ndarray, k: int) -> np.ndarray:
    """Mean of k-NN squared distances, clipped at 1e-7 (reference train.py:133)."""
    return knn_sq_dists(points, k).mean(axis=-1).clip(min=1e-7).astype(np.float32)
