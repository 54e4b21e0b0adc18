"""Area-weighted vertex normals (host NumPy; topology/normals.py:37)."""

from __future__ import annotations

import numpy as np


def vertex_normals_np(
    vertices: np.ndarray, tri_faces: np.ndarray, eps: float = 1e-12
) -> np.ndarray:
    """(V, 3) x (F, 3) int -> (V, 3) unit normals (trimesh semantics)."""
    v = np.asarray(vertices, np.float64)
    tri = np.asarray(tri_faces, np.int64)
    fn = np.cross(v[tri[:, 1]] - v[tri[:, 0]], v[tri[:, 2]] - v[tri[:, 0]])
    acc = np.zeros_like(v)
    for c in range(3):
        np.add.at(acc, tri[:, c], fn)
    norm = np.linalg.norm(acc, axis=-1, keepdims=True)
    return (acc / np.maximum(norm, eps)).astype(np.float32)
