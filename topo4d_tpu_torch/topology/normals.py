"""Area-weighted vertex normals (topology/normals.py): ``vertex_normals`` in
torch on the vertices' device, ``vertex_normals_np`` on the host (:37)."""

from __future__ import annotations

import numpy as np
import torch


def vertex_normals(vertices: torch.Tensor, tri_faces: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """(V, 3) x (F, 3) int -> (V, 3) unit normals (trimesh semantics): the
    cross-product face normals, area-weighted by their length, summed per
    vertex and normalized."""
    tri = tri_faces.to(torch.int64)
    v0, v1, v2 = vertices[tri[:, 0]], vertices[tri[:, 1]], vertices[tri[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0)
    acc = torch.zeros_like(vertices)
    for c in range(3):
        acc = acc.index_add(0, tri[:, c], fn)
    norm = torch.linalg.vector_norm(acc, dim=-1, keepdim=True)
    return acc / torch.clamp(norm, min=eps)


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
