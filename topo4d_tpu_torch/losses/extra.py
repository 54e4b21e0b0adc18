"""Mesh regularizers off the default path (``losses/extra.py``).

The reference defines LaplacianLoss, ARAPLoss, EdgeLoss and NormLoss
(loss_util.py:9-111) and never calls them from train.py (SURVEY §1); they
are kept for parity with the JAX package. The tables (edges, a padded
one-ring with uniform weights, the rest pose's delta coordinates) are
built once on the host in NumPy; the losses are gathers on the tensors'
device, with no dense (V, V) Laplacian.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


class EdgeSet(NamedTuple):
    edges: np.ndarray  # (E, 2) unique edges as inserted


def build_edge_set(faces: np.ndarray) -> EdgeSet:
    """The edges of EdgeLoss (loss_util.py:80-88): (f0, f1), (f1, f2),
    (f0, f2) of every triangle, duplicates removed; a direction does not
    change a length."""
    faces = np.asarray(faces, np.int64)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [0, 2]]], axis=0)
    return EdgeSet(np.unique(e, axis=0).astype(np.int32))


def edge_loss(vertices: torch.Tensor, edge_set: EdgeSet, size_factor: float = 1.0) -> torch.Tensor:
    """The Bessel-corrected standard deviation of the edge lengths
    (EdgeLoss.forward, loss_util.py:91-98)."""
    x = vertices * size_factor
    e = torch.as_tensor(edge_set.edges, dtype=torch.int64, device=vertices.device)
    d = torch.linalg.vector_norm(x[e[:, 0]] - x[e[:, 1]], dim=-1)
    return torch.std(d, correction=1)


def norm_loss(x: torch.Tensor, norm: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """mean(1 - |cos(x, norm)|) (NormLoss.forward, loss_util.py:101-111)."""
    num = torch.sum(x * norm, dim=1)
    den = torch.clamp(torch.linalg.vector_norm(x, dim=1) * torch.linalg.vector_norm(norm, dim=1), min=eps)
    return torch.mean(1.0 - torch.abs(num / den))


class UniformLaplacian(NamedTuple):
    """A row-normalized adjacency as padded gathers."""

    neighbor_indices: np.ndarray  # (N, K), padded with the vertex itself
    neighbor_weight: np.ndarray  # (N, K), 1 / degree on real neighbours, 0 on padding
    delta_rest: Optional[np.ndarray] = None  # (N, 3) the rest pose's delta coordinates


def build_uniform_laplacian(vertices: np.ndarray, faces: np.ndarray) -> UniformLaplacian:
    """The uniform-weight graph Laplacian of a triangle mesh (the
    ``equal_weight`` variant of the reference's trimesh Laplacian,
    loss_util.py:13-15), with the rest pose's delta coordinates. Vertices
    that no face uses have no neighbours."""
    faces = np.asarray(faces, np.int64)
    nv = int(np.asarray(vertices).shape[0])
    adj = [set() for _ in range(nv)]
    for f in faces:
        for a in range(3):
            for b in range(3):
                if a != b:
                    adj[f[a]].add(int(f[b]))
    max_k = max(1, max(len(s) for s in adj))
    idx = np.zeros((nv, max_k), np.int32)
    wgt = np.zeros((nv, max_k), np.float32)
    for i, s in enumerate(adj):
        lst = sorted(s)
        k = len(lst)
        idx[i, :k] = lst
        idx[i, k:] = i
        if k:
            wgt[i, :k] = 1.0 / k
    v = np.asarray(vertices, np.float32)
    delta = np.einsum("nk,nkc->nc", wgt, v[idx]) - v
    return UniformLaplacian(idx, wgt, delta)


def laplacian_loss(vertices: torch.Tensor, lap: UniformLaplacian, mask: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The summed squared drift of the delta coordinates from the rest
    pose's (LaplacianLoss.forward), over the ``mask`` rows when given."""
    dev = vertices.device
    idx = torch.as_tensor(lap.neighbor_indices, dtype=torch.int64, device=dev)
    wgt = torch.as_tensor(lap.neighbor_weight, device=dev)
    delta = torch.einsum("nk,nkc->nc", wgt, vertices[idx]) - vertices
    diff = delta - torch.as_tensor(lap.delta_rest, device=dev)
    if mask is not None:
        diff = diff[torch.as_tensor(np.asarray(mask, np.int64), device=dev)]
    return torch.sum(diff**2)


def arap_loss(x: torch.Tensor, dx: torch.Tensor, lap: UniformLaplacian) -> torch.Tensor:
    """As-rigid-as-possible: the mean change of the squared one-ring edge
    lengths between ``x`` and ``x + dx`` (ARAPLoss, loss_util.py:38-73,
    over the one-ring instead of dense (V, V) difference matrices)."""
    dev = x.device
    idx = torch.as_tensor(lap.neighbor_indices, dtype=torch.int64, device=dev)
    real = torch.as_tensor(lap.neighbor_weight, device=dev) > 0
    ex = x[idx] - x[:, None]
    y = x + dx
    edx = y[idx] - y[:, None]
    diff = torch.abs(torch.sum(ex**2, -1) - torch.sum(edx**2, -1))
    return torch.sum(diff * real) / torch.clamp(torch.sum(real), min=1)
