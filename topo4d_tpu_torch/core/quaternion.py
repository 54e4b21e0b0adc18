"""Quaternion helpers used by the geometry path; (w, x, y, z) storage."""

from __future__ import annotations

import numpy as np
import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize quaternions along the last axis."""
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternions (..., 4) (w, x, y, z) -> rotation matrices (..., 3, 3),
    normalizing first (reference external.py:26-43)."""
    q = quat_normalize(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], dim=-1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], dim=-1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def normal_to_quat_reference(directions: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """The reference's ``build_quaterion`` rotation init from normals (host, NumPy).

    axis = cross(x_axis, dir) without normalizing the axis (its length is
    sin(angle)): an approximate x -> normal rotation that optimization then
    refines. Reproduced for trajectory parity.
    """
    d = np.asarray(directions, np.float32)
    unit = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), eps)
    x_axis = np.zeros_like(unit)
    x_axis[..., 0] = 1.0
    axes = np.cross(x_axis, unit)
    angles = np.arccos(np.clip(unit[..., 0], -1.0, 1.0))
    w = np.cos(angles / 2)
    xyz = axes * np.sin(angles / 2)[..., None]
    return np.concatenate([w[..., None], xyz], axis=-1).astype(np.float32)
