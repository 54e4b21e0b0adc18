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


def quat_mult(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of (..., 4) quaternions (reference helpers.py:137-144)."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (w, -x, -y, -z); the inverse of a unit quaternion."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def normal_to_quat(directions: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """The exact quaternion rotating +x onto each direction (..., 3) -> (..., 4).

    The half-way construction q = normalize([1 + <x, n>, cross(x, n)]); for
    n = -x (where it degenerates) a 180-degree rotation about +y.
    """
    unit = directions / torch.clamp(torch.linalg.vector_norm(directions, dim=-1, keepdim=True), min=eps)
    x_axis = torch.zeros_like(unit)
    x_axis[..., 0] = 1.0
    w = 1.0 + unit[..., 0]
    q = torch.cat([w[..., None], torch.linalg.cross(x_axis, unit, dim=-1)], dim=-1)
    fallback = torch.zeros_like(q)
    fallback[..., 2] = 1.0  # 180 degrees about +y
    q = torch.where((w < 1e-6)[..., None], fallback, q)
    return quat_normalize(q, eps)


def quaternion_similarity(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """The angle in degrees between two unit quaternions (helpers.py:133-135)."""
    dot = torch.clamp(torch.sum(q1 * q2, dim=-1), -1.0, 1.0)
    return torch.rad2deg(torch.arccos(torch.clamp(2.0 * dot**2 - 1.0, -1.0, 1.0)))
