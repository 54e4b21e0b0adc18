"""Pinhole camera (COLMAP axes) holding tensors; counterpart of core/camera.py.

World-to-camera ``w2c``, intrinsics in pixels, an OpenGL-style projection
with near 0.01 / far 100, and the rasterizer's ``ndc2Pix`` mapping
``((ndc + 1) * size - 1) * 0.5``. Fields may carry a leading view axis; index
a rig with ``cams[i]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from topo4d_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Camera:
    """A (possibly batched) pinhole camera; tensors share one device."""

    w2c: torch.Tensor  # (..., 4, 4)
    fx: torch.Tensor  # (...,)
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int
    near: float = 0.01
    far: float = 100.0

    @property
    def device(self) -> torch.device:
        return self.w2c.device

    @property
    def tan_fovx(self) -> torch.Tensor:
        return self.width / (2.0 * self.fx)

    @property
    def tan_fovy(self) -> torch.Tensor:
        return self.height / (2.0 * self.fy)

    @property
    def cam_center(self) -> torch.Tensor:
        """The camera's center in world coordinates: -R^T t."""
        rot = self.w2c[..., :3, :3]
        t = self.w2c[..., :3, 3]
        return -torch.einsum("...ji,...j->...i", rot, t)

    def __getitem__(self, idx) -> "Camera":
        """Index a batched camera down to a single view."""
        return dataclasses.replace(
            self, w2c=self.w2c[idx], fx=self.fx[idx], fy=self.fy[idx],
            cx=self.cx[idx], cy=self.cy[idx],
        )


def make_camera(
    k: np.ndarray,
    w2c: np.ndarray,
    width: int,
    height: int,
    near: float = 0.01,
    far: float = 100.0,
    device="cuda",
) -> Camera:
    """Camera from (..., 3, 3) intrinsics and (..., 3|4, 4) extrinsics."""
    dev = resolve_device(device)
    k = np.asarray(k)
    w2c = np.asarray(w2c)
    if w2c.shape[-2] == 3:
        pad = np.broadcast_to(np.array([0.0, 0.0, 0.0, 1.0]), w2c.shape[:-2] + (1, 4))
        w2c = np.concatenate([w2c, pad], axis=-2)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return Camera(
        w2c=t(w2c), fx=t(k[..., 0, 0]), fy=t(k[..., 1, 1]),
        cx=t(k[..., 0, 2]), cy=t(k[..., 1, 2]),
        width=int(width), height=int(height), near=near, far=far,
    )


def opengl_projection_matrix(cam: Camera) -> torch.Tensor:
    """The reference's OpenGL-style projection (helpers.py:68-71)."""
    w, h = cam.width, cam.height
    near, far = cam.near, cam.far
    zeros = torch.zeros_like(cam.fx)
    ones = torch.ones_like(cam.fx)
    row0 = torch.stack(
        [2 * cam.fx / w, zeros, -(w - 2 * cam.cx) / w * ones, zeros], dim=-1
    )
    row1 = torch.stack(
        [zeros, 2 * cam.fy / h, -(h - 2 * cam.cy) / h * ones, zeros], dim=-1
    )
    row2 = torch.stack(
        [zeros, zeros, far / (far - near) * ones, -(far * near) / (far - near) * ones],
        dim=-1,
    )
    row3 = torch.stack([zeros, zeros, ones, zeros], dim=-1)
    return torch.stack([row0, row1, row2, row3], dim=-2)


def full_projection_matrix(cam: Camera) -> torch.Tensor:
    """proj @ w2c: world -> clip space (reference ``full_proj``)."""
    return opengl_projection_matrix(cam) @ cam.w2c


def ndc_to_pixel(ndc: torch.Tensor, size: int) -> torch.Tensor:
    """The rasterizer's ndc2Pix: ((ndc + 1) * size - 1) / 2."""
    return ((ndc + 1.0) * size - 1.0) * 0.5


def world_to_view(cam: Camera, points: torch.Tensor) -> torch.Tensor:
    """(N, 3) world points in camera coordinates (a leading view axis of
    ``cam`` carries over)."""
    return torch.einsum("...ij,nj->...ni", cam.w2c[..., :3, :3], points) + cam.w2c[..., None, :3, 3]


def project_points(cam: Camera, points: torch.Tensor):
    """(N, 3) world points -> (pixel coordinates (N, 2), view z (N,)): the
    rasterizer's homogeneous path (the clip-space w divide with its 1e-7
    guard, ``ndc_to_pixel``)."""
    proj = full_projection_matrix(cam)
    homp = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    clip = torch.einsum("...ij,nj->...ni", proj, homp)
    inv_w = 1.0 / (clip[..., 3] + 1e-7)
    ndc = clip[..., :3] * inv_w[..., None]
    pix = torch.stack([ndc_to_pixel(ndc[..., 0], cam.width), ndc_to_pixel(ndc[..., 1], cam.height)], dim=-1)
    view_z = torch.einsum("...j,nj->...n", cam.w2c[..., 2, :3], points) + cam.w2c[..., None, 2, 3]
    return pix, view_z
