"""Mesh transforms and pose estimation (face3d mesh/transform.py;
``topo4d_tpu/mesh3d/transform.py``).

Forward: rotate, similarity transform, look-at camera, projections, image
coordinates. Backward: the affine camera from 3D-2D correspondences (the
normalised Gold Standard algorithm, Hartley and Zisserman Alg. 7.2) and its
(s, R, t) decomposition, the pose step of the morphable-model fit.

Plain float32 functions on tensors, run on the device of their tensor
arguments. Arguments that are not tensors (angles as Python lists, a
translation, an eye position) become float32 tensors on that device; a
function whose only arguments are such values takes ``device``, "cuda" by
default, which raises without a card. Least squares go through one
formulation on every device (``lstsq``: an SVD with JAX's cut-off), which
gives the minimum-norm solution on rank-deficient systems as
``jnp.linalg.lstsq`` does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from topo4d_tpu_torch.device import resolve_device


def as_tensor(x, device) -> torch.Tensor:
    """``x`` as a float32 tensor: a tensor stays on its device, anything else
    goes to ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))


def _matrix(rows) -> torch.Tensor:
    """A (3, 3) tensor from nested rows of 0-d tensors and Python numbers."""
    ref = next(v for row in rows for v in row if isinstance(v, torch.Tensor))
    return torch.stack(
        [torch.stack([v if isinstance(v, torch.Tensor) else torch.full_like(ref, v) for v in row]) for row in rows]
    )


def angle2matrix(angles, device="cuda") -> torch.Tensor:
    """(3,) x/y/z Euler angles in degrees -> (3, 3) rotation, Rz @ Ry @ Rx.

    x pitch (positive looks down), y yaw (positive looks left), z roll
    (positive tilts right), face3d transform.py:18-43.
    """
    x, y, z = torch.deg2rad(as_tensor(angles, device))
    cx, sx, cy, sy, cz, sz = torch.cos(x), torch.sin(x), torch.cos(y), torch.sin(y), torch.cos(z), torch.sin(z)
    rx = _matrix([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = _matrix([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = _matrix([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return rz @ ry @ rx


def angle2matrix_3ddfa(angles, device="cuda") -> torch.Tensor:
    """The 3DDFA convention: radians, transposed per-axis factors, Rx @ Ry @ Rz
    (face3d transform.py:45-71)."""
    x, y, z = as_tensor(angles, device)
    cx, sx, cy, sy, cz, sz = torch.cos(x), torch.sin(x), torch.cos(y), torch.sin(y), torch.cos(z), torch.sin(z)
    rx = _matrix([[1, 0, 0], [0, cx, sx], [0, -sx, cx]])
    ry = _matrix([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]])
    rz = _matrix([[cz, sz, 0], [-sz, cz, 0], [0, 0, 1]])
    return rx @ ry @ rz


def rotate(vertices: torch.Tensor, angles) -> torch.Tensor:
    """Rotate (N, 3) vertices by degree Euler angles (transform.py:76-91)."""
    return vertices @ angle2matrix(angles, vertices.device).T


def similarity_transform(vertices: torch.Tensor, s, r, t3d) -> torch.Tensor:
    """s * R @ X + t, the 7-dof similarity (transform.py:93-108)."""
    t3d = as_tensor(t3d, vertices.device).reshape(3)
    return s * vertices @ as_tensor(r, vertices.device).T + t3d[None, :]


def lookat_camera(vertices: torch.Tensor, eye, at=None, up=None) -> torch.Tensor:
    """World -> camera space, the camera at ``eye`` looking at ``at`` down -z
    with ``up`` as vertical (transform.py:119-149)."""
    dev = vertices.device
    eye = as_tensor(eye, dev)
    at = torch.zeros(3, device=dev) if at is None else as_tensor(at, dev)
    up = torch.tensor([0.0, 1.0, 0.0], device=dev) if up is None else as_tensor(up, dev)

    def unit(v):
        return v / torch.clamp(torch.linalg.vector_norm(v), min=1e-12)

    z_axis = -unit(at - eye)
    x_axis = unit(torch.linalg.cross(up, z_axis))
    y_axis = torch.linalg.cross(z_axis, x_axis)
    r = torch.stack((x_axis, y_axis, z_axis))
    return (vertices - eye) @ r.T


def orthographic_project(vertices: torch.Tensor) -> torch.Tensor:
    """Scaled orthographic projection: the identity, z kept for the z-buffer
    (transform.py:153-165)."""
    return vertices


def perspective_project(
    vertices: torch.Tensor, fovy, aspect_ratio: float = 1.0, near: float = 0.1, far: float = 1000.0
) -> torch.Tensor:
    """OpenGL-frustum perspective to NDC, z negated back to a depth
    (transform.py:167-199)."""
    fovy = torch.deg2rad(as_tensor(fovy, vertices.device))
    top = near * torch.tan(fovy)
    right = top * aspect_ratio
    zero = torch.zeros_like(top)
    p = torch.stack([
        torch.stack([near / right, zero, zero, zero]),
        torch.stack([zero, near / top, zero, zero]),
        torch.stack([zero, zero, zero - (far + near) / (far - near), zero - 2 * far * near / (far - near)]),
        torch.stack([zero, zero, zero - 1.0, zero]),
    ])
    homo = torch.cat([vertices, torch.ones((vertices.shape[0], 1), dtype=vertices.dtype, device=vertices.device)], 1)
    proj = homo @ p.T
    proj = proj[:, :3] / proj[:, 3:]
    return proj * torch.tensor([1.0, 1.0, -1.0], device=vertices.device)


def to_image(vertices: torch.Tensor, h: int, w: int, is_perspective: bool = False) -> torch.Tensor:
    """Centre-origin (y up) coordinates -> image coordinates (y down, top-left
    origin), z untouched (transform.py:202-223)."""
    x, y, z = vertices[:, 0], vertices[:, 1], vertices[:, 2]
    if is_perspective:
        x = x * (w / 2)
        y = y * (h / 2)
    x = x + w / 2
    y = h - (y + h / 2) - 1
    return torch.stack([x, y, z], dim=1)


def lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The minimum-norm least-squares solution of ``a x = b`` through an SVD,
    singular values below ``eps * max(m, n)`` of the largest dropped: the
    formulation of ``jnp.linalg.lstsq`` with its default ``rcond``, on any
    device (``torch.linalg.lstsq`` assumes full rank on CUDA)."""
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    rcond = torch.finfo(a.dtype).eps * max(a.shape)
    keep = s >= rcond * s[0]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)), torch.zeros_like(s))
    ub = u.T @ (b if b.ndim == 2 else b[:, None])
    x = vh.T @ (s_inv[:, None] * ub)
    return x if b.ndim == 2 else x[:, 0]


def estimate_affine_matrix_3d23d(x3d: torch.Tensor, y3d: torch.Tensor) -> torch.Tensor:
    """(3, 4) affine from 3D-3D correspondences by least squares
    (transform.py:227-237)."""
    homo = torch.cat([x3d, torch.ones((x3d.shape[0], 1), dtype=x3d.dtype, device=x3d.device)], 1)
    return lstsq(homo, y3d).T


def estimate_affine_matrix_3d22d(x3d: torch.Tensor, x2d: torch.Tensor) -> torch.Tensor:
    """Gold Standard affine camera from n >= 4 3D-2D correspondences.

    Both point sets are mean- and scale-normalised (average norms sqrt(2)
    and sqrt(3)), the 8-dof system is solved by least squares and the
    normalisations are undone (transform.py:239-299). Returns (3, 4) with
    the last row [0, 0, 0, 1].
    """
    x2 = as_tensor(x2d, x3d.device)
    x3 = as_tensor(x3d, x3d.device)
    n = x2.shape[0]
    dev = x2.device

    mean2 = torch.mean(x2, 0)
    c2 = x2 - mean2
    spread2 = torch.clamp(torch.mean(torch.linalg.vector_norm(c2, dim=1)), min=1e-12)
    scale2 = torch.full((), math.sqrt(2.0), device=dev) / spread2
    c2 = c2 * scale2
    t_mat = torch.eye(3, device=dev)
    t_mat[0, 0] = scale2
    t_mat[1, 1] = scale2
    t_mat[:2, 2] = -mean2 * scale2

    mean3 = torch.mean(x3, 0)
    c3 = x3 - mean3
    spread3 = torch.clamp(torch.mean(torch.linalg.vector_norm(c3, dim=1)), min=1e-12)
    scale3 = torch.full((), math.sqrt(3.0), device=dev) / spread3
    c3 = c3 * scale3
    u_mat = torch.zeros((4, 4), device=dev)
    for k in range(3):
        u_mat[k, k] = scale3
    u_mat[:3, 3] = -mean3 * scale3
    u_mat[3, 3] = 1.0

    homo = torch.cat([c3, torch.ones((n, 1), device=dev)], 1)  # (n, 4)
    # the rows [u; v] decouple: two independent (n, 4) least-squares solves
    pu = lstsq(homo, c2[:, 0])
    pv = lstsq(homo, c2[:, 1])
    p_norm = torch.stack([pu, pv, torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)])
    return torch.linalg.inv(t_mat) @ (p_norm @ u_mat)


def p2srt(p: torch.Tensor):
    """(3, 4) affine camera -> (scale, (3, 3) rotation, (3,) translation)
    (transform.py:301-319)."""
    t = p[:, 3]
    r1 = p[0, :3]
    r2 = p[1, :3]
    n1 = torch.linalg.vector_norm(r1)
    n2 = torch.linalg.vector_norm(r2)
    s = (n1 + n2) / 2.0
    r1u = r1 / torch.clamp(n1, min=1e-12)
    r2u = r2 / torch.clamp(n2, min=1e-12)
    r3 = torch.linalg.cross(r1u, r2u)
    return s, torch.stack([r1u, r2u, r3]), t


def matrix2angle(r: torch.Tensor):
    """(3, 3) rotation -> (pitch, yaw, roll) in degrees, branch-free: a
    ``where`` takes the place of the reference's gimbal-lock branch
    (transform.py:331-356)."""
    sy = torch.sqrt(r[0, 0] ** 2 + r[1, 0] ** 2)
    singular = sy < 1e-6
    x = torch.where(singular, torch.atan2(-r[1, 2], r[1, 1]), torch.atan2(r[2, 1], r[2, 2]))
    y = torch.atan2(-r[2, 0], sy)
    z = torch.where(singular, torch.zeros_like(sy), torch.atan2(r[1, 0], r[0, 0]))
    to_deg = 180.0 / math.pi
    return x * to_deg, y * to_deg, z * to_deg
