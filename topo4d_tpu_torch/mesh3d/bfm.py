"""The morphable-model (Basel Face Model) layer: load, generate, fit
(face3d morphable_model/; ``topo4d_tpu/mesh3d/bfm.py``).

The model is a NamedTuple of tensors on one device; generation is two
matrix-vector products; the pose, shape and expression fit is face3d's
alternation (an affine-camera Gold Standard pose, then ridge-regularised
linear solves, fit.py:162-211), in float32 on the model's device, with TF32
off (the package import turns it off).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from topo4d_tpu_torch.device import resolve_device
from topo4d_tpu_torch.mesh3d.transform import (
    angle2matrix,
    as_tensor,
    estimate_affine_matrix_3d22d,
    matrix2angle,
    p2srt,
    similarity_transform,
)


class MorphableModel(NamedTuple):
    """3DMM tensors in BFM's layout (morphabel_model.py:11-44).

    shape_mu: (3V,) mean shape (the BFM loader folds expMU in);
    shape_pc: (3V, n_sp); shape_ev: (n_sp,); exp_pc: (3V, n_ep);
    exp_ev: (n_ep,); tex_mu / tex_pc / tex_ev: the texture PCA (optional);
    triangles: (F, 3) int64, 0-based; kpt_ind: (68,) int64, 0-based.
    Vertex coordinates are interleaved xyz per vertex (BFM's Fortran
    flattening).
    """

    shape_mu: torch.Tensor
    shape_pc: torch.Tensor
    shape_ev: torch.Tensor
    exp_pc: torch.Tensor
    exp_ev: torch.Tensor
    triangles: torch.Tensor
    kpt_ind: Optional[torch.Tensor] = None
    tex_mu: Optional[torch.Tensor] = None
    tex_pc: Optional[torch.Tensor] = None
    tex_ev: Optional[torch.Tensor] = None

    @property
    def nver(self) -> int:
        return self.shape_mu.shape[0] // 3

    @property
    def n_shape_para(self) -> int:
        return self.shape_pc.shape[1]

    @property
    def n_exp_para(self) -> int:
        return self.exp_pc.shape[1]

    def to(self, device) -> "MorphableModel":
        """The same model on ``device``."""
        return MorphableModel(*(None if t is None else t.to(device) for t in self))


def load_bfm(model_path: str, device="cuda") -> MorphableModel:
    """Load a BFM ``.mat`` (face3d load.py:9-50) onto ``device``: expMU folded
    into the mean, float32, the base triangles only (``tri``; ``tri_mouth``
    is a supplement) transposed to (F, 3), 1-based indices shifted to 0."""
    import scipy.io as sio

    dev = resolve_device(device)
    c = sio.loadmat(model_path)["model"][0, 0]

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    def idx(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int64) - 1, device=dev)

    return MorphableModel(
        shape_mu=f32((c["shapeMU"] + c["expMU"]).reshape(-1)),
        shape_pc=f32(c["shapePC"]),
        shape_ev=f32(c["shapeEV"].reshape(-1)),
        exp_pc=f32(c["expPC"]),
        exp_ev=f32(c["expEV"].reshape(-1)),
        triangles=idx(c["tri"].T),
        kpt_ind=idx(np.squeeze(c["kpt_ind"])),
        tex_mu=f32(c["texMU"].reshape(-1)),
        tex_pc=f32(c["texPC"]),
        tex_ev=f32(c["texEV"].reshape(-1)),
    )


def generate_vertices(model: MorphableModel, shape_para, exp_para) -> torch.Tensor:
    """mu + shapePC @ sp + expPC @ ep -> (V, 3) (morphabel_model.py:63-74)."""
    dev = model.shape_mu.device
    flat = (
        model.shape_mu
        + model.shape_pc @ as_tensor(shape_para, dev).reshape(-1)
        + model.exp_pc @ as_tensor(exp_para, dev).reshape(-1)
    )
    return flat.reshape(-1, 3)


def generate_colors(model: MorphableModel, tex_para) -> torch.Tensor:
    """(texMU + texPC @ (tp * texEV)) / 255 -> (V, 3) (morphabel_model.py:84-94)."""
    flat = model.tex_mu + model.tex_pc @ (as_tensor(tex_para, model.tex_mu.device).reshape(-1) * model.tex_ev)
    return flat.reshape(-1, 3) / 255.0


def transform(model: MorphableModel, vertices: torch.Tensor, s, angles, t3d) -> torch.Tensor:
    """Similarity transform by degree Euler angles (morphabel_model.py:112-114)."""
    return similarity_transform(vertices, s, angle2matrix(angles, vertices.device), t3d)


def _ridge_coeff(pc_2d, sigma, x_flat, b_flat, lamb):
    """Solve (pc'pc + lamb diag(1 / sigma^2)) c = pc'(x - b) (fit.py:99-106)."""
    lhs = pc_2d.T @ pc_2d + lamb * torch.diag(1.0 / torch.square(sigma))
    rhs = pc_2d.T @ (x_flat - b_flat)
    return torch.linalg.solve(lhs, rhs)


def _project_pc(pc, a):
    """(3n, k) principal components -> (2n, k) image-plane components under
    the affine A (2, 3) (fit.py:83-88): each vertex's xyz rows meet A."""
    k = pc.shape[1]
    n = pc.shape[0] // 3
    return torch.einsum("ij,njk->nik", a, pc.reshape(n, 3, k)).reshape(2 * n, k)


def fit_points(
    x,
    x_ind,
    model: MorphableModel,
    n_sp: Optional[int] = None,
    n_ep: Optional[int] = None,
    max_iter: int = 4,
    lamb_exp: float = 20.0,
    lamb_shape: float = 40.0,
):
    """Alternating pose, expression and shape fit to 2D keypoints, on the
    model's device.

    x: (n, 2) image points; x_ind: (n,) model vertex indices. Each iteration
    estimates the affine camera from the current 3D shape (Gold Standard),
    decomposes it into s, R, t, then ridge-solves the expression (lamb 20)
    with the shape fixed and the shape (lamb 40) with the expression fixed,
    face3d's schedule (fit.py:162-211). Returns (sp, ep, s, R, t).
    """
    dev = model.shape_mu.device
    n_sp = n_sp if n_sp is not None else model.n_shape_para
    n_ep = n_ep if n_ep is not None else model.n_exp_para
    idx = torch.as_tensor(x_ind, device=dev).long().reshape(-1)
    rows = (3 * idx[:, None] + torch.arange(3, device=dev)[None, :]).reshape(-1)

    mu = model.shape_mu[rows]  # (3n,)
    spc = model.shape_pc[rows, :n_sp]  # (3n, n_sp)
    epc = model.exp_pc[rows, :n_ep]
    sev = model.shape_ev[:n_sp]
    eev = model.exp_ev[:n_ep]
    x = as_tensor(x, dev)
    x_flat = x.reshape(-1)  # (2n,) interleaved uv per point
    n = x.shape[0]

    sp = torch.zeros(n_sp, device=dev)
    ep = torch.zeros(n_ep, device=dev)
    s = torch.ones((), device=dev)
    r = torch.eye(3, device=dev)
    t = torch.zeros(3, device=dev)
    for _ in range(max_iter):
        x3d = (mu + spc @ sp + epc @ ep).reshape(n, 3)
        s, r, t = p2srt(estimate_affine_matrix_3d22d(x3d, x))
        a = s * r[:2, :]  # (2, 3) scaled orthographic camera

        # expression with the shape fixed
        base = (mu + spc @ sp).reshape(n, 3)
        b = (base @ a.T + t[None, :2]).reshape(-1)
        ep = _ridge_coeff(_project_pc(epc, a), eev, x_flat, b, lamb_exp)

        # shape with the expression fixed
        base = (mu + epc @ ep).reshape(n, 3)
        b = (base @ a.T + t[None, :2]).reshape(-1)
        sp = _ridge_coeff(_project_pc(spc, a), sev, x_flat, b, lamb_shape)
    return sp, ep, s, r, t


def fit(model: MorphableModel, x, x_ind, max_iter: int = 4):
    """``fit_points`` and the Euler decomposition of its rotation
    (morphabel_model.py:121-141) -> (sp, ep, s, (pitch, yaw, roll), t)."""
    sp, ep, s, r, t = fit_points(x, x_ind, model, max_iter=max_iter)
    return sp, ep, s, matrix2angle(r), t
