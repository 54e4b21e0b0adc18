"""Gaussian activation and EWA screen-space projection (core/gaussian.py).

quaternion + log-scale -> 3D covariance, EWA splatting to a 2D conic with
the 0.3-pixel dilation, 3-sigma radius and the z > 0.2 cull. Component form
with the same operation order as the reference, differentiable by autograd.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from topo4d_tpu_torch.core.camera import Camera, full_projection_matrix, ndc_to_pixel
from topo4d_tpu_torch.core.quaternion import quat_normalize, quat_to_rotmat

# diff-gaussian-rasterization constants (forward.cu semantics).
COV2D_DILATION = 0.3  # low-pass dilation added to the 2D covariance diagonal
NEAR_CULL_Z = 0.2  # view-space z threshold for frustum culling
ALPHA_MAX = 0.99  # per-splat opacity clamp
ALPHA_MIN = 1.0 / 255.0  # splats fainter than this are skipped
TRANSMITTANCE_MIN = 1e-4  # front-to-back blending termination threshold


class GaussianRenderVars(NamedTuple):
    """Activated per-Gaussian render inputs."""

    means3d: torch.Tensor  # (N, 3)
    colors: torch.Tensor  # (N, 3)
    rotations: torch.Tensor  # (N, 4) normalized quaternions
    opacities: torch.Tensor  # (N,)
    scales: torch.Tensor  # (N, 3)


def activate_params(params: Dict[str, torch.Tensor]) -> GaussianRenderVars:
    """params -> rendervars: sigmoid / exp / normalize (reference helpers.py:91-100)."""
    return GaussianRenderVars(
        means3d=params["means3D"],
        colors=params["rgb_colors"],
        rotations=quat_normalize(params["unnorm_rotations"]),
        opacities=torch.sigmoid(params["logit_opacities"]).reshape(-1),
        scales=torch.exp(params["log_scales"]),
    )


def build_cov3d(rotations: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The 3D covariance R S S^T R^T from quaternions and scales -> (N, 3, 3)."""
    m = quat_to_rotmat(rotations) * scales[..., None, :]
    return m @ m.transpose(-1, -2)


class Projected(NamedTuple):
    """Screen-space Gaussians for one view."""

    means2d: torch.Tensor  # (N, 2) pixel centers
    depths: torch.Tensor  # (N,) view-space z
    conics: torch.Tensor  # (N, 3) inverse 2D covariance (a, b, c)
    radii: torch.Tensor  # (N,) int32 pixel radius; 0 = culled
    mask: torch.Tensor  # (N,) bool, True = visible

    def detach(self) -> "Projected":
        return Projected(*(t.detach() for t in self))


def project_gaussians(
    rv: GaussianRenderVars,
    cam: Camera,
    means2d_offset: Optional[torch.Tensor] = None,
) -> Projected:
    """EWA projection of 3D Gaussians to screen space for one view.

    ``means2d_offset``: an optional zero (N, 2) tensor added to the pixel
    centers so its gradient carries the screen-space positional gradient.
    """
    x, y, z3 = rv.means3d.unbind(-1)
    w2c = cam.w2c
    tvx = w2c[0, 0] * x + w2c[0, 1] * y + w2c[0, 2] * z3 + w2c[0, 3]
    tvy = w2c[1, 0] * x + w2c[1, 1] * y + w2c[1, 2] * z3 + w2c[1, 3]
    tvz = w2c[2, 0] * x + w2c[2, 1] * y + w2c[2, 2] * z3 + w2c[2, 3]
    depths = tvz
    visible = depths > NEAR_CULL_Z

    proj = full_projection_matrix(cam)
    ph0 = proj[0, 0] * x + proj[0, 1] * y + proj[0, 2] * z3 + proj[0, 3]
    ph1 = proj[1, 0] * x + proj[1, 1] * y + proj[1, 2] * z3 + proj[1, 3]
    ph3 = proj[3, 0] * x + proj[3, 1] * y + proj[3, 2] * z3 + proj[3, 3]
    inv_w = 1.0 / (ph3 + 1e-7)
    m2x = ndc_to_pixel(ph0 * inv_w, cam.width)
    m2y = ndc_to_pixel(ph1 * inv_w, cam.height)
    if means2d_offset is not None:
        m2x = m2x + means2d_offset[:, 0]
        m2y = m2y + means2d_offset[:, 1]

    safe_z = torch.where(visible, depths, torch.ones_like(depths))
    limx = 1.3 * cam.tan_fovx
    limy = 1.3 * cam.tan_fovy
    tx = torch.clamp(tvx / safe_z, -limx, limx) * safe_z
    ty = torch.clamp(tvy / safe_z, -limy, limy) * safe_z

    q0, q1, q2, q3 = rv.rotations.unbind(-1)
    qn = torch.sqrt(q0**2 + q1**2 + q2**2 + q3**2)
    r, qx, qy, qz = q0 / qn, q1 / qn, q2 / qn, q3 / qn
    s0, s1, s2 = rv.scales.unbind(-1)
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - r * qz)
    r02 = 2 * (qx * qz + r * qy)
    r10 = 2 * (qx * qy + r * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - r * qx)
    r20 = 2 * (qx * qz - r * qy)
    r21 = 2 * (qy * qz + r * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    m00, m01, m02 = r00 * s0, r01 * s1, r02 * s2
    m10, m11, m12 = r10 * s0, r11 * s1, r12 * s2
    m20, m21, m22 = r20 * s0, r21 * s1, r22 * s2
    c00 = m00 * m00 + m01 * m01 + m02 * m02
    c01 = m00 * m10 + m01 * m11 + m02 * m12
    c02 = m00 * m20 + m01 * m21 + m02 * m22
    c11 = m10 * m10 + m11 * m11 + m12 * m12
    c12 = m10 * m20 + m11 * m21 + m12 * m22
    c22 = m20 * m20 + m21 * m21 + m22 * m22

    izz = 1.0 / (safe_z * safe_z)
    j00 = cam.fx / safe_z
    j02 = -cam.fx * tx * izz
    j11 = cam.fy / safe_z
    j12 = -cam.fy * ty * izz
    a0 = j00 * w2c[0, 0] + j02 * w2c[2, 0]
    a1 = j00 * w2c[0, 1] + j02 * w2c[2, 1]
    a2 = j00 * w2c[0, 2] + j02 * w2c[2, 2]
    b0 = j11 * w2c[1, 0] + j12 * w2c[2, 0]
    b1 = j11 * w2c[1, 1] + j12 * w2c[2, 1]
    b2 = j11 * w2c[1, 2] + j12 * w2c[2, 2]
    u0 = c00 * a0 + c01 * a1 + c02 * a2
    u1 = c01 * a0 + c11 * a1 + c12 * a2
    u2 = c02 * a0 + c12 * a1 + c22 * a2
    v0 = c00 * b0 + c01 * b1 + c02 * b2
    v1 = c01 * b0 + c11 * b1 + c12 * b2
    v2 = c02 * b0 + c12 * b1 + c22 * b2
    # dilation on both diagonal entries (forward.cu computeCov2D)
    cov_a = a0 * u0 + a1 * u1 + a2 * u2 + COV2D_DILATION
    cov_b = a0 * v0 + a1 * v1 + a2 * v2
    cov_c = b0 * v0 + b1 * v1 + b2 * v2 + COV2D_DILATION

    det = cov_a * cov_c - cov_b * cov_b
    nonzero = det != 0.0
    visible = visible & nonzero
    inv_det = 1.0 / torch.where(nonzero, det, torch.ones_like(det))

    # 3-sigma extent from the larger eigenvalue (forward.cu radius rule)
    mid = 0.5 * (cov_a + cov_c)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lambda1))

    on_image = (
        (m2x + radius_f >= 0)
        & (m2x - radius_f < cam.width)
        & (m2y + radius_f >= 0)
        & (m2y - radius_f < cam.height)
    )
    visible = visible & on_image
    radii = torch.where(visible, radius_f, torch.zeros_like(radius_f)).to(torch.int32)
    return Projected(
        means2d=torch.stack([m2x, m2y], dim=-1),
        depths=depths,
        conics=torch.stack([cov_c * inv_det, -cov_b * inv_det, cov_a * inv_det], dim=-1),
        radii=radii,
        mask=visible,
    )
