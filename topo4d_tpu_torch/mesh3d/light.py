"""Vertex lighting (face3d mesh/light.py; ``topo4d_tpu/mesh3d/light.py``).

Gouraud point-light shading and spherical-harmonics irradiance over
per-vertex albedo, in float32 on the device of the vertices. Face normals
are summed into their vertices with ``index_add_``, which on the card uses
atomics: the sums there are not bit for bit those of the CPU (the tests
hold them at rtol 1e-5 / atol 1e-6). A vertex that touches no face gets
face3d's +x axis.
"""

from __future__ import annotations

import torch

from topo4d_tpu_torch.mesh3d.transform import as_tensor


def get_normal(vertices: torch.Tensor, triangles) -> torch.Tensor:
    """(V, 3) x (F, 3) -> (V, 3) unit vertex normals.

    face3d semantics (light.py:14-42): the unnormalised face cross products
    summed per vertex; a vertex that touches no face gets the +x axis.
    """
    tri = torch.as_tensor(triangles, device=vertices.device).long()
    p0, p1, p2 = vertices[tri[:, 0]], vertices[tri[:, 1]], vertices[tri[:, 2]]
    fn = torch.linalg.cross(p0 - p1, p0 - p2)  # (F, 3)
    acc = torch.zeros_like(vertices)
    for k in range(3):
        acc.index_add_(0, tri[:, k], fn)
    mag = torch.sum(acc**2, dim=1)
    zero = mag == 0
    acc = torch.where(zero[:, None], torch.tensor([1.0, 0.0, 0.0], dtype=vertices.dtype, device=vertices.device), acc)
    mag = torch.where(zero, torch.ones_like(mag), mag)
    return acc / torch.sqrt(mag)[:, None]


def add_light(
    vertices: torch.Tensor,
    triangles,
    colors: torch.Tensor,
    light_positions,
    light_intensities,
) -> torch.Tensor:
    """Gouraud diffuse point lights, clipped to [0, 1] (light.py:76-115).

    Lambertian: per light l, albedo * (n . direction) * intensity(l), summed
    over the lights. The reference's direction (vertex - light) is kept: it
    is part of the contract.
    """
    dev = vertices.device
    positions, intensities = as_tensor(light_positions, dev), as_tensor(light_intensities, dev)
    normals = get_normal(vertices, triangles)  # (V, 3)
    dirs = vertices[None, :, :] - positions[:, None, :]  # (L, V, 3)
    dirs = dirs / torch.clamp(torch.linalg.vector_norm(dirs, dim=2, keepdim=True), min=1e-12)
    ndl = torch.einsum("vc,lvc->lv", normals, dirs)  # (L, V)
    lit = torch.einsum("vc,lv,lc->vc", colors, ndl, intensities)
    return torch.clamp(lit, 0.0, 1.0)


def sh_basis(normals: torch.Tensor) -> torch.Tensor:
    """(V, 3) unit normals -> (V, 9) real SH basis (light.py:45-73):
    (1, nx, ny, nz, nx ny, nx nz, ny nz, nx^2 - ny^2, 3 nz^2 - 1)."""
    nx, ny, nz = normals[:, 0], normals[:, 1], normals[:, 2]
    return torch.stack(
        [torch.ones_like(nx), nx, ny, nz, nx * ny, nx * nz, ny * nz, nx**2 - ny**2, 3 * nz**2 - 1], dim=1
    )


def add_light_sh(vertices: torch.Tensor, triangles, colors: torch.Tensor, sh_coeff) -> torch.Tensor:
    """Lambertian SH lighting: albedo * (Y(n) @ sh_coeff) (light.py:45-73,
    with the reference's undefined name replaced by the basis it documents)."""
    normals = get_normal(vertices, triangles)
    ref = sh_basis(normals) @ as_tensor(sh_coeff, vertices.device).reshape(9, 1)  # (V, 1)
    return colors * ref


def fit_light_sh(observed: torch.Tensor, albedo: torch.Tensor, normals: torch.Tensor, lamb: float = 10.0):
    """Ridge-solve 9 SH coefficients from per-vertex observations.

    min ||observed - albedo * (Y(n) @ c)||^2 + lamb ||c||^2 over the given
    (visible) vertices, channels stacked: a working version of the
    reference's unfinished ``fit_light`` (light.py:121-212).
    observed, albedo: (V, C); normals: (V, 3) -> (9,).
    """
    basis = sh_basis(normals)  # (V, 9)
    a = (albedo[:, :, None] * basis[:, None, :]).reshape(-1, 9)  # (V * C, 9)
    y = observed.reshape(-1)
    lhs = a.T @ a + lamb * torch.eye(9, dtype=a.dtype, device=a.device)
    return torch.linalg.solve(lhs, a.T @ y)
