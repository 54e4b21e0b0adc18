"""Mesh and texture export (``pipeline/export.py``; reference ``save_mesh``,
helpers.py:963-998).

For frames other than 1 the exported vertices move along their normals by
the Gaussian's half-extent along the normal (clamped to [0, 1e-3]), which
makes up for the splat's thickness; the inverse global transform maps them
back to the capture frame. The OBJ keeps the original quad-dominant
topology and UVs, byte-identical across frames.

The texture bake (``write_texture``) goes, with ``backend`` "auto" or
"pallas", through ``bake_canvas`` (``texture/bake_tiled.py``): kernel K6 for
colors on the card, its plain version for colors on the CPU; with "xla",
through the banded scatter bake (``texture/bake.py``) on the colors' device.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from topo4d_tpu_torch.core.quaternion import quat_to_rotmat
from topo4d_tpu_torch.config import check_bake_backend
from topo4d_tpu_torch.pipeline.scene import SceneStatics
from topo4d_tpu_torch.texture.bake import bake_texture
from topo4d_tpu_torch.texture.bake_tiled import BakeBinning, bake_canvas, compute_bake_binning, process_uv
from topo4d_tpu_torch.topology.normals import vertex_normals
from topo4d_tpu_torch.topology.obj_io import write_obj_with_uv
from topo4d_tpu_torch.utils.png import write_png

@torch.no_grad()
def exported_vertices(
    means3d: torch.Tensor,
    log_scales: torch.Tensor,
    unnorm_rotations: torch.Tensor,
    tri_faces: torch.Tensor,
    inv_trans_g: torch.Tensor,  # (4, 4)
    apply_cast: bool,  # frames other than 1
) -> torch.Tensor:
    """Normal-offset, inverse-global-transform vertex positions (V, 3)."""
    normals = vertex_normals(means3d, tri_faces)
    scales = torch.exp(log_scales)
    rots = quat_to_rotmat(unnorm_rotations)
    # R^-1 n = R^T n
    n_rot = torch.einsum("nji,nj->ni", rots, normals)
    cast = torch.sqrt(1.0 / torch.sum((n_rot**2) / (scales**2), dim=1))
    cast = torch.clamp(cast, 0.0, 1e-3)
    verts = means3d + (1.0 if apply_cast else 0.0) * cast[:, None] * normals
    return verts @ inv_trans_g[:3, :3].T + inv_trans_g[:3, 3]


def uv_to_vertex(statics: SceneStatics) -> np.ndarray:
    """(U,) vertex index of each dense UV slot through the dense faces, with
    NumPy's last write winning on shared slots (the reference's
    duplicate_texture_vertex_color_2, helpers.py:930-941)."""
    uv2vert = np.zeros(statics.dense.topo.dense_uvs.shape[0], np.int64)
    uv2vert[np.asarray(statics.dense.tri_uv_faces).reshape(-1)] = np.asarray(statics.dense.tri_faces).reshape(-1)
    return uv2vert


def build_bake_binning(statics: SceneStatics, res: int, device="cuda") -> BakeBinning:
    """The per-sequence bake binning of the dense UV layout at ``res``², with
    the UV -> vertex re-indexing composed into its corner ids, so a frame's
    bake gathers straight from the per-vertex dense colors."""
    uv_px = process_uv(statics.dense.topo.dense_uvs.copy(), res, res)
    return compute_bake_binning(
        uv_px, statics.dense.tri_uv_faces, res, res, corner_map=uv_to_vertex(statics), device=device
    )


def save_mesh(
    out_dir: str,
    params: Dict[str, torch.Tensor],
    statics: SceneStatics,
    frame: int,
    dense_params: Optional[Dict[str, torch.Tensor]] = None,
    tex_res: int = 1024,
    gen_texture: bool = False,
    bake_binning: Optional[BakeBinning] = None,
    bake_backend: str = "auto",
    bake_window: int = 16,
    bake_bands: int = 8,
) -> None:
    """Write ``face.obj`` (and with ``gen_texture``, ``face.png``) of 1-based
    ``frame`` into ``out_dir``, computing on the parameters' device."""
    os.makedirs(out_dir, exist_ok=True)
    dev = params["means3D"].device
    inv_g = torch.as_tensor(np.linalg.inv(statics.trans_g).astype(np.float32), device=dev)
    verts = exported_vertices(
        params["means3D"], params["log_scales"], params["unnorm_rotations"],
        torch.as_tensor(statics.tri_faces, device=dev), inv_g, frame != 1,
    )
    write_obj_with_uv(
        os.path.join(out_dir, "face.obj"), verts.cpu().numpy(), statics.faces, statics.uvs, statics.uv_faces
    )
    if gen_texture and dense_params is not None and statics.dense is not None:
        write_texture(os.path.join(out_dir, "face.png"), dense_params, statics, tex_res, bake_binning,
                      backend=bake_backend, window=bake_window, bands=bake_bands)


@torch.no_grad()
def write_texture(
    path: str,
    dense_params: Dict[str, torch.Tensor],
    statics: SceneStatics,
    res: int,
    bake_binning: Optional[BakeBinning] = None,
    backend: str = "auto",
    window: int = 16,
    bands: int = 8,
) -> None:
    """Bake the dense Gaussian colors, clipped to [0, 1], into the ``res``²
    UV canvas and save it as a PNG (replaces the reference's Cython scanline
    bake, helpers.py:953-960). Bytes are truncated as the JAX package's
    ``(img * 255).astype(np.uint8)``; the conversion runs on the colors'
    device, so only the bytes cross to the host.

    ``backend`` "auto" or "pallas": K6 (its plain version on the CPU) over
    ``bake_binning``, the per-sequence binning of ``build_bake_binning``,
    made here when None. "xla": the banded scatter bake of the UV-slot
    colors (``window``, ``bands``; JAX's ``write_texture``,
    ``topo4d_tpu/pipeline/export.py:165-189``), no binning. Any other value
    raises ``ValueError``."""
    check_bake_backend(backend)
    colors = torch.clamp(dense_params["dense_rgb_colors"], 0.0, 1.0)
    if backend == "xla":
        uv_colors = colors[torch.as_tensor(uv_to_vertex(statics), device=colors.device)]
        uv_px = process_uv(statics.dense.topo.dense_uvs.copy(), res, res)
        img = bake_texture(uv_px, statics.dense.tri_uv_faces, uv_colors, res, res, window=window, bands=bands,
                           device=colors.device)
    else:
        binning = bake_binning if bake_binning is not None else build_bake_binning(statics, res, colors.device)
        img = bake_canvas(binning, colors, res, res)
    write_png(path, (img * 255).to(torch.uint8).cpu().numpy())
