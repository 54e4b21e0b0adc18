"""The C++ scanline tier of the face3d surface (``csrc/scanline.cpp``,
through ctypes): ``topo4d_tpu/native/__init__.py``'s functions.

Host functions, NumPy in and NumPy out, as in the JAX package: the library
is built by the host C++ compiler at the first call (``native.py``), and a
failed build raises with the compiler's output. Inputs are copied to
contiguous float32 / int32 arrays; indices out of range raise
``ValueError`` where the JAX package's do. The pure-NumPy tier
(``mesh3d/mesh_numpy.py``) has the same contract.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from topo4d_tpu_torch import native


def _lib():
    return native.library("scanline")


def render_colors(
    vertices: np.ndarray,  # (V, 3) pixel-space coords + z
    triangles: np.ndarray,  # (F, 3) int
    colors: np.ndarray,  # (V, C)
    h: int,
    w: int,
) -> np.ndarray:
    """Scanline z-buffer render -> (H, W, C) float32."""
    verts = np.ascontiguousarray(vertices, np.float32)
    tris = np.ascontiguousarray(triangles, np.int32)
    cols = np.ascontiguousarray(colors, np.float32)
    if tris.size and int(tris.max()) >= min(verts.shape[0], cols.shape[0]):
        raise ValueError("triangle index exceeds vertex/color rows")
    c = cols.shape[1]
    out = np.zeros((h, w, c), np.float32)
    _lib().render_colors(verts, verts.shape[0], tris, tris.shape[0], cols, c, h, w, out)
    return out


def rasterize_triangles(
    vertices: np.ndarray, triangles: np.ndarray, h: int, w: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (depth (H, W), tri_id (H, W) int32 -1=none, bary (H, W, 3))."""
    verts = np.ascontiguousarray(vertices, np.float32)
    tris = np.ascontiguousarray(triangles, np.int32)
    depth = np.empty((h, w), np.float32)
    tri = np.empty((h, w), np.int32)
    bary = np.empty((h, w, 3), np.float32)
    _lib().rasterize_triangles(verts, verts.shape[0], tris, tris.shape[0], h, w, depth, tri, bary)
    return depth, tri, bary


def render_texture(
    vertices: np.ndarray,  # (V, 3) pixel-space coords + z
    triangles: np.ndarray,  # (F, 3) int
    texture: np.ndarray,  # (TH, TW, C)
    tex_coords: np.ndarray,  # (TV, 2) texture-pixel coords
    tex_triangles: np.ndarray,  # (F, 3) int into tex_coords
    h: int,
    w: int,
    bilinear: bool = True,
) -> np.ndarray:
    """Texture-mapped z-buffer render -> (H, W, C) float32: each pixel
    samples ``texture`` at the barycentric interpolation of its visible
    triangle's texture coordinates, indexed consistently through
    ``tex_triangles`` (the reference reads one of them through the mesh
    triangle, face3d mesh_core.cpp:273-275)."""
    verts = np.ascontiguousarray(vertices, np.float32)
    tris = np.ascontiguousarray(triangles, np.int32)
    tex = np.ascontiguousarray(texture, np.float32)
    tc = np.ascontiguousarray(tex_coords, np.float32)
    ttris = np.ascontiguousarray(tex_triangles, np.int32)
    if ttris.shape != tris.shape:
        raise ValueError(f"tex_triangles {ttris.shape} must match triangles {tris.shape}")
    if ttris.size and int(ttris.max()) >= tc.shape[0]:
        raise ValueError("tex_triangles index exceeds tex_coords rows")
    th, tw, c = tex.shape
    out = np.zeros((h, w, c), np.float32)
    _lib().render_texture(
        verts, verts.shape[0], tris, tris.shape[0], tex, th, tw, c, tc, ttris, h, w, int(bilinear), out
    )
    return out


def vertex_normals(vertices: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Area-weighted one-ring vertex normals -> (V, 3) float32 (each face's
    cross product added in float32, normalised in float64)."""
    verts = np.ascontiguousarray(vertices, np.float32)
    tris = np.ascontiguousarray(triangles, np.int32)
    out = np.zeros((verts.shape[0], 3), np.float32)
    _lib().vertex_normals(verts, verts.shape[0], tris, tris.shape[0], out)
    return out
