"""Pure-NumPy tier of the face3d mesh renderer (the oracle of the C++ tier).

A copy of ``topo4d_tpu/mesh3d/mesh_numpy.py``: the call contract of
``mesh3d/scanline.py`` and the semantics of ``csrc/scanline.cpp``, including
its inclusive far edge (a documented deviation from face3d, so that every
tier agrees on exact shared edges), in float64, with the triangles in
sequential order so that a z-tie goes to the first triangle as in the C++
loop. A per-triangle Python loop over a vectorised bounding box: readable,
dependency-free and oracle-speed, checked against the C++ tier in
``tests/test_torch_scanline.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _barycentric_grid(
    us: np.ndarray, vs: np.ndarray, p0, p1, p2
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Barycentric weights of the pixel grid against one triangle.

    The dot-product Cramer formulation shared by every tier (reference
    mesh_numpy/render.py get_point_weight; scanline.cpp:30-45). f64.
    """
    v0 = p2[:2] - p0[:2]
    v1 = p1[:2] - p0[:2]
    v2x = us - p0[0]
    v2y = vs - p0[1]
    dot00 = v0 @ v0
    dot01 = v0 @ v1
    dot11 = v1 @ v1
    dot02 = v0[0] * v2x + v0[1] * v2y
    dot12 = v1[0] * v2x + v1[1] * v2y
    denom = dot00 * dot11 - dot01 * dot01
    inv = 0.0 if denom == 0.0 else 1.0 / denom
    u = (dot11 * dot02 - dot01 * dot12) * inv
    v = (dot00 * dot12 - dot01 * dot02) * inv
    return 1.0 - u - v, v, u


def _tri_loop(vertices, triangles, h, w):
    """Yield per-triangle (i, (i0,i1,i2), pixel grid, bary, z) for pixels
    inside the triangle's image-clipped bbox that pass the inside test."""
    verts = np.asarray(vertices, np.float64)
    tris = np.asarray(triangles, np.int64)
    for i in range(tris.shape[0]):
        i0, i1, i2 = tris[i]
        p0, p1, p2 = verts[i0], verts[i1], verts[i2]
        umin = max(int(np.ceil(min(p0[0], p1[0], p2[0]))), 0)
        umax = min(int(np.floor(max(p0[0], p1[0], p2[0]))), w - 1)
        vmin = max(int(np.ceil(min(p0[1], p1[1], p2[1]))), 0)
        vmax = min(int(np.floor(max(p0[1], p1[1], p2[1]))), h - 1)
        if umax < umin or vmax < vmin:
            continue
        us, vs = np.meshgrid(
            np.arange(umin, umax + 1, dtype=np.float64),
            np.arange(vmin, vmax + 1, dtype=np.float64),
            indexing="xy",
        )
        w0, w1, w2 = _barycentric_grid(us, vs, p0, p1, p2)
        # inclusive far edge (scanline.cpp documented deviation)
        ok = (w1 >= 0.0) & (w2 >= 0.0) & (w1 + w2 <= 1.0)
        if not ok.any():
            continue
        z = w0 * p0[2] + w1 * p1[2] + w2 * p2[2]
        ys = vs[ok].astype(np.int64)
        xs = us[ok].astype(np.int64)
        yield i, (int(i0), int(i1), int(i2)), ys, xs, (
            w0[ok], w1[ok], w2[ok]
        ), z[ok]


def render_colors(
    vertices: np.ndarray,  # (V, 3) pixel-space coords + z
    triangles: np.ndarray,  # (F, 3) int
    colors: np.ndarray,  # (V, C)
    h: int,
    w: int,
) -> np.ndarray:
    """Scanline z-buffer render -> (H, W, C) float32."""
    cols = np.asarray(colors, np.float64)
    tris = np.asarray(triangles)
    if tris.size and int(tris.max()) >= min(
        np.asarray(vertices).shape[0], cols.shape[0]
    ):
        raise ValueError("triangle index exceeds vertex/color rows")
    c = cols.shape[1]
    out = np.zeros((h, w, c), np.float64)
    depth = np.full((h, w), -999999.0)
    for _, (i0, i1, i2), ys, xs, (w0, w1, w2), z in _tri_loop(
        vertices, triangles, h, w
    ):
        cur = depth[ys, xs]
        upd = z > cur  # ties keep the EARLIER triangle (C++ parity)
        if not upd.any():
            continue
        ysu, xsu = ys[upd], xs[upd]
        depth[ysu, xsu] = z[upd]
        out[ysu, xsu] = (
            w0[upd, None] * cols[i0]
            + w1[upd, None] * cols[i1]
            + w2[upd, None] * cols[i2]
        )
    return out.astype(np.float32)


def rasterize_triangles(
    vertices: np.ndarray, triangles: np.ndarray, h: int, w: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (depth (H, W), tri_id (H, W) int32 -1=none, bary (H, W, 3))."""
    depth = np.full((h, w), -999999.0)
    tri = np.full((h, w), -1, np.int32)
    bary = np.zeros((h, w, 3), np.float64)
    for i, _, ys, xs, (w0, w1, w2), z in _tri_loop(
        vertices, triangles, h, w
    ):
        cur = depth[ys, xs]
        upd = z > cur
        if not upd.any():
            continue
        ysu, xsu = ys[upd], xs[upd]
        depth[ysu, xsu] = z[upd]
        tri[ysu, xsu] = i
        bary[ysu, xsu, 0] = w0[upd]
        bary[ysu, xsu, 1] = w1[upd]
        bary[ysu, xsu, 2] = w2[upd]
    return depth.astype(np.float32), tri, bary.astype(np.float32)


def render_texture(
    vertices: np.ndarray,  # (V, 3) pixel-space coords + z
    triangles: np.ndarray,  # (F, 3) int
    texture: np.ndarray,  # (TH, TW, C)
    tex_coords: np.ndarray,  # (TV, 2) texture-PIXEL coords
    tex_triangles: np.ndarray,  # (F, 3) int into tex_coords
    h: int,
    w: int,
    bilinear: bool = True,
) -> np.ndarray:
    """Texture-mapped z-buffer render -> (H, W, C) float32.

    The reference's ``_render_texture_core`` capability with consistent
    texture-triangle indexing (the native tier's documented fix of the
    reference's mixed tex-index read, mesh_core.cpp:273-275).
    """
    tex = np.asarray(texture, np.float64)
    tc = np.asarray(tex_coords, np.float64)
    ttris = np.asarray(tex_triangles, np.int64)
    tris = np.asarray(triangles)
    if ttris.shape != tris.shape:
        raise ValueError(
            f"tex_triangles {ttris.shape} must match triangles {tris.shape}"
        )
    if ttris.size and int(ttris.max()) >= tc.shape[0]:
        raise ValueError("tex_triangles index exceeds tex_coords rows")
    th, tw, c = tex.shape
    out = np.zeros((h, w, c), np.float64)
    depth = np.full((h, w), -999999.0)
    for i, _, ys, xs, (w0, w1, w2), z in _tri_loop(
        vertices, triangles, h, w
    ):
        cur = depth[ys, xs]
        upd = z > cur
        if not upd.any():
            continue
        t0, t1, t2 = ttris[i]
        ysu, xsu = ys[upd], xs[upd]
        depth[ysu, xsu] = z[upd]
        tx = (
            w0[upd] * tc[t0, 0] + w1[upd] * tc[t1, 0] + w2[upd] * tc[t2, 0]
        )
        ty = (
            w0[upd] * tc[t0, 1] + w1[upd] * tc[t1, 1] + w2[upd] * tc[t2, 1]
        )
        tx = np.clip(tx, 0.0, tw - 1)
        ty = np.clip(ty, 0.0, th - 1)
        if not bilinear:
            sx = np.rint(tx).astype(np.int64)
            sy = np.rint(ty).astype(np.int64)
            out[ysu, xsu] = tex[sy, sx]
        else:
            x0 = np.floor(tx).astype(np.int64)
            x1 = np.ceil(tx).astype(np.int64)
            y0 = np.floor(ty).astype(np.int64)
            y1 = np.ceil(ty).astype(np.int64)
            fx = (tx - x0)[:, None]
            fy = (ty - y0)[:, None]
            out[ysu, xsu] = (
                tex[y0, x0] * (1 - fx) * (1 - fy)
                + tex[y0, x1] * fx * (1 - fy)
                + tex[y1, x0] * (1 - fx) * fy
                + tex[y1, x1] * fx * fy
            )
    return out.astype(np.float32)


def vertex_normals(
    vertices: np.ndarray, triangles: np.ndarray
) -> np.ndarray:
    """Area-weighted one-ring vertex normals -> (V, 3)."""
    verts = np.asarray(vertices, np.float64)
    tris = np.asarray(triangles, np.int64)
    e1 = verts[tris[:, 1]] - verts[tris[:, 0]]
    e2 = verts[tris[:, 2]] - verts[tris[:, 0]]
    fn = np.cross(e1, e2)  # area-weighted face normals
    out = np.zeros((verts.shape[0], 3), np.float64)
    for k in range(3):
        np.add.at(out, tris[:, k], fn)
    # NB the C++ tier accumulates each add in f32; this f64 sum agrees
    # to f32 rounding (~1e-7), not bitwise
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    ok = norm[:, 0] > 1e-12
    out[ok] = out[ok] / norm[ok]
    return out.astype(np.float32)
