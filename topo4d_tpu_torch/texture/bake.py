"""The banded three-pass scatter bake (``topo4d_tpu/texture/bake.py``), in
plain PyTorch on the caller's device.

The bake that ``texture.bake_backend: "xla"`` selects: JAX's XLA algorithm,
which a user asks for by name, run as it is, not a plain version of a
kernel. Each triangle rasterizes a ``window`` x ``window`` pixel window from
its inner bounding box's ceiling (a triangle whose bounding box spans
``window`` pixels or more raises: nothing is cut silently); the canvas is
made in ``bands`` row bands, each from the triangles whose inner bounding
box meets it, by three scatters:

1. the largest depth per pixel (``scatter_reduce`` amax);
2. the lowest triangle id among the depth winners (amin): the scanline
   renderer's first-triangle-wins rule;
3. the winner's barycentric colour.

The pixel contract is K6's (``texture/bake_tiled.py``): integer pixel
centres, the inner bounding box ``ceil(min)..floor(max)``, the inclusive
inside test, a bigger z wins; every sum and product runs in K6's order, so
on the same inputs the two canvases agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from topo4d_tpu_torch.device import resolve_device

_NEG = -999999.0  # the depth of "no triangle" (the reference's z-buffer fill)
_ID_NONE = 2**31 - 1


def _barycentric(px, py, x0, y0, x1, y1, x2, y2):
    """(w0, w1, w2) of pixel (px, py): the Cramer solve through dot products
    (face3d mesh_numpy/render.py ``get_point_weight``)."""
    v0x, v0y = x2 - x0, y2 - y0
    v1x, v1y = x1 - x0, y1 - y0
    v2x, v2y = px - x0, py - y0
    dot00 = v0x * v0x + v0y * v0y
    dot01 = v0x * v1x + v0y * v1y
    dot02 = v0x * v2x + v0y * v2y
    dot11 = v1x * v1x + v1y * v1y
    dot12 = v1x * v2x + v1y * v2y
    denom = dot00 * dot11 - dot01 * dot01
    inv = torch.where(denom == 0.0, torch.zeros_like(denom), 1.0 / denom)
    u = (dot11 * dot02 - dot01 * dot12) * inv
    v = (dot00 * dot12 - dot01 * dot02) * inv
    return 1.0 - u - v, v, u


def _bake_band(verts, tris, colors, tri_ids, y_offset: int, height: int, width: int, window: int):
    """Row band [y_offset, y_offset + height) -> (height, width, C) from the
    triangles ``tris`` (global ids ``tri_ids``, ascending)."""
    tx, ty, tz = verts[:, 0][tris], verts[:, 1][tris], verts[:, 2][tris]  # (F, 3)
    umin = torch.ceil(torch.amin(tx, dim=1)).long()
    vmin = torch.ceil(torch.amin(ty, dim=1)).long()
    umax = torch.floor(torch.amax(tx, dim=1)).long()
    vmax = torch.floor(torch.amax(ty, dim=1)).long()
    k = torch.arange(window * window, device=verts.device)
    pu = umin[:, None] + (k % window)[None, :]  # (F, window^2) pixel x
    pv = vmin[:, None] + (k // window)[None, :]
    in_bbox = (pu <= umax[:, None]) & (pv <= vmax[:, None])
    in_canvas = (pu >= 0) & (pu < width) & (pv >= y_offset) & (pv < y_offset + height)
    w0, w1, w2 = _barycentric(
        pu.float(), pv.float(), tx[:, 0:1], ty[:, 0:1], tx[:, 1:2], ty[:, 1:2], tx[:, 2:3], ty[:, 2:3]
    )
    # the far edge inclusive, as in csrc/scanline.cpp (u = w2, v = w1)
    valid = in_bbox & in_canvas & (w2 >= 0) & (w1 >= 0) & (w1 + w2 <= 1.0)
    # the scatters take the valid (triangle, pixel) pairs alone: JAX sends
    # the others to a spare slot, where they would all contend for one address
    pair = torch.nonzero(valid.reshape(-1)).squeeze(1)
    tri = pair // (window * window)
    w0, w1, w2 = w0.reshape(-1)[pair], w1.reshape(-1)[pair], w2.reshape(-1)[pair]
    flat_idx = ((pv - y_offset) * width + pu).reshape(-1)[pair]
    depth = w0 * tz[tri, 0] + w1 * tz[tri, 1] + w2 * tz[tri, 2]
    npx = height * width
    zbuf = torch.full((npx,), _NEG, device=verts.device).scatter_reduce_(0, flat_idx, depth, "amax")
    tid = tri_ids[tri]
    is_winner = depth >= zbuf[flat_idx]
    win_id = torch.full((npx,), _ID_NONE, dtype=torch.int64, device=verts.device).scatter_reduce_(
        0, flat_idx[is_winner], tid[is_winner], "amin"
    )
    final = torch.nonzero(is_winner & (tid == win_id[flat_idx])).squeeze(1)  # one winner per pixel
    t, w0, w1, w2 = tri[final], w0[final, None], w1[final, None], w2[final, None]
    col = w0 * colors[tris[t, 0]] + w1 * colors[tris[t, 1]] + w2 * colors[tris[t, 2]]
    img = torch.zeros((npx, colors.shape[1]), device=verts.device)
    img[flat_idx[final]] = col
    return img.reshape(height, width, -1)


def check_window(uv_px: np.ndarray, tri_faces: np.ndarray, window: int) -> None:
    """Raise ``ValueError`` if a triangle's bounding box over the corners
    ``uv_px`` spans ``window`` pixels or more (``topo4d_tpu/texture/bake.py``
    ``_check_window``); then its inner bounding box fits the window."""
    tx = np.asarray(uv_px)[:, 0][np.asarray(tri_faces)]
    ty = np.asarray(uv_px)[:, 1][np.asarray(tri_faces)]
    span = max(
        float((tx.max(1) - tx.min(1)).max() if tx.size else 0),
        float((ty.max(1) - ty.min(1)).max() if ty.size else 0),
    )
    if span >= window:
        raise ValueError(f"triangle bbox span {span:.1f}px exceeds window {window}; raise `window` "
                         "(no silent truncation)")


def bake_texture(
    uv_px: np.ndarray,  # (V, 3) from process_uv
    tri_faces: np.ndarray,  # (F, 3)
    colors,  # (V, C)
    height: int,
    width: int,
    window: int = 8,
    bands: int = 8,
    device="cuda",
) -> torch.Tensor:
    """Rasterize vertex colours over the UV canvas -> (height, width, C)
    float32 on ``device``.

    ``window`` must exceed the largest triangle's bounding-box span (checked
    first: a larger triangle raises). The triangles are bucketed by the row
    bands of ``ceil(height / bands)`` rows that their inner bounding boxes
    meet, so each band rasterizes only those; ids stay global and
    ascending, so ties go to the first triangle as in a bake of the whole
    list at once.

    The check and the buckets take the float32 corners that the bake
    rasterizes. JAX's take the float64 ``uv_px``
    (``topo4d_tpu/texture/bake.py:160-199``): a corner within rounding of a
    pixel row can give a triangle an empty float64 inner bounding box but a
    float32 one with a row, and JAX's bake then drops the triangle where it
    covers pixels of that row.
    """
    dev = resolve_device(device)
    uv32 = np.asarray(uv_px, np.float32)  # the corners as the bake rasterizes them
    check_window(uv32, tri_faces, window)
    tris_np = np.asarray(tri_faces, np.int64)
    ty = uv32[:, 1][tris_np]
    band_h = -(-height // bands)
    vmin, vmax = np.ceil(ty.min(1)).astype(np.int64), np.floor(ty.max(1)).astype(np.int64)
    b_lo, b_hi = np.clip(vmin // band_h, 0, bands - 1), np.clip(vmax // band_h, 0, bands - 1)
    keep = vmax >= vmin  # a degenerate bounding box touches no pixel row
    verts = torch.as_tensor(uv32, device=dev)
    tris = torch.as_tensor(tris_np, device=dev)
    cols = torch.as_tensor(colors, dtype=torch.float32, device=dev)
    out = torch.zeros((height, width, cols.shape[1]), device=dev)
    for b in range(bands):
        y0 = b * band_h
        h = min(band_h, height - y0)
        if h <= 0:
            break
        ids = torch.as_tensor(np.flatnonzero(keep & (b_lo <= b) & (b <= b_hi)), device=dev)
        out[y0 : y0 + h] = _bake_band(verts, tris[ids], cols, ids, y0, band_h, width, window)[:h]
    return out
