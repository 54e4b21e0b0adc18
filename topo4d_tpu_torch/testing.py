"""Synthetic fixtures (host NumPy), counterparts of ``topo4d_tpu/testing.py``.

Same shapes, statistics and random streams as the reference's fixtures: the
8,280-vertex head patch, the 24-view camera ring, 375x512 geometry images.
Functions that return a Camera take ``device``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from topo4d_tpu_torch.core.camera import Camera, make_camera
from topo4d_tpu_torch.topology.adjacency import triangulate_faces
from topo4d_tpu_torch.topology.regions import FACE_REGION_NAMES, FacialRegions


def _ring_pose(width, height, distance, angle):
    """(K, w2c) of a camera on the xz circle looking at the origin (COLMAP axes)."""
    f = 0.9 * max(width, height)
    k = np.array([[f, 0, width / 2.0], [0, f, height / 2.0], [0, 0, 1.0]], np.float32)
    pos = np.array([distance * np.sin(angle), 0.0, -distance * np.cos(angle)], np.float32)
    forward = -pos / np.linalg.norm(pos)
    up = np.array([0.0, -1.0, 0.0], np.float32)  # COLMAP y points down
    right = np.cross(up, forward)
    right /= np.linalg.norm(right)
    up2 = np.cross(forward, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up2, forward, pos
    return k, np.linalg.inv(c2w)


def make_synthetic_camera(
    width: int = 64, height: int = 48, distance: float = 2.0, angle: float = 0.0, device="cuda"
) -> Camera:
    k, w2c = _ring_pose(width, height, distance, angle)
    return make_camera(k, w2c, width, height, device=device)


def make_camera_ring(
    num_views: int, width: int = 64, height: int = 48, distance: float = 2.0, device="cuda"
) -> Camera:
    """A batched Camera of ``num_views`` poses on a ring (the 24-view rig)."""
    poses = [
        _ring_pose(width, height, distance, 2 * np.pi * i / max(num_views, 1) * 0.45)
        for i in range(num_views)
    ]
    return make_camera(
        np.stack([p[0] for p in poses]), np.stack([p[1] for p in poses]),
        width, height, device=device,
    )


def make_grid_mesh(rows: int = 8, cols: int = 8, extent: float = 1.0, seed: int = 0) -> Tuple[np.ndarray, list]:
    """A quad-grid 'head patch': (V, 3) vertices + quad faces list."""
    rng = np.random.default_rng(seed)
    ys, xs = np.meshgrid(
        np.linspace(-extent, extent, rows), np.linspace(-extent, extent, cols), indexing="ij"
    )
    zs = 0.3 * np.exp(-(xs**2 + ys**2)) + 0.02 * rng.normal(size=xs.shape)
    verts = np.stack([xs, ys, zs], axis=-1).reshape(-1, 3).astype(np.float32)
    faces = []
    for i in range(rows - 1):
        for j in range(cols - 1):
            v0 = i * cols + j
            faces.append([v0, v0 + 1, v0 + cols + 1, v0 + cols])
    return verts, faces


def make_synthetic_regions(num_vertices: int, faces, seed: int = 0) -> FacialRegions:
    """A plausible FacialRegions for a synthetic mesh: the 26 named regions,
    the derived masks and the flat-face subsets, sized so every constraint
    path runs."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_vertices)
    chunks = np.array_split(perm, len(FACE_REGION_NAMES))
    region_masks = {
        name: np.sort(chunk).astype(np.int32) for name, chunk in zip(FACE_REGION_NAMES, chunks)
    }

    def pick(frac, s):
        k = max(1, int(num_vertices * frac))
        r = np.random.default_rng(s)
        return np.sort(r.choice(num_vertices, k, replace=False)).astype(np.int32)

    tris = np.asarray(triangulate_faces(faces), np.int32)

    def tri_subset(frac, s):
        r = np.random.default_rng(s)
        k = max(1, int(tris.shape[0] * frac))
        return tris[np.sort(r.choice(tris.shape[0], k, replace=False))]

    masks = {
        "face_flat_masks": pick(0.1, 1),
        "lip_socket_flat_masks": pick(0.05, 2),
        "eye_lid_up_masks": pick(0.04, 3),
        "lip_flat_edge_masks": pick(0.01, 4),
        "face_masks": pick(0.5, 5),
        "face_bottom_masks": pick(0.1, 6),
        "dynamic_masks": pick(0.15, 7),
        "dynamic_eye_masks": pick(0.05, 8),
        "dynamic_mouth_masks": pick(0.1, 9),
        "eye_around_masks": pick(0.1, 10),
        "eye_inner_masks": pick(0.03, 11),
        "eye_del_masks": pick(0.04, 12),
        "mouth_around_masks": pick(0.06, 13),
        "mouth_inner_masks": pick(0.03, 14),
        "static_masks": pick(0.25, 15),
    }
    flat_faces = {
        "flat_faces": tri_subset(0.8, 20),
        "lip_bottom_flat_faces": tri_subset(0.2, 21),
        "lip_flat_faces": tri_subset(0.25, 22),
        "mouth_flat_faces": tri_subset(0.1, 23),
        "lid_top_flat_faces": tri_subset(0.08, 24),
        "lid_bottom_flat_faces": tri_subset(0.1, 25),
    }
    return FacialRegions(region_masks=region_masks, masks=masks, flat_faces=flat_faces)


def make_head_fixture(
    rows: int = 92,
    cols: int = 90,
    num_views: int = 24,
    width: int = 375,
    height: int = 512,
    seed: int = 0,
    device="cuda",
):
    """Reference-scale fixture: 8,280 mesh-bound Gaussians, 24 views, 375x512.

    Returns (params (NumPy), cams, (verts, faces)).
    """
    rng = np.random.default_rng(seed)
    verts, faces = make_grid_mesh(rows, cols, extent=0.5, seed=seed)
    n = verts.shape[0]
    pitch = 1.0 / max(rows, cols)
    params = {
        "means3D": verts.astype(np.float32),
        "rgb_colors": rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32),
        "unnorm_rotations": np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1)),
        "logit_opacities": np.full((n, 1), 6.0, np.float32),
        "log_scales": np.full((n, 3), np.log(pitch / 2), np.float32),
        "cam_m": np.zeros((num_views, 3), np.float32),
        "cam_c": np.zeros((num_views, 3), np.float32),
    }
    cams = make_camera_ring(num_views, width=width, height=height, distance=2.0, device=device)
    return params, cams, (verts, faces)


def make_crowded_bake_tile(n_tris: int = 100, seed: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """``n_tris`` UV triangles crowded into the first 16 x 16 tile of a
    40 x 36 canvas and its neighbours, so that one tile holds more entries
    than K6 stages in one batch: random depths and equal ones (ties),
    corners on pixel centres and on the x = 7 / 8 edge between two warp
    blocks, degenerate triangles (collinear corners, a repeated corner: a
    zero barycentric denominator), corners off the canvas -> (verts (3 n, 3)
    float32 pixel coordinates and depth, tris (n, 3))."""
    rng = np.random.default_rng(seed)
    corners = rng.uniform(-2.0, 20.0, (n_tris, 3, 2))
    corners[::7] = np.round(corners[::7])
    corners[1::9, :, 0] = 7.0 + rng.integers(0, 2, (len(corners[1::9]), 3))
    corners[2::11, 2] = corners[2::11, 0] + 2.0 * (corners[2::11, 1] - corners[2::11, 0])
    corners[3::13, 1] = corners[3::13, 0]
    z = rng.uniform(-1.0, 1.0, (n_tris, 3, 1))
    z[::5] = 0.25
    verts = np.concatenate([corners, z], -1).reshape(-1, 3).astype(np.float32)
    return verts, np.arange(3 * n_tris).reshape(n_tris, 3)
