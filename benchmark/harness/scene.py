"""The benchmark's inputs, made from a configuration file and a seed.

A capture rig and a head, as the port's synthetic fixtures and validation
datasets lay them out, rewritten here so that the benchmark owns them:

- the head grid: ``rows`` x ``cols`` vertices on [-extent, extent]^2 with a
  dome and a small fixed roughness, quad faces;
- its UV map: one island (``grid``) or two islands split at the middle
  column, whose vertices then carry two UV coordinates (``seam``);
- the facial regions: the 26 named regions and the derived masks drawn at
  random from the vertices, and the flatten-face subsets;
- the frontal (densified) vertices: a patch of ``frontal`` = [rows, cols]
  vertices centred on the grid (on the seam, where there is one);
- the ring rig: ``views`` cameras on a 0.45-turn arc at distance 2;
- the known scene on the grid: random colours, identity rotations, opaque,
  half a grid pitch wide;
- the motion: each frame's head moves by ``motion`` along a fixed direction,
  with a sine across the vertices whose phase the seed sets.

The mesh, UVs, regions and rig are the configuration's and do not change
with the seed; the colours and the motion's phase do. Nothing here imports
the program under test.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

REGION_NAMES = (
    "Caruncle", "Chin", "Ear", "EarNeckBack", "EarSocket", "EyeLidBottom",
    "EyeLidInnerBottom", "EyeLidInnerTop", "EyeLidOuterTop",
    "EyeLidOuterBottom", "EyeLidTop", "EyeSocket", "Face", "HeadBack",
    "LipBottom", "LipInnerBottom", "LipInnerTop", "LipOuterBottom",
    "LipOuterTop", "LipTop", "MouthSocket", "MouthSocketBottom",
    "MouthSocketTop", "NeckBack", "NeckFront", "Nostril",
)
# derived masks: (name, share of the vertices, stream seed)
DERIVED_MASKS = (
    ("face_flat_masks", 0.1, 1), ("lip_socket_flat_masks", 0.05, 2), ("eye_lid_up_masks", 0.04, 3),
    ("lip_flat_edge_masks", 0.01, 4), ("face_masks", 0.5, 5), ("face_bottom_masks", 0.1, 6),
    ("dynamic_masks", 0.15, 7), ("dynamic_eye_masks", 0.05, 8), ("dynamic_mouth_masks", 0.1, 9),
    ("eye_around_masks", 0.1, 10), ("eye_inner_masks", 0.03, 11), ("eye_del_masks", 0.04, 12),
    ("mouth_around_masks", 0.06, 13), ("mouth_inner_masks", 0.03, 14), ("static_masks", 0.25, 15),
)
# flatten-face subsets: (name, share of the triangles, stream seed)
FLAT_FACES = (
    ("flat_faces", 0.8, 20), ("lip_bottom_flat_faces", 0.2, 21), ("lip_flat_faces", 0.25, 22),
    ("mouth_flat_faces", 0.1, 23), ("lid_top_flat_faces", 0.08, 24), ("lid_bottom_flat_faces", 0.1, 25),
)
MOTION_DIRECTION = (0.3, 1.0, 0.2)


@dataclasses.dataclass
class Rig:
    """Pinhole cameras on a ring, COLMAP axes: (V, 4, 4) world-to-camera,
    (V,) focal lengths and principal points, at one image size."""

    w2c: np.ndarray
    fx: np.ndarray
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    width: int
    height: int


@dataclasses.dataclass
class Scene:
    verts: np.ndarray  # (V, 3) float32, the template head
    faces: List[List[int]]  # quads
    uvs: np.ndarray  # (T, 2) float32
    uv_faces: List[List[int]]
    regions: Dict[str, object]  # the facial_regions schema: region_masks, derived masks, flat faces
    work_rig: Rig
    dense_rig: Rig
    colors: np.ndarray  # (V, 3) float32, the known scene's colours
    log_scale: float  # the known scene's Gaussians' log scale
    phase: float  # the motion's phase

    def head(self, k: int, motion: float) -> np.ndarray:
        """The head of frame ``k`` of the cycle -> (V, 3) float32."""
        n = self.verts.shape[0]
        wobble = motion * np.sin(0.5 * k + self.phase + np.linspace(0.0, 6.28, n))
        return (self.verts + wobble[:, None] * np.asarray(MOTION_DIRECTION)).astype(np.float32)


def grid_mesh(rows: int, cols: int, extent: float):
    """A dome on a quad grid, its roughness drawn once from seed 0."""
    rng = np.random.default_rng(0)
    ys, xs = np.meshgrid(np.linspace(-extent, extent, rows), np.linspace(-extent, extent, cols), indexing="ij")
    zs = 0.3 * np.exp(-(xs**2 + ys**2)) + 0.02 * rng.normal(size=xs.shape)
    verts = np.stack([xs, ys, zs], -1).reshape(-1, 3).astype(np.float32)
    faces = [[i * cols + j, i * cols + j + 1, (i + 1) * cols + j + 1, (i + 1) * cols + j]
             for i in range(rows - 1) for j in range(cols - 1)]
    return verts, faces


def grid_uvs(rows: int, cols: int) -> np.ndarray:
    """Vertex (r, c) at (u_c, v_r) on [0.05, 0.95]^2."""
    u, v = np.meshgrid(np.linspace(0.05, 0.95, cols), np.linspace(0.05, 0.95, rows), indexing="xy")
    return np.stack([u, v], -1).reshape(-1, 2).astype(np.float32)


def seam_uvs(rows: int, cols: int, faces):
    """Two UV islands split at column ``cols // 2``, whose vertices carry one
    coordinate on each island; a face takes the island of its smallest
    column -> (uvs, uv_faces)."""
    cm = cols // 2
    u_left, u_right = np.linspace(0.05, 0.46, cm + 1), np.linspace(0.54, 0.95, cols - cm)
    v_grid = np.linspace(0.05, 0.95, rows)
    left = np.arange(rows * (cm + 1)).reshape(rows, cm + 1)
    right = rows * (cm + 1) + np.arange(rows * (cols - cm)).reshape(rows, cols - cm)
    uvs = np.concatenate([
        np.stack(np.meshgrid(u_left, v_grid, indexing="xy"), -1).reshape(-1, 2),
        np.stack(np.meshgrid(u_right, v_grid, indexing="xy"), -1).reshape(-1, 2),
    ]).astype(np.float32)
    uv_faces = []
    for f in faces:
        rc = [(v // cols, v % cols) for v in f]
        if min(c for _, c in rc) < cm:
            uv_faces.append([int(left[r, c]) for r, c in rc])
        else:
            uv_faces.append([int(right[r, c - cm]) for r, c in rc])
    return uvs, uv_faces


def centre_patch(rows: int, cols: int, size) -> np.ndarray:
    """The ``size`` = (pr, pc) vertices centred on the grid, from row
    rows // 2 - pr // 2 and column cols // 2 - pc // 2 (the seam column's
    half-width to the left), clipped to the grid."""
    pr, pc = size
    r0, c0 = rows // 2 - pr // 2, cols // 2 - pc // 2
    r, c = np.divmod(np.arange(rows * cols), cols)
    inside = (r >= max(r0, 0)) & (r < min(r0 + pr, rows)) & (c >= max(c0, 0)) & (c < min(c0 + pc, cols))
    return np.flatnonzero(inside).astype(np.int32)


def synthetic_regions(n: int, faces) -> Dict[str, object]:
    """The regions schema drawn from fixed seeds: each named region a chunk
    of one permutation, each derived mask a share of the vertices, each
    flatten subset a share of the fan-triangulated faces."""
    perm = np.random.default_rng(0).permutation(n)
    regions: Dict[str, object] = {
        "region_masks": {name: np.sort(c).astype(np.int32)
                         for name, c in zip(REGION_NAMES, np.array_split(perm, len(REGION_NAMES)))}
    }
    for name, share, s in DERIVED_MASKS:
        k = max(1, int(n * share))
        regions[name] = np.sort(np.random.default_rng(s).choice(n, k, replace=False)).astype(np.int32)
    tris = np.asarray([t for f in faces for t in ([f[0], f[1], f[2]], [f[0], f[2], f[3]])], np.int32)
    for name, share, s in FLAT_FACES:
        k = max(1, int(tris.shape[0] * share))
        regions[name] = tris[np.sort(np.random.default_rng(s).choice(tris.shape[0], k, replace=False))]
    return regions


def ring_rig(num_views: int, width: int, height: int, distance: float = 2.0) -> Rig:
    """Cameras on the xz circle looking at the origin, focal 0.9 x the
    longer side, principal point at the centre."""
    w2c = []
    for i in range(num_views):
        angle = 2 * np.pi * i / max(num_views, 1) * 0.45
        pos = np.array([distance * np.sin(angle), 0.0, -distance * np.cos(angle)], np.float32)
        forward = -pos / np.linalg.norm(pos)
        right = np.cross(np.array([0.0, -1.0, 0.0], np.float32), forward)
        right /= np.linalg.norm(right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(forward, right), forward, pos
        w2c.append(np.linalg.inv(c2w))
    f = np.full(num_views, 0.9 * max(width, height), np.float32)
    return Rig(w2c=np.stack(w2c).astype(np.float32), fx=f, fy=f.copy(),
               cx=np.full(num_views, width / 2.0, np.float32), cy=np.full(num_views, height / 2.0, np.float32),
               width=int(width), height=int(height))


def make_scene(config: dict, seed: int, device) -> Scene:
    """The configuration's rig and head, with the seed's colours and phase.
    The colours and phase come from one generator on ``device``."""
    m = config["mesh"]
    rows, cols = m["rows"], m["cols"]
    verts, faces = grid_mesh(rows, cols, m["extent"])
    if m["uv_layout"] == "seam":
        uvs, uv_faces = seam_uvs(rows, cols, faces)
    elif m["uv_layout"] == "grid":
        uvs, uv_faces = grid_uvs(rows, cols), [list(f) for f in faces]
    else:
        raise ValueError(f"unknown uv_layout {m['uv_layout']!r}")
    regions = synthetic_regions(verts.shape[0], faces)
    regions["face_masks"] = centre_patch(rows, cols, m["frontal"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2**63))
    draws = torch.rand(verts.shape[0] * 3 + 1, generator=gen, device=device, dtype=torch.float32).cpu().numpy()
    colors = (0.1 + 0.8 * draws[:-1]).reshape(-1, 3).astype(np.float32)
    (ww, wh), (dw, dh) = config["work_size"], config["dense_size"]
    return Scene(
        verts=verts, faces=faces, uvs=uvs, uv_faces=uv_faces, regions=regions,
        work_rig=ring_rig(config["views"], ww, wh), dense_rig=ring_rig(config["views"], dw, dh),
        colors=colors, log_scale=float(np.log(1.0 / max(rows, cols) / 2)), phase=float(2 * np.pi * draws[-1]),
    )
