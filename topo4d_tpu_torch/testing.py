"""Synthetic fixtures (host NumPy), counterparts of ``topo4d_tpu/testing.py``
and ``scripts/fabricate_dataset.py``.

Same shapes, statistics and random streams as the reference's fixtures: the
8,280-vertex head patch, the 24-view camera ring, 375x512 geometry images.
``write_disk_sequence`` writes a sequence in the reference's disk layout.
Functions that return a Camera or render take ``device``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from topo4d_tpu_torch.config import DEFAULT_CMAP_INDEX, DEFAULT_ROTATE_MASK
from topo4d_tpu_torch.core.camera import Camera, make_camera
from topo4d_tpu_torch.core.gaussian import ALPHA_MAX, ALPHA_MIN, TRANSMITTANCE_MIN
from topo4d_tpu_torch.device import resolve_device
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


def make_synthetic_scene(n: int = 256, seed: int = 0, spread: float = 0.5, scale: float = 0.03) -> Dict[str, np.ndarray]:
    """Random raw (pre-activation) Gaussian params around the origin."""
    rng = np.random.default_rng(seed)
    return {
        "means3D": rng.normal(0.0, spread, (n, 3)).astype(np.float32),
        "rgb_colors": rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32),
        "unnorm_rotations": rng.normal(0.0, 1.0, (n, 4)).astype(np.float32),
        "logit_opacities": rng.normal(2.0, 1.0, (n, 1)).astype(np.float32),
        "log_scales": np.log(rng.uniform(0.5 * scale, 2.0 * scale, (n, 3))).astype(np.float32),
    }


def sequential_blend_numpy(
    pix: np.ndarray,  # (P, 2)
    means2d: np.ndarray,  # (M, 2) front-to-back order
    conics: np.ndarray,  # (M, 3)
    colors: np.ndarray,  # (M, 3)
    depths: np.ndarray,  # (M,)
    opacities: np.ndarray,  # (M,)
    valid: np.ndarray,  # (M,)
    bg: np.ndarray,  # (3,)
    rect=None,  # optional (x0, y0, x1, y1) tile rects, in tiles
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The CUDA rasterizer's per-pixel blending loop, literally and in
    float64: an oracle independent of the blend kernels. ``rect`` adds its
    tile-rect cull (a splat blends only into pixels whose 16x16 tile lies
    in its rect). -> (rgb (P, 3), depth (P,), alpha (P,))."""
    p = pix.shape[0]
    rgb = np.zeros((p, 3))
    dep = np.zeros(p)
    out_a = np.zeros(p)
    for pi in range(p):
        t = 1.0
        c = np.zeros(3)
        d = 0.0
        ptx = int(np.floor(pix[pi, 0] / 16.0))
        pty = int(np.floor(pix[pi, 1] / 16.0))
        for gi in range(means2d.shape[0]):
            if not valid[gi]:
                continue
            if rect is not None:
                x0, y0, x1, y1 = rect
                if not (x0[gi] <= ptx < x1[gi] and y0[gi] <= pty < y1[gi]):
                    continue
            dx = means2d[gi, 0] - pix[pi, 0]
            dy = means2d[gi, 1] - pix[pi, 1]
            power = -0.5 * (conics[gi, 0] * dx * dx + conics[gi, 2] * dy * dy) - conics[gi, 1] * dx * dy
            if power > 0.0:
                continue
            alpha = min(ALPHA_MAX, opacities[gi] * np.exp(power))
            if alpha < ALPHA_MIN:
                continue
            test_t = t * (1.0 - alpha)
            if test_t < TRANSMITTANCE_MIN:
                break
            c = c + colors[gi] * alpha * t
            d = d + depths[gi] * alpha * t
            t = test_t
        rgb[pi] = c + t * bg
        dep[pi] = d
        out_a[pi] = 1.0 - t
    return rgb, dep, out_a


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


def make_synthetic_bfm(seed: int = 0, rings: int = 145, around: int = 367, cap: int = 144, n_sp: int = 199,
                       n_ep: int = 29, n_tp: int = 199, n_kpt: int = 68, device="cuda"):
    """A morphable model made from ``seed`` -> ``mesh3d.bfm.MorphableModel``
    on ``device``. At the defaults its arrays have the shapes face3d loads
    from the Basel Face Model's ``.mat``: 53,215 vertices, 105,840
    triangles, 199 shape, 29 expression and 199 texture components, 68
    keypoints (the real file is not redistributable).

    The mean shape is a head-sized ellipsoid (radii 75, 100 and 90, the front
    at +z) sampled on ``rings`` rings of ``around`` vertices, closed around
    each ring; a fan of ``cap`` triangles covers part of the top ring's
    hole. Vertex (ring r, column c) is row ``r * around + c``. The shape and
    expression bases are smooth fields over the head, as BFM's are: entry
    (3 v + a, k) is ``cos(p_v . w_ka / 100 + b_ka)`` (random Fourier features
    of the mean position p_v, w ~ N(0, 4 I), b uniform on [0, 2 pi)), so a
    coefficient moves neighbouring vertices alike; their eigenvalues decay
    from 2. The texture basis is seeded normals (eigenvalues from 3), the
    texture mean uniform in [60, 200]; the keypoints are distinct vertices
    of the front (+z) half."""
    from topo4d_tpu_torch.mesh3d.bfm import MorphableModel

    rng = np.random.default_rng(seed)
    nv = rings * around
    theta = np.linspace(0.12 * np.pi, 0.88 * np.pi, rings)[:, None]
    phi = 2 * np.pi * np.arange(around)[None, :] / around
    mu = np.stack([75 * np.sin(theta) * np.sin(phi), 100 * np.cos(theta) + 0 * phi, 90 * np.sin(theta) * np.cos(phi)],
                  -1).reshape(-1, 3).astype(np.float32)
    r, c = np.meshgrid(np.arange(rings - 1), np.arange(around), indexing="ij")
    a, b = r * around + c, r * around + (c + 1) % around
    quads = [np.stack([a, a + around, b], -1), np.stack([b, a + around, b + around], -1)]
    fan = np.stack([np.zeros(cap, np.int64), np.arange(2, cap + 2), np.arange(1, cap + 1)], -1)
    tris = np.concatenate([np.stack(quads, 2).reshape(-1, 3), fan])

    def smooth_basis(k):
        w = rng.normal(0.0, 2.0, (3, 3 * k)).astype(np.float32)
        phase = rng.uniform(0.0, 2 * np.pi, 3 * k).astype(np.float32)
        feats = np.cos(mu @ w / 100.0 + phase)  # (V, 3 k): the (component, axis) pairs
        return np.ascontiguousarray(feats.reshape(nv, k, 3).transpose(0, 2, 1).reshape(3 * nv, k))

    front = np.flatnonzero(mu[:, 2] > 0.0)
    arrays = dict(
        shape_mu=mu.reshape(-1), shape_pc=smooth_basis(n_sp), shape_ev=(2.0 * 0.98 ** np.arange(n_sp)).astype(np.float32),
        exp_pc=smooth_basis(n_ep), exp_ev=(2.0 * 0.9 ** np.arange(n_ep)).astype(np.float32),
        triangles=tris, kpt_ind=rng.choice(front, n_kpt, replace=False),
        tex_mu=rng.uniform(60.0, 200.0, 3 * nv).astype(np.float32),
        tex_pc=rng.standard_normal((3 * nv, n_tp), dtype=np.float32),
        tex_ev=(3.0 * 0.98 ** np.arange(n_tp)).astype(np.float32),
    )
    dev = resolve_device(device)
    return MorphableModel(**{k: torch.as_tensor(v, device=dev) for k, v in arrays.items()})


def grid_uvs(rows: int, cols: int) -> np.ndarray:
    """The grid head's UV map: vertex (r, c) at (u_c, v_r) on [0.05, 0.95]^2."""
    return np.stack(
        np.meshgrid(np.linspace(0.05, 0.95, cols), np.linspace(0.05, 0.95, rows), indexing="xy"), -1
    ).reshape(-1, 2).astype(np.float32)


@dataclasses.dataclass
class DiskTree:
    """What ``write_disk_sequence`` wrote: the roots (``-id`` / ``-did``) and
    sequence name, the views, the rigs the targets were rendered on, the
    component transform, each frame's targets and parsing images, uint8
    (V, 3, H, W) in the cameras' orientation, keyed by (frame, full_res),
    and each view's quarter turns (``turns``): the files hold view v's
    pixels turned back by ``turns[v]``, and the loader's ``HostViews``
    carry them so, with these turns."""

    input_dir: str
    dense_input_dir: str
    seq: str
    view_names: List[str]
    cameras: Camera
    cameras_full: Camera
    trans_g: np.ndarray
    images: Dict[Tuple[int, bool], np.ndarray]
    masks: Dict[Tuple[int, bool], np.ndarray]
    turns: List[int]


def _sensor_xml(i, f, cx, cy, width, height, ratio, rt) -> str:
    """Invert ``extract_intrinsics``: the sensor whose calibration at
    ``resize_factor`` ``ratio`` gives a camera of focal ``f``, principal
    point (cx, cy) and size width x height, for a view rotated by ``rt``
    (a landscape sensor for a portrait camera: agisoft.py's swap)."""
    sw, sh = (height, width) if rt else (width, height)  # the sensor at the working ratio
    full_w, full_h = sw * ratio, sh * ratio
    if rt:  # K = [[f, 0, cy_s], [0, f, w_s - cx_s]] after the swap
        cx_xml = (sw - cy) * ratio - full_w / 2.0
        cy_xml = cx * ratio - full_h / 2.0
    else:
        cx_xml = cx * ratio - full_w / 2.0
        cy_xml = cy * ratio - full_h / 2.0
    return (
        f'<sensor id="{i}" label="s{i}" type="frame"><resolution width="{full_w}" height="{full_h}"/>'
        '<property name="pixel_width" value="0.004"/><property name="pixel_height" value="0.004"/>'
        f"<calibration><f>{f * ratio:.17g}</f><cx>{cx_xml:.17g}</cx><cy>{cy_xml:.17g}</cy>"
        "<k1>0.0</k1><k2>0.0</k2></calibration></sensor>"
    )


def _camera_xml(i, name, w2c, rt) -> str:
    """Invert ``extract_extrinsics``: undo the OpenGL -> COLMAP flip, the
    inverse, the per-view z rotation and the OpenGL column flip."""
    flip = np.diag([1.0, -1.0, -1.0])
    gl = np.eye(4)
    gl[:3, :3] = flip @ w2c[:3, :3]
    gl[:3, 3] = flip @ w2c[:3, 3]
    t = np.linalg.inv(gl)
    theta = -1 * rt * 90 * np.pi / 180
    c, s = np.cos(theta), np.sin(theta)
    rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    t[:3, :3] = t[:3, :3] @ rz.T
    t[:3, 1:3] *= -1
    vals = " ".join(f"{v:.17g}" for v in t.reshape(-1))
    return f'<camera id="{i}" sensor_id="{i}" label="{name}"><transform>{vals}</transform></camera>'


def _parsing_image(height, width, face_label="skin", mouth_label="inner_mouth") -> np.ndarray:
    """(H, W, 3) uint8 parsing image in the cameras' orientation: the
    center half ``face_label``, a block at its center ``mouth_label``, the
    rest background (the reference's BGR-swapped colormap)."""
    from topo4d_tpu_torch.pipeline.masks import bgr_colormap

    cmap = bgr_colormap(14)
    mk = np.zeros((height, width, 3), np.uint8)
    mk[height // 4 : 3 * height // 4, width // 4 : 3 * width // 4] = cmap[DEFAULT_CMAP_INDEX[face_label]]
    bh, bw = max(height // 8, 1), max(width // 8, 1)
    mk[height // 2 - bh // 2 : height // 2 - bh // 2 + bh, width // 2 - bw // 2 : width // 2 - bw // 2 + bw] = cmap[
        DEFAULT_CMAP_INDEX[mouth_label]
    ]
    return mk


def write_disk_sequence(
    root: str,
    num_views: int = 4,
    num_frames: int = 2,
    rows: int = 10,
    cols: int = 10,
    width: int = 48,
    height: int = 32,
    ratio: int = 8,
    view_names: Optional[Sequence[str]] = None,
    component: Optional[np.ndarray] = None,
    bg: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    level: int = 6,
    device="cuda",
) -> DiskTree:
    """A sequence in the reference's disk layout, the port's counterpart of
    ``scripts/fabricate_dataset.py``: under ``root/seq01``, ``cameras.xml``
    (the loader's math inverted), the startup mesh ``face_v5.obj`` with UVs,
    ``face_v5.png``, ``%06d/<view>.png`` frames rendered by this package's
    renderer (a head grid of ``rows`` x ``cols`` vertices that wobbles from
    frame 2 on) and ``mask/%06d/<view>.png`` parsing images;
    ``root/assets/facial_regions.pkl``; and the same frames and masks at
    ``ratio`` times the size under ``root + "_dense"`` (a dense ratio of 1).

    Views are named ``view_names`` (default ``view00``, ...), in sorted
    order (the loader's, and that of ``DiskTree``'s arrays). A view whose
    ``DEFAULT_ROTATE_MASK`` entry is +/-1 gets a landscape sensor and is
    stored rotated back, so the loader's portrait swap and rotation give the
    ``width`` x ``height`` camera. ``component`` (4, 4): a ``<components>``
    transform; the OBJ then holds the mesh in the component's frame, as
    ``build_scene`` expects. ``bg``: the targets' background color. PNGs are
    written at deflate ``level`` (1 keeps the full-size frames quick)."""
    from topo4d_tpu_torch.core.gaussian import activate_params
    from topo4d_tpu_torch.rasterizer.render import render_gaussians
    from topo4d_tpu_torch.topology.obj_io import write_obj_with_uv
    from topo4d_tpu_torch.utils.png import encode_png, write_png

    names = sorted(view_names) if view_names is not None else [f"view{i:02d}" for i in range(num_views)]
    if len(names) != num_views:
        raise ValueError(f"{len(names)} view names for {num_views} views")
    rts = [DEFAULT_ROTATE_MASK.get(n, 0) for n in names]
    seq = "seq01"
    seq_dir = os.path.join(root, seq)
    os.makedirs(seq_dir, exist_ok=True)

    verts, faces = make_grid_mesh(rows, cols, extent=0.5)
    n = verts.shape[0]
    uvs = grid_uvs(rows, cols)
    trans_g = np.eye(4) if component is None else np.asarray(component, np.float64)
    verts_g = (verts @ trans_g[:3, :3].T + trans_g[:3, 3]).astype(np.float32)
    write_obj_with_uv(os.path.join(seq_dir, "face_v5.obj"), verts_g, faces, uvs, [list(f) for f in faces])
    ty, tx = np.meshgrid(np.linspace(0, 1, 64), np.linspace(0, 1, 64), indexing="ij")
    tex = np.stack([tx, ty, 0.5 * np.ones_like(tx)], -1)
    write_png(os.path.join(seq_dir, "face_v5.png"), (tex * 255).astype(np.uint8))
    os.makedirs(os.path.join(root, "assets"), exist_ok=True)
    with open(os.path.join(root, "assets", "facial_regions.pkl"), "wb") as fh:
        pickle.dump(make_synthetic_regions(n, faces).to_dict(), fh)

    cams = make_camera_ring(num_views, width=width, height=height, distance=2.0, device=device)
    k = np.stack([cams.fx.cpu().numpy(), cams.cx.cpu().numpy(), cams.cy.cpu().numpy()], 1).astype(np.float64)
    w2c = cams.w2c.cpu().numpy().astype(np.float64)
    sensors = [_sensor_xml(i, *k[i], width, height, ratio, rts[i]) for i in range(num_views)]
    cameras = [_camera_xml(i, names[i], w2c[i], rts[i]) for i in range(num_views)]
    comp = ""
    if component is not None:
        comp = (
            '<components><component id="0" label="c0"><transform>'
            f"<rotation>{' '.join(f'{v:.17g}' for v in trans_g[:3, :3].reshape(-1))}</rotation>"
            f"<translation>{' '.join(f'{v:.17g}' for v in trans_g[:3, 3])}</translation>"
            "</transform></component></components>"
        )
    with open(os.path.join(seq_dir, "cameras.xml"), "w") as fh:
        fh.write(
            '<?xml version="1.0" encoding="UTF-8"?>\n<document><chunk>'
            f'<sensors>{"".join(sensors)}</sensors>{comp}<cameras>{"".join(cameras)}</cameras>'
            "</chunk></document>"
        )

    # the truth: the head grid with random colors, wobbling from frame 2 on
    rng = np.random.default_rng(0)
    pitch = 1.0 / max(rows, cols)
    truth = {
        "means3D": verts.astype(np.float32),
        "rgb_colors": rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32),
        "unnorm_rotations": np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1)),
        "logit_opacities": np.full((n, 1), 6.0, np.float32),
        "log_scales": np.full((n, 3), np.log(pitch / 2), np.float32),
    }
    cams_full = make_camera(
        np.stack([np.array([[f * ratio, 0, cx * ratio], [0, f * ratio, cy * ratio], [0, 0, 1.0]]) for f, cx, cy in k]),
        w2c, width * ratio, height * ratio, device=device,
    )
    bg_t = torch.as_tensor(bg, dtype=torch.float32, device=cams.device)
    tree = DiskTree(
        input_dir=root, dense_input_dir=root + "_dense", seq=seq, view_names=names,
        cameras=cams, cameras_full=cams_full, trans_g=trans_g, images={}, masks={}, turns=rts,
    )
    for t in range(1, num_frames + 1):
        params = dict(truth)
        if t > 1:
            wobble = 0.002 * np.sin(0.5 * t + np.linspace(0, 6.28, n))
            params["means3D"] = (verts + wobble[:, None] * np.array([0.3, 1.0, 0.2])).astype(np.float32)
        rv = activate_params({k_: torch.as_tensor(v, device=cams.device) for k_, v in params.items()})
        for full_res, base, rig in ((False, root, cams), (True, root + "_dense", cams_full)):
            fdir = os.path.join(base, seq, "%06d" % t)
            mdir = os.path.join(base, seq, "mask", "%06d" % t)
            os.makedirs(fdir, exist_ok=True)
            os.makedirs(mdir, exist_ok=True)
            ims, mks = [], []
            mk = _parsing_image(rig.height, rig.width)
            mask_png = {}  # one parsing image per tree: encoded once per rotation
            for v, name in enumerate(names):
                with torch.no_grad():
                    im = render_gaussians(rv, rig[v], bg=bg_t, max_span=4).image
                    im = torch.round(torch.clamp(im, 0.0, 1.0) * 255).to(torch.uint8)
                im = im.permute(1, 2, 0).cpu().numpy()
                ims.append(im.transpose(2, 0, 1))
                # stored so that the loader's rotation by rt * 90 degrees restores it
                with open(os.path.join(fdir, f"{name}.png"), "wb") as fh:
                    fh.write(encode_png(np.ascontiguousarray(np.rot90(im, -rts[v])), level=level))
                mks.append(mk.transpose(2, 0, 1))
                if rts[v] not in mask_png:
                    mask_png[rts[v]] = encode_png(np.ascontiguousarray(np.rot90(mk, -rts[v])), level=level)
                with open(os.path.join(mdir, f"{name}.png"), "wb") as fh:
                    fh.write(mask_png[rts[v]])
            tree.images[(t, full_res)] = np.stack(ims)
            tree.masks[(t, full_res)] = np.stack(mks)
    return tree
