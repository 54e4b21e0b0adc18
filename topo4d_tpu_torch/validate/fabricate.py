"""The validation datasets (``scripts/fabricate_dataset.py`` ``fabricate``
and ``scripts/fabricate_fast.py`` ``fabricate_fast``, one function here:
the two write the same tree; ``python -m topo4d_tpu_torch.validate
fabricate`` takes ``fabricate_fast.py``'s arguments and defaults).

A sequence in the reference's disk layout, rendered from a known scene:
under ``root/seq01`` the startup mesh ``face_v5.obj`` (a ``rows`` x
``cols`` head grid, with a real UV seam when ``uv_seam``) and its template
texture ``face_v5.png``, the Agisoft ``cameras.xml`` (the loader's math
inverted, so that ``down_ratio`` ``ratio`` gives the ``work_w`` x
``work_h`` ring), frames ``%06d/view<v>.png`` in which the grid wobbles by
``motion_scale`` from frame 2 on, and parsing images ``mask/%06d/`` with an
inner-mouth block; ``root/assets/facial_regions.pkl``; and with
``dense_tree`` the same frames at ``ratio`` times the size under
``root + "_dense"`` with a skin-labelled centre half.

Frames are rendered by this package's renderer (K1 on the card), every
view of a frame before one download, quantised as JAX's fabricator does
(``(clip(im, 0, 1) * 255)`` floored), and encoded by ``utils/png.py`` on a
thread pool. Each PNG is written under a temporary name and renamed, and a
frame whose views all exist is not rendered again, so an interrupted
fabrication resumes without trusting a half-written frame. The structure
(mesh, texture, regions, cameras) is rewritten every time. The parsing
images of frames 2 on are hard links to frame 1's.
"""

from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from topo4d_tpu_torch.config import DEFAULT_CMAP_INDEX
from topo4d_tpu_torch.core.camera import Camera, make_camera
from topo4d_tpu_torch.core.gaussian import activate_params
from topo4d_tpu_torch.device import resolve_device
from topo4d_tpu_torch.pipeline.data import SyntheticSequence
from topo4d_tpu_torch.pipeline.masks import bgr_colormap
from topo4d_tpu_torch.rasterizer.render import render_gaussians
from topo4d_tpu_torch.testing import (
    camera_xml,
    grid_scene,
    grid_uvs,
    make_camera_ring,
    make_grid_mesh,
    make_synthetic_regions,
    sensor_xml,
)
from topo4d_tpu_torch.topology.obj_io import write_obj_with_uv
from topo4d_tpu_torch.utils.png import encode_png, write_png

SEQ = "seq01"
ENCODE_THREADS = 8  # PNG encodes in flight (zlib releases the interpreter lock)


def seam_uvs(rows: int, cols: int, faces):
    """The two-island UV layout (``fabricate_dataset.py:42-73``): the grid's
    UV map splits at column ``cols // 2``, whose vertices carry two UV
    coordinates, one per island, with a u-gap between the islands; a face
    takes the island of its smallest column -> (uvs (K, 2), uv_faces)."""
    cm = cols // 2
    u_left = np.linspace(0.05, 0.46, cm + 1)
    u_right = np.linspace(0.54, 0.95, cols - cm)
    v_grid = np.linspace(0.05, 0.95, rows)
    left_ids = np.full((rows, cols), -1, np.int64)
    right_ids = np.full((rows, cols), -1, np.int64)
    uv_list = []
    for r in range(rows):
        for c in range(cm + 1):
            left_ids[r, c] = len(uv_list)
            uv_list.append((u_left[c], v_grid[r]))
    for r in range(rows):
        for c in range(cm, cols):
            right_ids[r, c] = len(uv_list)
            uv_list.append((u_right[c - cm], v_grid[r]))
    uv_faces = []
    for f in faces:
        ids = left_ids if min(int(v) % cols for v in f) < cm else right_ids
        uv_faces.append([int(ids[int(v) // cols, int(v) % cols]) for v in f])
    return np.asarray(uv_list, np.float32), uv_faces


def seam_face_mask(rows: int, cols: int) -> np.ndarray:
    """The densified vertices of the seam layout (``fabricate_dataset.py:101-117``):
    an 18x18 vertex patch centred on the seam, so that the dense phase spans
    both islands (the synthetic default, half the vertices at random, would
    make ~94% of the quads frontal: ~7.3M dense points at density 30)."""
    cm = cols // 2
    vids = np.arange(rows * cols)
    r_of, c_of = vids // cols, vids % cols
    r0 = max(rows // 2 - 9, 0)
    patch = (
        (r_of >= r0) & (r_of < min(r0 + 18, rows))
        & (c_of >= max(cm - 9, 0)) & (c_of < min(cm + 9, cols))
    )
    return vids[patch].astype(np.int32)


def cameras_xml(cams: Camera, ratio: int) -> str:
    """``cameras.xml`` whose calibration at ``resize_factor`` ``ratio`` gives
    ``cams``, views named ``view%02d`` (``fabricate_dataset.py:119-162``)."""
    fx, cx, cy = (getattr(cams, k).cpu().numpy().astype(np.float64) for k in ("fx", "cx", "cy"))
    w2cs = cams.w2c.cpu().numpy().astype(np.float64)
    views = range(w2cs.shape[0])
    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n<document><chunk>'
        f'<sensors>{"".join(sensor_xml(i, fx[i], cx[i], cy[i], cams.width, cams.height, ratio, 0) for i in views)}'
        f'</sensors><cameras>{"".join(camera_xml(i, f"view{i:02d}", w2cs[i], 0) for i in views)}</cameras>'
        "</chunk></document>"
    )


@torch.no_grad()
def render_frame(params: dict, means: np.ndarray, cams: Camera) -> np.ndarray:
    """Every view of one frame -> (V, H, W, 3) uint8, floored as JAX's
    fabricator quantises, in one download."""
    dev = cams.device
    rv = activate_params({
        k: torch.as_tensor(means if k == "means3D" else v, device=dev) for k, v in params.items()
    })
    ims = [render_gaussians(rv, cams[v], max_span=4).image for v in range(cams.fx.shape[0])]
    return (torch.clamp(torch.stack(ims), 0.0, 1.0) * 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()


def _write_atomic(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
    os.replace(tmp, path)


def _write_tree(pool, seq_dir, names, cams, params, src, num_frames, mask_img):
    """Queue frames 1..num_frames of one tree, a PNG encode per view, and
    write their parsing images (frame 1's, the later ones hard links to
    it) -> the futures."""
    mask_png = encode_png(mask_img)
    mask1 = os.path.join(seq_dir, "mask", "%06d" % 1)
    jobs = []
    for t in range(1, num_frames + 1):
        fdir = os.path.join(seq_dir, "%06d" % t)
        mdir = os.path.join(seq_dir, "mask", "%06d" % t)
        os.makedirs(fdir, exist_ok=True)
        os.makedirs(mdir, exist_ok=True)
        for name in names:
            dst = os.path.join(mdir, f"{name}.png")
            if t == 1:
                _write_atomic(dst, mask_png)
            elif not os.path.exists(dst):
                os.link(os.path.join(mask1, f"{name}.png"), dst)
        paths = [os.path.join(fdir, f"{n}.png") for n in names]
        if all(os.path.exists(p) for p in paths):
            continue  # complete: every view was renamed into place
        imgs = render_frame(params, src.vertices_at(t).astype(np.float32), cams)
        jobs += [pool.submit(lambda p, im: _write_atomic(p, encode_png(im)), p, im) for p, im in zip(paths, imgs)]
    return jobs


def fabricate(root, num_views=4, num_frames=2, rows=10, cols=10, work_w=48, work_h=32, ratio=8,
              motion_scale=0.002, dense_tree=True, uv_seam=False, device="cuda"):
    """Write the dataset the module docstring describes under ``root`` (and
    ``root + "_dense"`` with ``dense_tree``); renders on ``device``."""
    dev = resolve_device(device)
    seq = os.path.join(root, SEQ)
    os.makedirs(seq, exist_ok=True)

    verts, faces = make_grid_mesh(rows, cols, extent=0.5)
    n = verts.shape[0]
    if uv_seam:
        uvs, uv_faces = seam_uvs(rows, cols, faces)
    else:
        uvs, uv_faces = grid_uvs(rows, cols), [list(f) for f in faces]
    write_obj_with_uv(os.path.join(seq, "face_v5.obj"), verts, [list(f) for f in faces], uvs, uv_faces)
    # template texture: a smooth gradient, so that sampled vertex colors vary
    ty, tx = np.meshgrid(np.linspace(0, 1, 64), np.linspace(0, 1, 64), indexing="ij")
    write_png(os.path.join(seq, "face_v5.png"), (np.stack([tx, ty, 0.5 * np.ones_like(tx)], -1) * 255).astype(np.uint8))

    raw = make_synthetic_regions(n, faces).to_dict()
    if uv_seam:
        raw["face_masks"] = seam_face_mask(rows, cols)
    os.makedirs(os.path.join(root, "assets"), exist_ok=True)
    with open(os.path.join(root, "assets", "facial_regions.pkl"), "wb") as fh:
        pickle.dump(raw, fh)

    cams = make_camera_ring(num_views, width=work_w, height=work_h, distance=2.0, device=dev)
    with open(os.path.join(seq, "cameras.xml"), "w") as fh:
        fh.write(cameras_xml(cams, ratio))

    params = grid_scene(verts, rows, cols)
    src = SyntheticSequence(params=params, cameras=cams, num_frames=num_frames, motion_scale=motion_scale)
    names = [f"view{v:02d}" for v in range(num_views)]
    cmap = bgr_colormap(14)
    mouth = np.zeros((work_h, work_w, 3), np.uint8)
    mouth[work_h // 2 : work_h // 2 + 4, work_w // 2 : work_w // 2 + 4] = cmap[DEFAULT_CMAP_INDEX["inner_mouth"]]
    with ThreadPoolExecutor(max_workers=ENCODE_THREADS) as pool:
        jobs = _write_tree(pool, seq, names, cams, params, src, num_frames, mouth)
        if dense_tree:
            # the full-resolution tree (-did root_dense): intrinsics scaled by ratio
            k = np.zeros((num_views, 3, 3))
            k[:, 0, 0] = cams.fx.cpu().numpy().astype(np.float64) * ratio
            k[:, 1, 1] = cams.fy.cpu().numpy().astype(np.float64) * ratio
            k[:, 0, 2] = cams.cx.cpu().numpy().astype(np.float64) * ratio
            k[:, 1, 2] = cams.cy.cpu().numpy().astype(np.float64) * ratio
            k[:, 2, 2] = 1.0
            full_w, full_h = work_w * ratio, work_h * ratio
            dense_cams = make_camera(k, cams.w2c.cpu().numpy(), full_w, full_h, device=dev)
            skin = np.zeros((full_h, full_w, 3), np.uint8)
            skin[full_h // 4 : 3 * full_h // 4, full_w // 4 : 3 * full_w // 4] = cmap[DEFAULT_CMAP_INDEX["skin"]]
            jobs += _write_tree(pool, os.path.join(root + "_dense", SEQ), names, dense_cams, params, src,
                                num_frames, skin)
        for j in jobs:
            j.result()
    print(f"[fabricate] {num_frames} frames x {num_views} views at {root}" + (f" (+ {root}_dense)" if dense_tree else ""),
          flush=True)
