"""Sequence sources (``pipeline/data.py``): the reference-layout disk
sequence (:43), a synthetic sequence (:163) and the per-frame view schedule
(:223).

The disk layout follows the reference (train.py:58-112): a sequence
directory holding ``cameras.xml`` (Agisoft), per-frame subdirectories
``%06d`` of per-view images named by camera label, and optionally a
parallel ``mask/%06d/`` tree of face-parsing images. Views in the blacklist
are skipped; each image is rotated by its camera's +/-90-degree portrait
rotation. Images are decoded on the host by the C library (``utils/png.py``
and ``utils/jpeg.py``; ``read_image`` tells them apart by their leading
bytes) and stay there as their files hold them, uint8, beside each view's
quarter turns (``HostViews``); ``frame_tensor`` moves them to the card and
turns them into planes and converts them there.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from typing import Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch

from topo4d_tpu_torch.config import Config
from topo4d_tpu_torch.core.agisoft import load_camera
from topo4d_tpu_torch.core.camera import Camera, make_camera
from topo4d_tpu_torch.core.gaussian import activate_params
from topo4d_tpu_torch.rasterizer.render import render_gaussians_capped
from topo4d_tpu_torch.utils.jpeg import SOI, decode_jpeg
from topo4d_tpu_torch.utils.png import SIGNATURE, decode_png

# threads that decode a frame's views (zlib and the C library release the
# interpreter lock). On an 8-core H100 host (PERF.md, chip_smoke.py phase
# 9's sweep) a JPEG read on 4 threads ends soonest and costs the host-bound
# geometry loop little; a PNG read costs the loop more at 4 threads than
# at 1 (memory traffic is part of the cause, PERF.md section 7)
LOAD_THREADS = 4


class HostViews(NamedTuple):
    """A frame's views as their files hold them: ``pixels[v]`` (H, W, 3)
    uint8 and ``turns[v]``, the quarter turns (``np.rot90`` over axes (0,
    1)) that bring view v into its camera's frame."""

    pixels: List[np.ndarray]
    turns: List[int]

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.pixels)


class FrameData(NamedTuple):
    images: Union[np.ndarray, HostViews]  # (V, 3, H, W) float32 in [0, 1], or ``DiskSequence``'s HostViews
    masks: Optional[Union[np.ndarray, HostViews]]  # likewise, or None
    view_names: List[str]


def frame_tensor(x: Union[np.ndarray, HostViews], device) -> torch.Tensor:
    """A frame's images or parsing images on ``device`` as (V, 3, H, W)
    float32 in [0, 1]. ``HostViews`` move as uint8, as their files hold
    them; each view's quarter turn and the permute into planes run on
    ``device``, then the division: float32(x) / float32(255), the JAX
    loader's values bit for bit (a turn moves values, it changes none). The
    divisor is a tensor on ``device``: PyTorch's CUDA division by a host
    scalar multiplies by its reciprocal, which differs in the last bit for
    126 of the 256 values. A float32 array (``SyntheticSequence``'s) moves
    as it is."""
    if not isinstance(x, HostViews):
        return torch.as_tensor(x).to(device=device, dtype=torch.float32)
    t = torch.stack([
        torch.rot90(torch.from_numpy(px).to(device), k, dims=(0, 1)).permute(2, 0, 1)
        for px, k in zip(x.pixels, x.turns)
    ])
    return t.to(torch.float32) / torch.tensor(255.0, device=device)


def _stack_cameras(cam_dicts: List[Dict], near: float, far: float, device) -> Camera:
    ks = np.stack([c["intrinsics"] for c in cam_dicts])
    w2cs = np.stack([np.concatenate([c["extrinsics"], np.array([[0.0, 0.0, 0.0, 1.0]])], axis=0) for c in cam_dicts])
    h, w = cam_dicts[0]["image_size"]
    return make_camera(ks, w2cs, int(w), int(h), near, far, device=device)


def read_image(path: str) -> np.ndarray:
    """An image file as ``np.asarray(PIL.Image.open(path))`` gives it: a
    PNG or a JPEG, told apart by the file's leading bytes (as PIL does),
    whatever its extension. Every JPEG kind PIL reads into three or one
    channels is read: sequential and progressive, Huffman- and
    arithmetic-coded, progressive scans with bits left unsent (smoothed as
    libjpeg-turbo smooths them). What PIL fails on raises ``ValueError``
    naming the file (lossless, hierarchical, 12-bit, two-component, DNL-sized
    frames, more than 10 blocks per MCU, fractional sampling, bad DAC
    segments), and so does CMYK, which PIL reads as four channels. Damaged
    and cut-off files read as PIL reads them, or raise where it raises
    ("image file is truncated" and the rest): a JPEG's damaged scans as
    libjpeg-turbo reads them, gray past their data (``utils/jpeg.py``); a
    PNG's chunks as PIL's plugin reads them, its image data inflated only as
    far as the image needs (``utils/png.py`` ``decode_png``)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data.startswith(SIGNATURE):
        return decode_png(data, path)
    if data.startswith(SOI):
        return decode_jpeg(data, path)
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")


@dataclasses.dataclass
class DiskSequence:
    """Reference-layout sequence reader: the cameras at ``data.down_ratio``
    (``cameras``) and ``data.dense_down_ratio`` (``cameras_full``) on
    ``device``, ``trans_g`` (the calibration's component transform), and
    ``frame(t, full_res)`` -> host ``FrameData`` of uint8 pixels."""

    cfg: Config
    device: str = "cuda"

    def __post_init__(self):
        data = self.cfg.data
        seq_dir = os.path.join(data.input_dir, data.seq)
        calib = os.path.join(seq_dir, "cameras.xml")
        first = sorted(glob(os.path.join(seq_dir, "000001", "*.jpg"))) + sorted(
            glob(os.path.join(seq_dir, "000001", "*.png"))
        )
        self.view_files = [
            os.path.basename(f) for f in first
            if not any(os.path.basename(f).startswith(b) for b in data.blacklist)
        ]
        self.view_names = [os.path.splitext(v)[0] for v in self.view_files]
        cams, cams_full = [], []
        self.trans_g = np.eye(4)
        for name in self.view_names:
            rt = data.rotate_mask.get(name, 0)
            cam, trans_g = load_camera(calib, name, resize_factor=data.down_ratio, rt=rt)
            cam_full, _ = load_camera(calib, name, resize_factor=data.dense_down_ratio, rt=rt)
            cams.append(cam)
            cams_full.append(cam_full)
            self.trans_g = trans_g
        near, far = self.cfg.raster.near, self.cfg.raster.far
        self.cameras = _stack_cameras(cams, near, far, self.device)
        self.cameras_full = _stack_cameras(cams_full, near, far, self.device)
        self._warned_no_mask = self._warned_missing_mask = False

    @property
    def num_views(self) -> int:
        return len(self.view_names)

    def frame(self, t: int, full_res: bool = False) -> Optional[FrameData]:
        """1-based frame ``t`` (images as ``HostViews``, turned into the
        cameras' frame by ``frame_tensor``; the parsing images likewise, or
        None) or None when a view's image is missing."""
        data = self.cfg.data
        root = data.dense_input_dir if full_res else data.input_dir
        frame_dir = os.path.join(root, data.seq, "%06d" % t)
        mask_root = os.path.join(root, data.seq, "mask")
        want_mask = data.use_mask_dense if full_res else data.use_mask
        use_mask = want_mask and os.path.isdir(mask_root)
        if want_mask and not use_mask and not self._warned_no_mask:
            print(f"[topo4d_tpu_torch] mask dir {mask_root} not found - proceeding without face-parsing masks")
            self._warned_no_mask = True
        cam = self.cameras_full if full_res else self.cameras
        paths, mpaths, rts = [], [], []
        for fname, name in zip(self.view_files, self.view_names):
            path = os.path.join(frame_dir, fname)
            if not os.path.exists(path):
                alt = os.path.splitext(path)[0]
                for ext in (".jpg", ".png"):
                    if os.path.exists(alt + ext):
                        path = alt + ext
                        break
                else:
                    break  # the views before it are still read, and checked
            paths.append(path)
            rts.append(data.rotate_mask.get(name, 0))
            if use_mask:
                mbase = os.path.join(root, data.seq, "mask", "%06d" % t, os.path.splitext(fname)[0])
                # the images' extension fallback; a missing per-view mask
                # turns the frame maskless (one warning)
                for ext in (".png", ".jpg"):
                    if os.path.exists(mbase + ext):
                        mpaths.append(mbase + ext)
                        break
                else:
                    if not self._warned_missing_mask:
                        print(f"[topo4d_tpu_torch] mask {mbase}.png missing - frame {t} proceeds without masks")
                        self._warned_missing_mask = True
                    use_mask = False
        if not use_mask:
            mpaths = []
        with ThreadPoolExecutor(max_workers=LOAD_THREADS) as pool:
            views = list(pool.map(_load_view, paths, mpaths or [None] * len(paths)))
        for path, (im, _), rt in zip(paths, views, rts):
            shape = im.shape[:2] if rt % 2 == 0 else im.shape[1::-1]  # after the turn
            if shape != (cam.height, cam.width):
                raise ValueError(
                    f"{path} is {shape[1]}x{shape[0]} but the calibration at "
                    f"{'dense_' if full_res else ''}down_ratio="
                    f"{data.dense_down_ratio if full_res else data.down_ratio}"
                    f" expects {cam.width}x{cam.height}; point "
                    f"{'--dense_input_dir' if full_res else '--input_dir'} "
                    f"at images of that size or adjust the ratio"
                )
        if len(paths) < len(self.view_files):
            return None
        images = HostViews([im for im, _ in views], rts)
        masks = HostViews([mk for _, mk in views], rts) if use_mask else None
        return FrameData(images=images, masks=masks, view_names=self.view_names)


def _load_view(path: str, mpath: Optional[str]):
    """One view's image and parsing image (or None) as their files hold
    them, the parsing image cropped to the image's size (``frame_tensor``
    turns both on the card)."""
    raw = read_image(path)
    if raw.ndim != 3 or raw.shape[2] != 3:
        raise ValueError(f"{path}: a view must be an RGB image, got shape {raw.shape}")
    if mpath is None:
        return raw, None
    mk = read_image(mpath)
    if mk.ndim != 3 or mk.shape[2] != 3:
        raise ValueError(f"{mpath}: a parsing image must be RGB, got shape {mk.shape}")
    return raw, mk[: raw.shape[0], : raw.shape[1]]


@dataclasses.dataclass
class SyntheticSequence:
    """A known Gaussian scene whose vertices wobble over time; the targets
    are rendered on the cameras' device as the JAX package renders them
    (``render_gaussians_capped``: ``max_span`` 4, at most 512 entries a
    tile).

    ``cameras_full`` is the rig of the texture phase's full-resolution
    views (``frame(t, full_res=True)``); it defaults to ``cameras``.
    """

    params: Dict[str, np.ndarray]
    cameras: Camera
    num_frames: int = 3
    motion_scale: float = 0.002
    cameras_full: Optional[Camera] = None

    def __post_init__(self):
        if self.cameras_full is None:
            self.cameras_full = self.cameras
        self.view_names = [f"view{i:02d}" for i in range(self.num_views)]
        self._frames: Dict[tuple, FrameData] = {}

    @property
    def num_views(self) -> int:
        return int(self.cameras.fx.shape[0])

    def vertices_at(self, t: int) -> np.ndarray:
        base = self.params["means3D"]
        if t <= 1:
            return base
        wobble = self.motion_scale * np.sin(0.5 * t + np.linspace(0, 6.28, base.shape[0]))
        return base + wobble[:, None] * np.array([0.3, 1.0, 0.2])

    @torch.no_grad()
    def frame(self, t: int, full_res: bool = False) -> Optional[FrameData]:
        if t > self.num_frames:
            return None
        if (t, full_res) not in self._frames:
            cams = self.cameras_full if full_res else self.cameras
            dev = cams.device
            params = dict(self.params)
            params["means3D"] = self.vertices_at(t).astype(np.float32)
            rv = activate_params(
                {k: torch.as_tensor(np.asarray(v, np.float32), device=dev) for k, v in params.items()}
            )
            imgs = [render_gaussians_capped(rv, cams[i]).image.cpu().numpy() for i in range(self.num_views)]
            self._frames[(t, full_res)] = FrameData(images=np.stack(imgs), masks=None, view_names=self.view_names)
        return self._frames[(t, full_res)]


def view_order(num_views: int, num_iters: int, seed: int) -> np.ndarray:
    """Random view schedule without replacement per epoch (train.py:105-112)."""
    rng = np.random.default_rng(seed)
    epochs = -(-num_iters // num_views)
    order = np.concatenate([rng.permutation(num_views) for _ in range(epochs)])
    return order[:num_iters].astype(np.int32)
