"""The common metric of the validation runs (``scripts/eval_headline_common.py``).

The three headline modes log ``loss_total``s that do not compare (the
batched modes sum the photometric loss over all views and take 24 times
fewer regularizer steps). This scores each run's exported per-frame
parameters on one yardstick: the mean photometric loss (0.8 L1 + 0.2 (1 -
SSIM)) and the mean PSNR over every view against the dataset's frames.

A run's ``params.npz`` stacks only the per-frame keys (``means3D``,
``rgb_colors``, ``unnorm_rotations``); every frame is scored with frame 0's
scales, opacities and exposure (``cam_m``, ``cam_c``), as JAX's scorer does.
The render is ``render_gaussians_capped`` (``max_span`` 4, at most 512
entries a tile, as JAX's scorer renders): K1 on the card, the plain blend
on the CPU.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from topo4d_tpu_torch.config import Config
from topo4d_tpu_torch.core.gaussian import activate_params
from topo4d_tpu_torch.device import resolve_device
from topo4d_tpu_torch.losses.image import photometric_loss, psnr
from topo4d_tpu_torch.pipeline.data import DiskSequence, frame_tensor
from topo4d_tpu_torch.rasterizer.render import render_gaussians_capped

MODES = ("parity", "batched0", "headline")
FRAME_KEYS = ("means3D", "rgb_colors", "unnorm_rotations")  # stacked per frame in params.npz
FIRST_FRAME_KEYS = ("log_scales", "logit_opacities", "cam_m", "cam_c")


def frame_params(npz, t: int) -> Dict[str, np.ndarray]:
    """Frame ``t``'s parameters from a ``params.npz``. A one-frame run's file
    holds nothing stacked (``pipeline/checkpoint.py`` ``save_params``), so
    there frame 0 is the file's arrays as they are."""
    stacked = npz["means3D"].ndim == 3
    out = {k: npz[k][t] if stacked else npz[k] for k in FRAME_KEYS}
    out.update({k: npz[k] for k in FIRST_FRAME_KEYS})
    return out


def open_source(root: str, down_ratio: int = 2, device="cuda") -> DiskSequence:
    """The dataset's ``seq01`` at ``down_ratio``, without parsing masks."""
    cfg = Config()
    cfg.data.input_dir = root
    cfg.data.seq = "seq01"
    cfg.data.down_ratio = down_ratio
    cfg.data.use_mask = False
    return DiskSequence(cfg, device=str(resolve_device(device)))


@torch.no_grad()
def score_params(src: DiskSequence, npz, frames: int) -> Dict[int, Dict[str, float]]:
    """Frames ``0 .. frames - 1`` of ``npz`` scored against the source's
    frames ``1 .. frames`` on the source's device -> {t: {"photometric_mean",
    "psnr_mean"}}."""
    cams = src.cameras
    dev = cams.device
    rows = {}
    for t in range(frames):
        p = {k: torch.as_tensor(v, device=dev) for k, v in frame_params(npz, t).items()}
        rv = activate_params(p)
        gt = frame_tensor(src.frame(t + 1).images, dev)
        pls, pss = [], []
        for i in range(src.num_views):
            im = render_gaussians_capped(rv, cams[i]).image
            im = torch.exp(p["cam_m"][i])[:, None, None] * im + p["cam_c"][i][:, None, None]
            pls.append(float(photometric_loss(im, gt[i])))
            pss.append(float(torch.mean(psnr(im, gt[i]))))
        rows[t] = {"photometric_mean": float(np.mean(pls)), "psnr_mean": float(np.mean(pss))}
    return rows


def run_params(vroot: str, mode: str, exp: str = "val"):
    """A validation run's ``params.npz`` (``<vroot>/<mode>/<exp>/seq01``)."""
    return np.load(os.path.join(vroot, mode, exp, "seq01", "params.npz"))


def main(root: str, vroot: str, frames: int = 4, device="cuda") -> Dict[str, Dict[int, Dict[str, float]]]:
    """Score the three headline modes' runs under ``vroot`` against the
    dataset at ``root`` (``down_ratio`` 2) into ``<vroot>/common_metric.json``."""
    src = open_source(root, 2, device)
    report = {}
    for mode in MODES:
        rows = score_params(src, run_params(vroot, mode), frames)
        for t, r in rows.items():
            print(f"{mode} frame {t}: photometric {r['photometric_mean']:.5f} psnr {r['psnr_mean']:.2f}", flush=True)
        report[mode] = rows
    out = os.path.join(vroot, "common_metric.json")
    with open(out, "w") as fh:
        json.dump(report, fh, indent=2)
    print("wrote", out)
    return report
