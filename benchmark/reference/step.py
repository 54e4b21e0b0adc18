"""The dense texture phase in plain PyTorch: the reference the benchmark
holds the program to.

Topo4D's texture loop (``train.py:381-417``, ``:715-743``): a dense
Gaussian set sampled in UV space (``dense_set``) follows each frame's mesh;
only its colours and rotations learn, by Adam (torch.optim.Adam, eps
1e-15); before every step the static, dynamic and inner-mouth colours are
set to 0; one full-resolution view per step, in the order of the frame's
view schedule (a fresh permutation of the views per epoch from
``numpy.random.default_rng(10000 + frame)``); the loss is ``loss.dense_loss``
against the previous frame's colours. Nothing here imports the program
under test.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import render as R
from .dense_set import OPACITY, black_vertices, densify, knn_log_scales
from .loss import dense_loss

LEAVES = ("dense_rgb_colors", "dense_unnorm_rotations", "dense_logit_opacities", "dense_log_scales")


def view_schedule(num_views: int, steps: int, frame: int) -> List[int]:
    rng = np.random.default_rng(10_000 + frame)
    order = np.concatenate([rng.permutation(num_views) for _ in range(-(-steps // num_views))])
    return [int(v) for v in order[:steps]]


class DenseReference:
    """The dense set of a mesh and its Adam state, stepped one view at a time."""

    def __init__(self, scene, config: dict, device, value_dtype=torch.float32):
        self.dev = device
        self.value_dtype = value_dtype
        self.max_span = config["max_span"]
        self.weights = config["dense_weights"]
        ds = densify(scene.verts, scene.faces, scene.uvs, scene.uv_faces, scene.regions["face_masks"],
                     config["density"])
        self.idx = torch.as_tensor(ds.idx, device=device)
        self.w = torch.as_tensor(ds.w, device=device)
        n = ds.idx.shape[0]
        mesh_colors = scene.colors.copy()
        self.black = torch.as_tensor(black_vertices(scene.regions), device=device)
        mesh_colors[black_vertices(scene.regions)] = 0.0
        logit = float(np.log(OPACITY / (1.0 - OPACITY)))
        self.params = {
            "dense_rgb_colors": self.interpolate(torch.as_tensor(mesh_colors, device=device)),
            "dense_unnorm_rotations": torch.tensor([1.0, 0.0, 0.0, 0.0], device=device).repeat(n, 1),
            "dense_logit_opacities": torch.full((n, 1), logit, device=device),
            "dense_log_scales": torch.as_tensor(knn_log_scales(ds.pos0), device=device)[:, None].repeat(1, 3),
        }
        # the opacities learn at rate 0: constants of the dense phase, with no gradient
        for k in ("dense_rgb_colors", "dense_unnorm_rotations", "dense_log_scales"):
            self.params[k].requires_grad_(True)
        lrs = config["dense_lrs"]
        self.opt = torch.optim.Adam([{"params": [self.params[k]], "lr": lrs[k]} for k in LEAVES], eps=1e-15)
        self.means = self.anchor = None

    def interpolate(self, mesh_attr: torch.Tensor) -> torch.Tensor:
        a = mesh_attr[self.idx]  # (P, 4, C)
        w = self.w
        return w[:, 0:1] * a[:, 0] + w[:, 1:2] * a[:, 1] + w[:, 2:3] * a[:, 2] + w[:, 3:4] * a[:, 3]

    def start_frame(self, head: np.ndarray) -> None:
        """The frame's dense positions follow its mesh; its colours are the anchor."""
        with torch.no_grad():
            self.means = self.interpolate(torch.as_tensor(head, device=self.dev))
            self.anchor = self.params["dense_rgb_colors"].detach().clone()

    def snapshot(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.params.items()}

    def step(self, cam: R.Camera, target: torch.Tensor) -> float:
        """One Adam step on one view; ``target`` (3, H, W) in [0, 1] -> the loss."""
        p = self.params
        with torch.no_grad():
            p["dense_rgb_colors"][self.black] = 0.0
        self.opt.zero_grad(set_to_none=True)
        xy, depth, conic, radius, visible = R.project(
            self.means, p["dense_unnorm_rotations"], torch.exp(p["dense_log_scales"]), cam)
        opacity = torch.sigmoid(p["dense_logit_opacities"]).reshape(-1)
        bins = R.bin_tiles(xy, depth, radius, visible, cam.width, cam.height, self.max_span)
        leaves = [t.detach().requires_grad_(True) for t in (conic, p["dense_rgb_colors"])]
        vd = self.value_dtype
        image = R.render(bins, xy.detach(), conic.detach(), opacity, p["dense_rgb_colors"].detach(),
                         cam.width, cam.height, vd)
        image.requires_grad_(True)
        loss = dense_loss(image, target.to(vd), p["dense_rgb_colors"].to(vd), self.anchor, self.weights)
        loss.backward()
        R.backward(bins, image.grad, xy.detach(), leaves[0], opacity, leaves[1], vd)
        conic.backward(leaves[0].grad)
        p["dense_rgb_colors"].grad += leaves[1].grad
        self.last_grads = {k: torch.zeros_like(v) if v.grad is None else v.grad.detach().clone() for k, v in p.items()}
        self.opt.step()
        return float(loss.detach())


def run_reference(scene, config: dict, frames, schedule, device, value_dtype=torch.float32) -> dict:
    """The first ``steps`` of each ``(frame, steps)`` of ``schedule`` ->
    readings {"losses": [each step's], "grad_norms": {leaf: the first step's},
    "change_norms": {leaf: after the last step}, "adam_steps": the steps taken}.
    ``frames[f]`` is frame f's (head (V, 3), target views [(H, W, 3) uint8 on the host])."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = DenseReference(scene, config, device, value_dtype)
    p0 = ref.snapshot()
    losses, grad_norms = [], None
    for frame, steps in schedule:
        head, views = frames[frame]
        ref.start_frame(head)
        for v in view_schedule(config["views"], steps, frame):
            target = torch.as_tensor(views[v], device=device).permute(2, 0, 1).to(torch.float32)
            target = target / torch.tensor(255.0, device=device)
            losses.append(ref.step(R.rig_camera(scene.dense_rig, v, device), target))
            if grad_norms is None:
                grad_norms = {k: float(g.double().norm()) for k, g in ref.last_grads.items()}
    p1 = ref.snapshot()
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": {k: float((p1[k].double() - p0[k].double()).norm()) for k in LEAVES},
            "adam_steps": len(losses)}
