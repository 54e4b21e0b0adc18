"""Geometry-only sequence trainer, parity mode (pipeline/trainer.py).

Per frame: warm start from the previous frame, then one view per Adam step
with a fresh binning every render (``schedule.views_per_step == 1``, the
reference's semantics). The batched all-views mode, frozen binnings, masks,
the texture phase, export and checkpoints are later slices.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from topo4d_tpu_torch.config import Config
from topo4d_tpu_torch.core.quaternion import quat_normalize
from topo4d_tpu_torch.device import resolve_device
from topo4d_tpu_torch.losses.flatten import build_fused_flatten, dihedral_cos
from topo4d_tpu_torch.losses.temporal import make_temporal_priors
from topo4d_tpu_torch.opt.adam import adam_init, reset_moments
from topo4d_tpu_torch.opt.step import (
    HARD_FLATTEN_KEYS,
    SOFT_FLATTEN_KEYS,
    GeometryPriors,
    TrainState,
    make_geometry_step,
)
from topo4d_tpu_torch.pipeline.data import view_order
from topo4d_tpu_torch.pipeline.scene import (
    SceneStatics,
    build_constraints,
    cache_first_frame_attrs,
)
from topo4d_tpu_torch.rasterizer.render import render_gaussians


def make_render_fn(cfg: Config, device):
    bg = torch.as_tensor(cfg.raster.bg, dtype=torch.float32, device=device)
    return lambda rv, cam: render_gaussians(rv, cam, bg=bg, max_span=cfg.raster.max_span)


class Trainer:
    """Fits the geometry of a sequence frame by frame on ``device``."""

    def __init__(
        self,
        cfg: Config,
        source,  # SyntheticSequence (any object with .cameras)
        params_np: Dict[str, np.ndarray],
        statics: SceneStatics,
        device="cuda",
    ):
        if cfg.schedule.views_per_step != 1:
            raise NotImplementedError("only the parity mode (views_per_step == 1) is ported")
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.source = source
        self.statics = statics
        n = params_np["means3D"].shape[0]
        self.render_fn = make_render_fn(cfg, dev)
        self.step = make_geometry_step(
            statics.quadruples, statics.umbrellas, self.render_fn, n,
            ring_indices=statics.ring.indices, device=dev,
        )
        self.params0 = {k: np.asarray(v, np.float32) for k, v in params_np.items()}
        params = {k: torch.as_tensor(v, device=dev) for k, v in self.params0.items()}
        self.state = TrainState(
            params=params, opt=adam_init(params),
            max_2d_radius=torch.zeros(n, dtype=torch.float32, device=dev),
        )

        def tp(a):  # one-ring tables transposed to (K, N)
            return torch.as_tensor(np.ascontiguousarray(np.asarray(a).T), device=dev)

        self._nbrT = tp(statics.ring.indices).to(torch.int64)
        fused = build_fused_flatten(statics.quadruples, HARD_FLATTEN_KEYS, SOFT_FLATTEN_KEYS)
        cos0 = dihedral_cos(params["means3D"], fused.quads)[fused.num_hard:]
        self.priors = GeometryPriors(
            neighbor_indices=self._nbrT,
            neighbor_dist=tp(statics.ring.dist),
            iso_w=tp(statics.iso_w),
            rig_w=tp(statics.rig_w),
            rot_w=tp(statics.rot_w),
            init_scale=torch.as_tensor(statics.init_scale, device=dev),
            temporal=make_temporal_priors(
                params["means3D"], quat_normalize(params["unnorm_rotations"]), self._nbrT
            ),
            cos_init=cos0.detach(),
        )
        self.first_frame_attrs: Optional[Dict[str, np.ndarray]] = None
        self.metrics_log: List[Dict] = []
        self._con_cache: Dict[str, tuple] = {}

    def weights_for(self, phase: str) -> Dict[str, float]:
        return self.cfg.weights.as_dict()

    def lrs_for(self, phase: str) -> Dict[str, float]:
        return dict(getattr(self.cfg.lrs, phase))

    def _constraints(self, phase: str):
        key = id(self.first_frame_attrs)
        cached = self._con_cache.get(phase)
        if cached is None or cached[0] != key:
            cons = build_constraints(
                phase, self.params0, self.statics.regions, self.first_frame_attrs, self.device
            )
            self._con_cache[phase] = (key, cons)
        return self._con_cache[phase][1]

    def fit_frame_geometry(self, t: int, frame_data) -> Dict[str, float]:
        """Fit frame ``t``: "init" for t == 0, "track" after. Returns the last
        logged metrics row (also appended to ``metrics_log``).

        After frame 0 the frame-0 color snapshot that the track constraints
        restore is cached, as the reference's frame loop does.
        """
        cfg = self.cfg
        sched = cfg.schedule
        is_init = t == 0
        num_iters = sched.init_opt_num if is_init else sched.opt_num
        images = torch.as_tensor(np.asarray(frame_data.images, np.float32), device=self.device)
        cams = self.source.cameras
        step_phase = "init" if is_init else "track"

        if not is_init:
            # warm start (train.py:420-438)
            p = self.state.params
            self.priors = self.priors._replace(
                temporal=make_temporal_priors(
                    p["means3D"], quat_normalize(p["unnorm_rotations"]), self._nbrT
                )
            )
            self.state = self.state._replace(
                opt=reset_moments(self.state.opt, ["means3D", "unnorm_rotations"])
            )

        order = view_order(images.shape[0], num_iters, seed=t)
        early_cut = int(num_iters * sched.eye_freeze_frac)

        def iter_attrs(i):
            """(constraint phase, lr key, log?) of iteration i."""
            if is_init:
                con = "init_early" if i < early_cut else "init"
                lr_key = "init"
            else:
                con = "track"
                lr_key = "polish" if i >= num_iters - sched.polish_iters else "track"
            return con, lr_key, i % sched.log_freq == 0 or i == num_iters - 1

        weights = self.weights_for(step_phase)
        metrics: Dict[str, float] = {}
        for i in range(num_iters):
            con_phase, lr_key, log_this = iter_attrs(i)
            vid = int(order[i])
            self.state, self.priors, m = self.step(
                self.state, images[vid], cams, vid, self.priors,
                self._constraints(con_phase), self.lrs_for(lr_key), weights,
                step_phase, with_metrics=log_this,
            )
            if log_this:
                metrics = {k: float(v) for k, v in m.items()}
                metrics["frame"] = t
                metrics["iter"] = i
                self.metrics_log.append(dict(metrics))
        if is_init:
            self.first_frame_attrs = cache_first_frame_attrs(self.state.params, self.statics.regions)
        return metrics
