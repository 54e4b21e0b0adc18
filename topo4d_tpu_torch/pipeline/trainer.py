"""Sequence trainer (pipeline/trainer.py).

``Trainer.run`` fits a sequence frame by frame. Per frame: the geometry fit
(warm start from the previous frame, then either one view per Adam step
with a fresh binning every render, ``schedule.views_per_step == 1``, the
reference's semantics, or every view in each step,
``views_per_step == 0``, the batched mode); the dense texture fit (one
full-resolution view per step through frozen per-view binnings, compact
tiles and the split pack); then the frame's checkpoint (``resume.pkl``,
every ``ckp_freq`` frames ``params.npz``) and export (``face.obj`` and the
baked ``face.png``), on a worker thread while the next frame fits
(``schedule.async_export``).

With ``schedule.use_scan`` the geometry fit runs each segment of
identically configured steps through a multi-step, and with a resolved
``raster.track_rebin_freq`` above 0 (auto: 25 in the batched mode) each
segment freezes per-view binnings computed at its entry, capped at that
many steps. Segment boundaries are semantics, not scheduling: a binning is
recomputed at each entry, so they fall exactly where the JAX package's do.
With ``schedule.fuse_views`` (batched mode, pallas backend) every view of a
step renders in one K1 and one K2 launch on a tall canvas, and each step
bins afresh (no multi-step), as in JAX.

A source with face-parsing masks dims the inner mouth of tracked frames'
targets (``data.use_mask``), and the dense phase takes the masked L1 loss
under ``data.use_mask_dense``. At each geometry log row the views of
``data.log_views`` are rendered to ``<out>/%06d/vis<name>_<iter>.png``.
``raster.backend`` picks the renderer: "pallas" (the blend kernels on the
card), "tiled" or "oracle" (plain PyTorch renderers; frozen binnings are
pallas-only). ``data.checkpoint_backend`` picks the resume checkpoint:
"pickle" (``resume.pkl``) or "orbax" (a ``torch.distributed.checkpoint``
directory).

Several processes (``parallel/multihost.py``) run the same fit, each on its
card: the batched mode shards each step's views over a view mesh of the
ranks (no fused views, no segments: a fresh binning every step), the dense
phase shards each render's tiles over the ranks under
``texture.tile_shard``, and everything else runs replicated. Only rank 0
(host 0) writes: the output directory, checkpoints, ``params.npz``,
``loss.json``, exports, ``metrics.jsonl``, ``timings.json`` and progress
renders. A resume reads the checkpoint on every rank and checks that all
read rank 0's frame.
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from topo4d_tpu_torch.config import Config, check_schedule, effective_track_rebin_freq
from topo4d_tpu_torch.core.gaussian import activate_params
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
    make_geometry_multi_step,
    make_geometry_step,
)
from topo4d_tpu_torch.parallel.batched import make_batched_geometry_multi_step, make_batched_geometry_step
from topo4d_tpu_torch.parallel.mesh import make_view_mesh, mesh_size, shard_view_batch
from topo4d_tpu_torch.parallel.multihost import is_host0, process_count, process_index
from topo4d_tpu_torch.pipeline import checkpoint as ckpt
from topo4d_tpu_torch.pipeline.data import frame_tensor, view_order
from topo4d_tpu_torch.pipeline.export import build_bake_binning, save_mesh
from topo4d_tpu_torch.pipeline.masks import dim_inner_mouth
from topo4d_tpu_torch.pipeline.progress import report_progress
from topo4d_tpu_torch.pipeline.scene import (
    SceneStatics,
    build_constraints,
    build_dense_pre_constraints,
    cache_first_frame_attrs,
    init_dense_params,
)
from topo4d_tpu_torch.rasterizer.render import (
    attach_compact,
    binning_for,
    render_gaussians,
    render_gaussians_multiview,
    render_gaussians_tile_sharded,
)
from topo4d_tpu_torch.rasterizer.tiles import Binning
from topo4d_tpu_torch.texture.dense import (
    TextureState,
    dense_rendervars,
    make_texture_eval,
    make_texture_multi_step,
    make_texture_step,
)
from topo4d_tpu_torch.topology.interpolate import interpolate_dense_attribute
from topo4d_tpu_torch.utils.profiling import PhaseTimer, count, device_trace, mpix_per_s, span, traced, tracing


def make_render_fn(cfg: Config, device):
    """``render(rv, cam) -> RenderOutput`` of ``raster.backend``
    (``pipeline/trainer.py:72-93``)."""
    bg = torch.as_tensor(cfg.raster.bg, dtype=torch.float32, device=device)
    backend = cfg.raster.backend
    if backend == "pallas":
        return lambda rv, cam: render_gaussians(rv, cam, bg=bg, max_span=cfg.raster.max_span)
    if backend == "tiled":
        from topo4d_tpu_torch.rasterizer.tiled import render_gaussians_tiled

        return lambda rv, cam: render_gaussians_tiled(
            rv, cam, bg=bg, max_span=cfg.raster.max_span, capacity=cfg.raster.capacity
        )
    if backend == "oracle":
        from topo4d_tpu_torch.rasterizer.reference import render_gaussians as render_oracle

        return lambda rv, cam: render_oracle(rv, cam, bg=bg)
    raise ValueError(f"unknown rasterizer backend {backend!r}")


def make_geo_binning_fns(cfg: Config, device):
    """(binned_render_fn, binnings_fn) of the geometry phase's frozen
    binnings (``pipeline/trainer.py:96-138``), or (None, None) when the
    resolved ``raster.track_rebin_freq`` is 0 (a fresh binning every
    render). The binned render takes no compact list and no static rows, as
    in JAX. Frozen binnings are the pallas backend's (``:108-112``)."""
    if cfg.raster.backend != "pallas" or effective_track_rebin_freq(cfg) <= 0:
        return None, None
    bg = torch.as_tensor(cfg.raster.bg, dtype=torch.float32, device=device)
    span = cfg.raster.max_span

    def binned_render_fn(rv, cam, binning):
        return render_gaussians(rv, cam, bg=bg, max_span=span, binning=binning)

    def binnings_fn(params, cams):
        rv = activate_params(params)
        return [binning_for(rv, cams[v], max_span=span) for v in range(int(cams.fx.shape[0]))]

    return binned_render_fn, binnings_fn


def make_dense_render_fn(cfg: Config, device):
    """Dense-loop renderer ``(rv, cam, binning)``: a manual
    ``texture.tile_capacity`` (> 0) rides every render; the auto capacity
    (-1) rides the compact list the trainer attaches to each frozen
    binning. Backends other than pallas take no binning (``:140-160``).
    Under ``texture.tile_shard`` with more than one rank, each render's
    tiles shard over all ranks (the frozen binning's compact list, when it
    has one)."""
    if cfg.raster.backend != "pallas":
        base = make_render_fn(cfg, device)
        return lambda rv, cam, binning: base(rv, cam)
    bg = torch.as_tensor(cfg.raster.bg, dtype=torch.float32, device=device)
    if cfg.texture.tile_shard and process_count() > 1:
        return lambda rv, cam, binning: render_gaussians_tile_sharded(
            rv, cam, bg=bg, max_span=cfg.raster.max_span, binning=binning
        )
    cap = cfg.texture.tile_capacity if cfg.texture.tile_capacity > 0 else None
    return lambda rv, cam, binning: render_gaussians(
        rv, cam, bg=bg, max_span=cfg.raster.max_span, binning=binning, tile_capacity=cap
    )


def _binning_table(binnings: List[Binning]) -> List[Tuple[int, int, int]]:
    """Each binning's (occupied tiles, valid entries, cropped Gaussians), in
    one read-back from the card (the binnings share one canvas; a tile's
    count is its valid entries)."""
    counts = torch.stack([b.tile_count for b in binnings])
    cropped = torch.stack([b.num_cropped for b in binnings]).to(torch.int64)
    table = torch.stack([torch.sum(counts > 0, dim=1), torch.sum(counts, dim=1), cropped], dim=1)
    return [tuple(row) for row in table.tolist()]


def _blend_rows(binning: Binning) -> int:
    """The rows a blend through ``binning`` launches over: its compact
    capacity, or the canvas's tiles when it has no compact list."""
    return int((binning.tile_count if binning.compact is None else binning.compact.ids).shape[0])


class Trainer:
    """Fits a sequence frame by frame on ``device``: geometry, then the
    dense texture phase."""

    def __init__(
        self,
        cfg: Config,
        source,  # DiskSequence | SyntheticSequence
        params_np: Dict[str, np.ndarray],
        statics: SceneStatics,
        device="cuda",
    ):
        check_schedule(cfg)
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.source = source
        self.statics = statics
        n = params_np["means3D"].shape[0]
        sched = cfg.schedule
        self.render_fn = make_render_fn(cfg, dev)
        geo = (statics.quadruples, statics.umbrellas, self.render_fn, n)
        ring = statics.ring.indices
        self.step = make_geometry_step(*geo, ring_indices=ring, device=dev)
        # segments of identically configured steps; with a resolved
        # track_rebin_freq > 0 they freeze per-view binnings at their entry
        self._binned_render_fn, self._binnings_fn = make_geo_binning_fns(cfg, dev)
        frozen = dict(binned_render_fn=self._binned_render_fn, binnings_fn=self._binnings_fn)
        self.multi_step = None
        if sched.views_per_step == 1 and sched.use_scan:
            self.multi_step = make_geometry_multi_step(*geo, ring_indices=ring, **frozen, device=dev)
        # several ranks, batched mode: each renders its block of the views;
        # the view axis divides evenly (``pipeline/trainer.py:206-218``)
        self.mesh = None
        if sched.views_per_step == 0 and process_count() > 1:
            size = mesh_size(source.num_views, process_count())
            self.mesh = make_view_mesh(size, device=dev) if size > 1 else None
        # single card, pallas backend: all views of a batched step in one K1
        # and one K2 launch on a tall canvas (``pipeline/trainer.py:235-253``);
        # then no batched multi-step, so every step bins afresh
        multiview_fn = None
        if sched.fuse_views and cfg.raster.backend == "pallas" and self.mesh is None:
            bg = torch.as_tensor(cfg.raster.bg, dtype=torch.float32, device=dev)

            def multiview_fn(rv, cams):
                return render_gaussians_multiview(rv, cams, bg=bg, max_span=cfg.raster.max_span)

        self.batched_step = make_batched_geometry_step(
            *geo, ring_indices=ring, device=dev, multiview_render_fn=multiview_fn, mesh=self.mesh
        )
        self.batched_multi_step = None
        if sched.views_per_step == 0 and sched.use_scan and multiview_fn is None and self.mesh is None:
            self.batched_multi_step = make_batched_geometry_multi_step(*geo, ring_indices=ring, **frozen, device=dev)
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
        self.output_params: List[Dict[str, np.ndarray]] = []  # per-frame params.npz snapshots
        self.metrics_log: List[Dict] = []
        self.timer = PhaseTimer()
        self._bake_binning = None  # the per-sequence bake binning, built at the first export
        self._last_geo_renders = 0
        # (frame, first step, end step) of every multi-step segment run
        self.geo_segments: List[tuple] = []
        self._out_dir = os.path.join(cfg.data.output_dir, cfg.data.exp, cfg.data.seq)
        self._con_cache: Dict[str, tuple] = {}
        # the texture phase, built at its first frame
        self.texture_step = self.texture_multi_step = self.texture_eval = None
        self._texture_masked: Optional[bool] = None  # the mask state the texture step was built for
        self.texture_state: Optional[TextureState] = None
        self.dense_means3d: Optional[torch.Tensor] = None
        self.dense_anchor: Optional[torch.Tensor] = None
        self._auto_tile_cap = 0
        # under a profiler, the frame's counted binnings by id: (blend rows, occupied tiles)
        self._binning_rows: Dict[int, Tuple[int, int]] = {}

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
        logged metrics row (also appended to ``metrics_log``). A tracked
        frame's targets have their inner mouth dimmed when the source has
        masks and ``data.use_mask`` (``pipeline/trainer.py:369-382``); each
        log row renders ``data.log_views`` (``:475-480``, ``:524-529``).

        After frame 0 the frame-0 color snapshot that the track constraints
        restore is cached, as the reference's frame loop does.
        """
        cfg = self.cfg
        sched = cfg.schedule
        is_init = t == 0
        num_iters = sched.init_opt_num if is_init else sched.opt_num
        images = frame_tensor(frame_data.images, self.device)
        if not is_init and cfg.data.use_mask and frame_data.masks is not None:
            masks = frame_tensor(frame_data.masks, self.device)
            images = torch.stack([dim_inner_mouth(im, mk, cfg.data.cmap_index) for im, mk in zip(images, masks)])
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

        weights = self.weights_for(step_phase)

        def report(i):  # host 0 alone writes
            if cfg.data.log_views and is_host0():
                report_progress(
                    self.state.params, self.render_fn, cams, images, frame_data.view_names, cfg.data.log_views,
                    self._out_dir, t + 1, i,
                )

        if sched.views_per_step == 0:
            metrics = self._fit_batched(t, images, cams, step_phase, weights, report)
        else:
            metrics = self._fit_parity(t, images, cams, num_iters, step_phase, weights, report)
        if is_init:
            self.first_frame_attrs = cache_first_frame_attrs(self.state.params, self.statics.regions)
        return metrics

    def _walk(self, t: int, n: int, attrs, multi: bool, run_segment, run_step, report) -> Dict[str, float]:
        """Run steps 0..n-1 of frame ``t``; ``attrs(i)`` is step i's
        (constraint phase, lr key, log?). With the multi-step (``multi``),
        each run of unlogged steps of one configuration is one
        ``run_segment(i, j, constraints, lr)``, capped at the resolved
        ``track_rebin_freq`` when binnings are frozen
        (``pipeline/trainer.py:434-455``, ``:489-508``); every other step is
        ``run_step(i, constraints, lr, log?) -> metrics``, and a logged one
        is followed by ``report(i)``. Returns the last logged row."""
        seg_cap = effective_track_rebin_freq(self.cfg) if self._binnings_fn is not None else n
        metrics: Dict[str, float] = {}
        i = 0
        while i < n:
            con_phase, lr_key, log_this = attrs(i)
            constraints, lr = self._constraints(con_phase), self.lrs_for(lr_key)
            if multi and not log_this:
                j = i + 1
                while j < n and j - i < seg_cap and attrs(j) == (con_phase, lr_key, False):
                    j += 1
                run_segment(i, j, constraints, lr)
                self.geo_segments.append((t, i, j))
                i = j
                continue
            m = run_step(i, constraints, lr, log_this)
            if log_this:
                metrics = {k: float(v) for k, v in m.items()}
                metrics["frame"] = t
                metrics["iter"] = i
                self.metrics_log.append(dict(metrics))
                report(i)
            i += 1
        return metrics

    def _fit_parity(self, t, images, cams, num_iters, step_phase, weights, report) -> Dict[str, float]:
        """One view per step (``pipeline/trainer.py:484-531``)."""
        sched = self.cfg.schedule
        is_init = t == 0
        self._last_geo_renders = num_iters  # one view per iteration
        order = [int(v) for v in view_order(images.shape[0], num_iters, seed=t)]
        early_cut = int(num_iters * sched.eye_freeze_frac)

        def attrs(i):
            if is_init:
                con = "init_early" if i < early_cut else "init"
                lr_key = "init"
            else:
                con = "track"
                lr_key = "polish" if i >= num_iters - sched.polish_iters else "track"
            return con, lr_key, i % sched.log_freq == 0 or i == num_iters - 1

        def run_segment(i, j, constraints, lr):
            self.state, self.priors, _ = self.multi_step(
                self.state, images, cams, order[i:j], self.priors, constraints, lr, weights, step_phase
            )

        def run_step(i, constraints, lr, log_this):
            vid = order[i]
            self.state, self.priors, m = self.step(
                self.state, images[vid], cams, vid, self.priors, constraints, lr, weights,
                step_phase, with_metrics=log_this,
            )
            return m

        return self._walk(t, num_iters, attrs, self.multi_step is not None, run_segment, run_step, report)

    def batched_schedule(self, t: int, num_views: int):
        """The batched mode's contraction of frame ``t``'s schedule
        (``pipeline/trainer.py:405-431``) -> (nb steps, log_every, attrs):
        every step consumes all views, so ``nb = batched_opt_num or
        ceil(num_iters / V)``; the phase boundaries (eye freeze, polish) keep
        their fractional positions; ``attrs(i)`` is step i's (constraint
        phase, lr key, log?)."""
        sched = self.cfg.schedule
        is_init = t == 0
        num_iters = sched.init_opt_num if is_init else sched.opt_num
        nb = sched.batched_opt_num or -(-num_iters // num_views)
        log_every = max(1, round(nb * sched.log_freq / num_iters))

        def attrs(i):
            frac = i / nb
            if is_init:
                con = "init_early" if frac < sched.eye_freeze_frac else "init"
                lr_key = "init"
            else:
                con = "track"
                lr_key = "polish" if frac >= 1.0 - sched.polish_iters / num_iters else "track"
            return con, lr_key, i % log_every == 0 or i == nb - 1

        return nb, log_every, attrs

    def _fit_batched(self, t, images, cams, step_phase, weights, report) -> Dict[str, float]:
        """All views per step (``pipeline/trainer.py:405-482``); under a
        view mesh each rank steps on its block of the views
        (``:413-417``)."""
        nb, _, attrs = self.batched_schedule(t, images.shape[0])
        self._last_geo_renders = nb * images.shape[0]  # every batched step renders all views
        if self.mesh is not None:
            images, cams = shard_view_batch(self.mesh, images), shard_view_batch(self.mesh, cams)

        def run_segment(i, j, constraints, lr):
            self.state, self.priors, _ = self.batched_multi_step(
                self.state, images, cams, self.priors, constraints, lr, weights, step_phase, j - i
            )

        def run_step(i, constraints, lr, log_this):
            self.state, self.priors, m = self.batched_step(
                self.state, images, cams, self.priors, constraints, lr, weights, step_phase
            )
            return m

        return self._walk(t, nb, attrs, self.batched_multi_step is not None, run_segment, run_step, report)

    def _auto_tile_capacity(self, occ: int, total_tiles: int) -> int:
        """Sticky auto tile capacity (``texture.tile_capacity = -1``):
        occupancy x 1.2 rounded up to 2048 on canvases above 8,192 tiles (64
        below), never shrinking across frames, at most the canvas (where
        ``attach_compact`` leaves compact mode off)."""
        quantum = 2048 if total_tiles > 8192 else 64
        cap = -(-int(occ * 1.2) // quantum) * quantum
        self._auto_tile_cap = max(cap, self._auto_tile_cap)
        return min(self._auto_tile_cap, total_tiles)

    def _fresh_dense_binning(self, v: int) -> Binning:
        """View ``v``'s binning of the current dense state, with the split
        pack's static rows and a manual ``texture.tile_capacity``'s compact
        list (``pipeline/trainer.py:636-651``)."""
        cfg = self.cfg
        cap_cfg = cfg.texture.tile_capacity
        return binning_for(
            dense_rendervars(self.texture_state.params, self.dense_means3d), self.source.cameras_full[v],
            max_span=cfg.raster.max_span, with_static=cfg.texture.split_pack,
            tile_capacity=cap_cfg if cap_cfg > 0 else None,
        )

    def _auto_compact(self, binnings: List[Binning]) -> List[Binning]:
        """Under the auto capacity, one compact list for all of ``binnings``,
        sized from their largest occupancy (one read back from the card);
        otherwise the binnings as they are (``pipeline/trainer.py:653-669``).

        Under a profiler a second read-back, after the untraced path's work,
        takes each binning's occupied tiles, valid entries and cropped
        Gaussians; the binnings are counted (``binning.entries``,
        ``binning.cropped``, ``binning.overflow``) and kept for the count of
        their renders (``_counted_render``)."""
        if self.cfg.texture.tile_capacity < 0:
            occ = int(torch.max(torch.stack([torch.sum(b.tile_count > 0) for b in binnings])))
            cap = self._auto_tile_capacity(occ, int(binnings[0].tile_count.shape[0]))
            binnings = [attach_compact(b, cap) for b in binnings]
        if tracing():
            for b, (occ, entries, cropped) in zip(binnings, _binning_table(binnings)):
                rows = _blend_rows(b)
                count("binning.entries", entries)
                count("binning.cropped", cropped)
                count("binning.overflow", max(occ - rows, 0))
                self._binning_rows[id(b)] = (rows, occ)
        return binnings

    def _counted_render(self, render: Callable) -> Callable:
        """``render`` counting, under a profiler, each render through a
        binning counted by ``_auto_compact``: ``blend.renders``,
        ``blend.rows`` (the rows the blend launches over) and
        ``blend.tiles_occupied`` (the view's occupied tiles among them)."""

        def counted(rv, cam, binning):
            if binning is not None and tracing() and id(binning) in self._binning_rows:
                rows, occ = self._binning_rows[id(binning)]
                count("blend.renders")
                count("blend.rows", rows)
                count("blend.tiles_occupied", min(occ, rows))
            return render(rv, cam, binning)

        return counted

    @traced("dense.binnings")
    def dense_binnings(self, t: int) -> List[Binning]:
        """Each full-resolution view's frozen binning of the current dense
        state for frame ``t`` (scan mode's, ``pipeline/trainer.py:692-720``):
        under the auto capacity one compact list sized from the largest
        occupancy over the views; a manual capacity below the frame's
        occupancy prints a warning."""
        views = range(int(self.source.cameras_full.fx.shape[0]))
        binnings = self._auto_compact([self._fresh_dense_binning(v) for v in views])
        cap_cfg = self.cfg.texture.tile_capacity
        if cap_cfg > 0:
            occ = int(torch.max(torch.stack([torch.sum(b.tile_count > 0) for b in binnings])))
            if occ > cap_cfg:
                print(
                    f"[topo4d_tpu_torch] WARNING frame {t}: {occ - cap_cfg} occupied tiles beyond "
                    f"texture.tile_capacity={cap_cfg} are dropped; raise the capacity"
                )
        return binnings

    @traced("dense.frame")
    def fit_frame_texture(self, t: int, frame_data) -> Dict[str, float]:
        """Fit the dense colors and rotations of frame ``t`` on the
        full-resolution views (``source.cameras_full``). Returns the last
        metrics row (also appended to ``metrics_log``): a row every
        ``dense_log_freq`` iterations (the step's own metrics with the
        "tex_" prefix, the fixed-view PSNR of view 0, in scan mode
        optionally the mean PSNR over all views), then a terminal row after
        the last step.

        The binning cadence is ``texture.rebin_freq``'s
        (``pipeline/trainer.py:620-627``; frozen binnings are the pallas
        backend's):

        - scan mode (``schedule.use_scan`` and a rebin_freq of 0 or 1): at
          rebin_freq 0 every view's binning is frozen up front for the
          frame, with the split pack's static rows and, under the auto
          capacity, one compact tile list sized from the frame's largest
          occupancy; the steps between log rows run through the
          multi-step;
        - loop mode (rebin_freq above 1 or negative, or no ``use_scan``):
          a view is binned at its first use from the state at that moment,
          with a compact list sized from that one binning, and again after
          every rebin_freq uses (never, when negative); view 0's binning
          for the eval render is made at the first log row if no step has
          made it;
        - rebin_freq 1: no frozen binning; every render bins afresh on the
          full canvas (or a manual capacity).

        The dense means3D do not move within a frame, so every cadence
        gives the same values; they differ in the binnings they build.
        Under ``data.use_mask_dense`` a frame with masks takes the masked L1
        step; the steps are rebuilt when that state flips
        (``pipeline/trainer.py:575-595``).

        Under a profiler the frame is the span ``dense.frame``, with
        ``dense.transfer`` (the targets to the card), ``dense.binnings``,
        the steps' spans (``texture.dense.make_texture_step``) and a
        ``dense.eval`` per eval row inside; every render through a frozen
        binning is counted (``_counted_render``).
        """
        cfg = self.cfg
        dev = self.device
        self._binning_rows.clear()
        if self.texture_state is None:
            dense_np = init_dense_params(ckpt.to_numpy(self.state.params), self.statics, self.source.num_views)
            dense = {k: torch.as_tensor(v, device=dev) for k, v in dense_np.items()}
            self.texture_state = TextureState(params=dense, opt=adam_init(dense))
            self.dense_anchor = dense["dense_rgb_colors"]
        else:
            # update_dense_states (train.py:498-508)
            self.dense_anchor = self.texture_state.params["dense_rgb_colors"]
        # masked dense loss (train.py:392-405); a frame without masks takes
        # the unmasked objective (the loader has warned)
        masks = None
        if cfg.data.use_mask_dense and frame_data.masks is not None:
            with span("dense.transfer"):
                masks = frame_tensor(frame_data.masks, dev)
        use_mask = masks is not None
        if self.texture_step is None or self._texture_masked != use_mask:
            # built apart from the state, so that a resumed run, whose
            # texture_state comes from the checkpoint, gets them too
            render = self._counted_render(make_dense_render_fn(cfg, dev))
            remat = cfg.texture.remat_photometric
            self.texture_step = make_texture_step(render, use_mask, cfg.data.cmap_index, remat)
            self.texture_multi_step = make_texture_multi_step(render, use_mask, cfg.data.cmap_index, remat)
            self.texture_eval = make_texture_eval(render)
            self._texture_masked = use_mask
            self._dense_pre = build_dense_pre_constraints(
                ckpt.to_numpy(self.texture_state.params), self.statics.regions, dev
            )
            topo = self.statics.dense.topo
            self._dense_interp = tuple(
                torch.as_tensor(a, device=dev) for a in (topo.quad_faces, topo.father_face, topo.weights)
            )
        with torch.no_grad():
            self.dense_means3d = interpolate_dense_attribute(self.state.params["means3D"], *self._dense_interp)
        with span("dense.transfer"):
            images = frame_tensor(frame_data.images, dev)
        cams = self.source.cameras_full
        num_views = images.shape[0]
        sched = cfg.schedule
        num_iters = sched.dense_opt_num
        if t > 0 and sched.dense_opt_num_tracked >= 0:
            num_iters = sched.dense_opt_num_tracked
        order = [int(v) for v in view_order(num_views, num_iters, seed=10_000 + t)]
        lr = dict(cfg.lrs.dense)
        weights = cfg.dense_weights.as_dict()
        rebin = cfg.texture.rebin_freq
        use_binning = cfg.raster.backend == "pallas" and rebin != 1
        use_scan = sched.use_scan and (not use_binning or rebin == 0)
        log_freq = sched.dense_log_freq

        def step(v: int, binning, log_this: bool):
            self.texture_state, m = self.texture_step(
                self.texture_state, self.dense_means3d, images[v], cams, v, self.dense_anchor,
                self._dense_pre, lr, weights, binning, with_metrics=log_this,
                mask=None if masks is None else masks[v],
            )
            return m

        @traced("dense.eval")
        def eval_row(i: int, binning_of, allview: bool) -> Dict[str, float]:
            state, means = self.texture_state, self.dense_means3d
            row = {"tex_psnr_fixed": float(self.texture_eval(state, means, images[0], cams, 0, binning_of(0)))}
            if allview:
                row["tex_psnr_allview"] = float(torch.mean(torch.stack([
                    self.texture_eval(state, means, images[v], cams, v, binning_of(v)) for v in range(num_views)
                ])))
            row["iter"] = i
            row["frame"] = t
            return row

        def log_row(i: int, m, binning_of, allview: bool) -> None:
            row = {("tex_" + k): float(val) for k, val in m.items()}
            row.update(eval_row(i, binning_of, allview))
            self.metrics_log.append(row)

        if use_scan:
            binnings = self.dense_binnings(t) if use_binning else [None] * num_views
            i = 0
            while i < num_iters:
                if i % log_freq == 0:
                    v = order[i]
                    log_row(i, step(v, binnings[v], True), binnings.__getitem__, cfg.texture.allview_eval)
                    i += 1
                    continue
                j = min(num_iters, (i // log_freq + 1) * log_freq)
                self.texture_state, _ = self.texture_multi_step(
                    self.texture_state, self.dense_means3d, images, cams, order[i:j], self.dense_anchor,
                    self._dense_pre, lr, weights, binnings, masks,
                )
                i = j
            binning_of, allview = binnings.__getitem__, cfg.texture.allview_eval
        else:
            # loop mode (``pipeline/trainer.py:787-824``): bound lazily per view
            binnings: Dict[int, Binning] = {}
            uses: Dict[int, int] = {}

            def frozen(v: int):
                if not use_binning:
                    return None
                if v not in binnings:
                    with span("dense.binnings"):
                        binnings[v] = self._auto_compact([self._fresh_dense_binning(v)])[0]
                    uses[v] = 0
                return binnings[v]

            for i in range(num_iters):
                v = order[i]
                if use_binning and v in binnings and 0 < rebin <= uses[v]:
                    del binnings[v]
                binning = frozen(v)
                if use_binning:
                    uses[v] += 1
                log_this = i % log_freq == 0
                m = step(v, binning, log_this)
                if log_this:
                    log_row(i, m, frozen, False)  # view 0's binning, made here if no step made it
            binning_of, allview = frozen, False
        # terminal row: the final state's quality (log rows miss the last step)
        row = eval_row(num_iters, binning_of, allview)
        self.metrics_log.append(row)
        return row

    # ------------------------------------------------------------------
    def run(self, resume: bool = True) -> None:
        """Fit frames ``0 .. schedule.frame_num - 1`` of the source (its
        frames ``t + 1``) into ``<output_dir>/<exp>/<seq>``, resuming after
        the last checkpointed frame when ``resume`` and a ``resume.pkl``
        exists there.

        Frame ``t + 1``'s targets are read on a worker thread while frame
        ``t`` fits; frame ``t``'s checkpoint and export run on another
        while frame ``t + 1`` fits (``schedule.async_export``; at most one
        frame's IO in flight, its failure raised at the next frame). Writes
        ``metrics.jsonl`` and ``timings.json`` every frame and ``params.npz``
        at the end. With several processes every rank fits and rank 0
        alone writes (``pipeline/trainer.py:831``); a resume needs the
        output directory on a file system every rank reads
        (``_synced_resume``), and the ranks meet at the end, once rank 0's
        files are written. With ``TOPO4D_PROFILE_DIR`` set the frame loop
        runs under ``device_trace``, which writes a ``torch.profiler`` trace
        per process there.
        """
        cfg = self.cfg
        io = is_host0()
        if io:
            os.makedirs(self._out_dir, exist_ok=True)
        orbax = cfg.data.checkpoint_backend == "orbax"
        if cfg.data.checkpoint_backend not in ("pickle", "orbax"):
            raise ValueError(f"unknown data.checkpoint_backend {cfg.data.checkpoint_backend!r}")
        save_resume = ckpt.save_resume_orbax if orbax else ckpt.save_resume
        start_frame = 0
        if resume:
            payload = self._synced_resume(ckpt.load_resume_orbax if orbax else ckpt.load_resume)
            if payload is not None:
                start_frame = self._restore(payload, io)
        want_tex = cfg.texture.gen_tex and self.statics.dense is not None

        def load(t1):
            geo = self.source.frame(t1)
            tex = self.source.frame(t1, full_res=True) if want_tex and geo is not None else None
            return geo, tex

        pool = ThreadPoolExecutor(max_workers=1)
        io_pool = ThreadPoolExecutor(max_workers=1)
        pending = pool.submit(load, start_frame + 1)
        io_pending = None
        try:
            # TOPO4D_PROFILE_DIR: a torch.profiler trace of the frame loop
            with device_trace(device=self.device) as tracing:
                if tracing:
                    print("[topo4d_tpu_torch] torch.profiler trace enabled", flush=True)
                for t in range(start_frame, cfg.schedule.frame_num):
                    t_start = time.time()
                    frame_data, tex_data = pending.result()
                    if t + 1 < cfg.schedule.frame_num:
                        pending = pool.submit(load, t + 2)
                    if frame_data is None:
                        break
                    geo_t0 = time.perf_counter()
                    means_start = self.state.params["means3D"]
                    with self.timer.phase("geometry"):
                        geo = self.fit_frame_geometry(t, frame_data)
                    # the geometry fit's displacement of each vertex in this frame
                    with torch.no_grad():
                        disp = torch.linalg.vector_norm(self.state.params["means3D"] - means_start, dim=1)
                    geo["max_dmeans3d"] = float(torch.max(disp))
                    geo["mean_dmeans3d"] = float(torch.mean(disp))
                    cams = self.source.cameras
                    geo["mpix_per_s"] = mpix_per_s(
                        cams.height, cams.width, self._last_geo_renders, time.perf_counter() - geo_t0
                    )
                    if want_tex and tex_data is not None:
                        with self.timer.phase("texture"):
                            self.fit_frame_texture(t, tex_data)

                    self.output_params.append(ckpt.params_snapshot(self.state.params, t == 0))
                    # snapshots on the card: the next frame's steps cannot reach them
                    job = self._make_io_job(
                        t, io, save_resume, state=ckpt.clone(self.state), priors=ckpt.clone(self.priors),
                        first_frame_attrs=self.first_frame_attrs, output_params=list(self.output_params),
                        texture_state=ckpt.clone(self.texture_state),
                    )
                    if io_pending is not None:
                        io_pending.result()  # the previous frame's IO lands before the next is queued
                        io_pending = None
                    if cfg.schedule.async_export:
                        io_pending = io_pool.submit(job)
                    else:
                        job()
                    geo["frame_seconds"] = round(time.time() - t_start, 4)
                    self.metrics_log.append({
                        "frame": t, "summary": True, "frame_seconds": geo["frame_seconds"],
                        "mpix_per_s": geo["mpix_per_s"], "max_dmeans3d": geo["max_dmeans3d"],
                        "mean_dmeans3d": geo["mean_dmeans3d"],
                    })
                    if io:
                        self._write_metrics()
                        self.timer.write(os.path.join(self._out_dir, "timings.json"))
                        psnr_s = f" psnr {geo['psnr']:.2f}" if "psnr" in geo else ""
                        print(
                            f"[topo4d_tpu_torch] frame {t + 1}/{cfg.schedule.frame_num} loss "
                            f"{geo.get('loss_total', float('nan')):.5f}{psnr_s} ({geo['frame_seconds']:.1f}s, "
                            f"{geo['mpix_per_s']:.2f} Mpix/s, max|dv| {geo['max_dmeans3d']:.2e})",
                            flush=True,
                        )
            if io_pending is not None:
                io_pending.result()
                io_pending = None
        finally:
            # a queued read is dropped and a running one finishes; queued IO
            # finishes, so the checkpoints stay whole on an error exit too
            pool.shutdown(wait=True, cancel_futures=True)
            io_pool.shutdown(wait=True)

        if io:
            # the final params.npz whatever ckp_freq is
            if self.output_params:
                ckpt.save_params(self.output_params, self._out_dir)
            # the last frame's IO may end after the loop's write
            self.timer.write(os.path.join(self._out_dir, "timings.json"))
        if process_count() > 1:
            torch.distributed.barrier()  # rank 0's files are whole before any rank goes on

    def _synced_resume(self, load_resume):
        """The resume payload, read by every rank (``pipeline/trainer.py:1083-1107``).

        Rank 0 alone writes the checkpoint, so a multi-process resume needs
        the output directory on a file system that every rank reads. The
        ranks' frame indices meet in one ``all_reduce``; if any differs from
        rank 0's, every rank raises, instead of running divergent frames."""
        payload = load_resume(self._out_dir)
        world = process_count()
        if world > 1:
            local = -1 if payload is None else int(payload["frame"])
            frames = torch.zeros(world, dtype=torch.int64, device=self.device)
            frames[process_index()] = local
            torch.distributed.all_reduce(frames)
            frames = frames.tolist()
            if any(f != frames[0] for f in frames):
                raise RuntimeError(
                    f"resume checkpoint mismatch: host 0 is at frame {frames[0]} but the processes read {frames} "
                    f"(-1: none; this is process {process_index()}); multi-host resume requires output_dir on "
                    "a shared filesystem"
                )
        return payload

    def _restore(self, payload, io: bool = True) -> int:
        """Restore the state a resume payload holds; on host 0 (``io``)
        reload the earlier frames' metric rows and timings -> the frame to
        start from."""
        start_frame = payload["frame"]
        dev = self.device
        self.state = ckpt.to_torch(payload["state"], dev)
        self.priors = ckpt.to_torch(payload["priors"], dev)
        self.first_frame_attrs = payload["first_frame_attrs"]
        self.output_params = payload["output_params"]
        if payload["texture_state"] is not None:
            self.texture_state = ckpt.to_torch(payload["texture_state"], dev)
        if not io:
            return start_frame
        # metrics.jsonl and timings.json are rewritten whole every frame
        self.timer.load(os.path.join(self._out_dir, "timings.json"))
        mpath = os.path.join(self._out_dir, "metrics.jsonl")
        if not self.metrics_log and os.path.exists(mpath):
            with open(mpath) as fh:
                for line in fh:
                    try:
                        row = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # a torn last line from a hard kill
                    if row.get("frame", 1 << 30) < start_frame:
                        self.metrics_log.append(row)
        return start_frame

    def _make_io_job(self, t, io, save_resume, *, state, priors, first_frame_attrs, output_params, texture_state):
        """Frame ``t``'s checkpoint (through ``save_resume``) and export as a
        closure over snapshots, so that it can run on the IO worker while
        this thread fits frame ``t + 1``; off host 0 (``io`` false) it
        writes nothing."""
        cfg = self.cfg

        def job():
            if not io:
                return
            with self.timer.phase("checkpoint"):
                if t % cfg.schedule.ckp_freq == 0 and t != 0:
                    ckpt.save_params(output_params, self._out_dir)
                    ckpt.write_loss_json(
                        self._out_dir, {k: True for k in self.statics.quadruples}, cfg.weights.as_dict()
                    )
                save_resume(self._out_dir, t + 1, state, priors, first_frame_attrs, output_params, texture_state)
            with self.timer.phase("export"):
                tex = cfg.texture
                if (self._bake_binning is None and tex.gen_tex and texture_state is not None
                        and tex.bake_backend != "xla"):
                    # a sequence constant: the UV layout does not change
                    self._bake_binning = build_bake_binning(self.statics, tex.tex_res, self.device)
                save_mesh(
                    os.path.join(self._out_dir, "%06d" % (t + 1)), state.params, self.statics, t + 1,
                    dense_params=texture_state.params if texture_state is not None else None,
                    tex_res=tex.tex_res, gen_texture=tex.gen_tex, bake_binning=self._bake_binning,
                    bake_backend=tex.bake_backend, bake_window=tex.bake_window, bake_bands=tex.bake_bands,
                )

        return job

    def _write_metrics(self) -> None:
        with open(os.path.join(self._out_dir, "metrics.jsonl"), "w") as fh:
            for row in self.metrics_log:
                fh.write(json.dumps(row) + "\n")
