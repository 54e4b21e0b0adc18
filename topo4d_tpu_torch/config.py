"""The subset of ``topo4d_tpu.config`` that the geometry tracking path (parity
and batched all-views modes), the dense texture phase and the per-frame
export read.

Same field names and defaults as the reference's dataclasses; learning rates
and loss weights stay host floats (they are passed to the step as Python
scalars, so a phase change moves no data to the card).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from topo4d_tpu_torch.topology.regions import (
    ISO_REGION_MULTIPLIERS,
    RIGID_REGION_MULTIPLIERS,
    ROT_REGION_MULTIPLIERS,
)


@dataclasses.dataclass
class LossWeights:
    """Global loss weights (reference train.py:535-543)."""

    im: float = 1.0
    rigid: float = 3.5
    rot: float = 20.0
    iso: float = 20.0
    flat: float = 2e-4
    flat_lip_bottom: float = 2e-4
    flat_lid_top: float = 2e-4
    flat_lid_bottom: float = 1e-2
    flat_lip: float = 1e-4
    flat_mouth: float = 1e-3
    flat_eye: float = 1e4
    flat_face_bottom: float = 1e3
    flat_lip_socket: float = 1e3
    scale: float = 10.0
    scale_max: float = 10.0

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class DenseLossWeights:
    """Texture-phase weights (reference train.py:541-543)."""

    im: float = 1.0
    soft_color: float = 0.02

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class LearningRates:
    """Per-parameter Adam LRs: init (frame 0), track (frames > 0), polish
    (the last ``polish_iters`` iterations of a tracked frame), dense (the
    texture phase: only colors and rotations learn)."""

    init: Dict[str, float] = dataclasses.field(default_factory=lambda: {
        "means3D": 0.0, "rgb_colors": 2.5e-3, "unnorm_rotations": 1e-3,
        "logit_opacities": 0.0, "log_scales": 1e-3,
        "cam_m": 1e-4, "cam_c": 1e-4,
    })
    track: Dict[str, float] = dataclasses.field(default_factory=lambda: {
        "means3D": 1.6e-5, "rgb_colors": 0.0, "unnorm_rotations": 1e-3,
        "logit_opacities": 0.0, "log_scales": 0.0,
        "cam_m": 0.0, "cam_c": 0.0,
    })
    polish: Dict[str, float] = dataclasses.field(default_factory=lambda: {
        "means3D": 0.0, "rgb_colors": 2.5e-4, "unnorm_rotations": 1e-3,
        "logit_opacities": 0.0, "log_scales": 0.0,
        "cam_m": 0.0, "cam_c": 0.0,
    })
    dense: Dict[str, float] = dataclasses.field(default_factory=lambda: {
        "dense_rgb_colors": 2.5e-3, "dense_unnorm_rotations": 1e-3,
        "dense_logit_opacities": 0.0, "dense_log_scales": 0.0,
    })


@dataclasses.dataclass
class RasterizerConfig:
    max_span: int = 4  # tiles per axis per Gaussian before cropping
    bg: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    # geometry-phase frozen binning: a segment of identically configured
    # steps computes each view's binning once at its entry and every step
    # packs along those permutations; the value caps the segment length.
    # 0 = off (a fresh binning every render, the reference's semantics),
    # -1 = auto (0 in parity mode, 25 in the batched all-views mode); an
    # explicit value >= 0 wins. Resolve with ``effective_track_rebin_freq``.
    track_rebin_freq: int = -1


def effective_track_rebin_freq(cfg: "Config") -> int:
    """Resolve ``raster.track_rebin_freq`` (-1 = auto, mode-dependent): 0 in
    parity mode (``schedule.views_per_step == 1``, the reference's fresh
    sort every render), 25 in the batched all-views mode. Explicit values
    (>= 0) win."""
    f = cfg.raster.track_rebin_freq
    if f >= 0:
        return f
    return 0 if cfg.schedule.views_per_step == 1 else 25


@dataclasses.dataclass
class ScheduleConfig:
    """Iteration schedule (reference train.py:767-780)."""

    frame_num: int = 800
    init_opt_num: int = 7000
    opt_num: int = 1100
    dense_opt_num: int = 301
    dense_opt_num_tracked: int = -1  # texture iterations of frames > 0; -1 = dense_opt_num
    polish_iters: int = 100
    eye_freeze_frac: float = 0.7
    log_freq: int = 500
    dense_log_freq: int = 300
    ckp_freq: int = 5  # params.npz every ckp_freq frames (resume.pkl every frame)
    views_per_step: int = 1  # 1 = reference parity; 0 = all views batched per step
    # batched mode (views_per_step == 0) steps per frame; 0 = auto
    # (ceil(num_iters / num_views): every step consumes all views)
    batched_opt_num: int = 0
    # run each segment of identically configured steps through the
    # multi-step (the JAX package scans it into one program; here it is a
    # Python loop with the same semantics, and the unit that frozen
    # binnings live for)
    use_scan: bool = True
    # render all views of a batched step in one fused launch: not ported
    fuse_views: bool = False
    # run a frame's checkpoint and export on a worker thread while the next
    # frame fits; at most one frame's IO in flight
    async_export: bool = True


@dataclasses.dataclass
class DataConfig:
    output_dir: str = "output"
    exp: str = "exp_op1"  # reference argparse default (train.py:762)
    seq: str = "seq_01"
    # dim the inner mouth of tracked frames' targets with the parsing masks;
    # a source that has masks raises until the mask module is ported
    use_mask: bool = True


@dataclasses.dataclass
class TextureConfig:
    """The dense texture phase (reference train.py:209-267, 715-743)."""

    gen_tex: bool = False  # build the dense UV-densified Gaussians
    tex_res: int = 8192  # the baked UV texture's side
    density: int = 30  # interior subdivision points per quad edge
    # frozen per-view binning: 0 = once per (frame, view), the only
    # cadence ported (dense means3D are fixed within a frame)
    rebin_freq: int = 0
    # non-empty tiles a dense render blends: -1 = auto (the frame's
    # occupancy x 1.2, rounded up, never shrinking), 0 = off (full canvas),
    # > 0 = manual (tiles past it dropped and counted in num_overflow)
    tile_capacity: int = -1
    # gather only the learned packed rows per step; the frame-constant rows
    # are captured with the frozen binning
    split_pack: bool = True
    allview_eval: bool = False  # log the mean PSNR over all views per log row


@dataclasses.dataclass
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    schedule: ScheduleConfig = dataclasses.field(default_factory=ScheduleConfig)
    raster: RasterizerConfig = dataclasses.field(default_factory=RasterizerConfig)
    weights: LossWeights = dataclasses.field(default_factory=LossWeights)
    dense_weights: DenseLossWeights = dataclasses.field(default_factory=DenseLossWeights)
    lrs: LearningRates = dataclasses.field(default_factory=LearningRates)
    texture: TextureConfig = dataclasses.field(default_factory=TextureConfig)
    iso_region_multipliers: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(ISO_REGION_MULTIPLIERS)
    )
    rigid_region_multipliers: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(RIGID_REGION_MULTIPLIERS)
    )
    rot_region_multipliers: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(ROT_REGION_MULTIPLIERS)
    )


def check_schedule(cfg: Config) -> None:
    """Raise on schedule settings the port does not run: ``views_per_step``
    other than 1 or 0 (the JAX package has only these two) and
    ``fuse_views``."""
    if cfg.schedule.views_per_step not in (0, 1):
        raise ValueError(
            f"schedule.views_per_step must be 1 (parity) or 0 (all views batched), got {cfg.schedule.views_per_step}"
        )
    if cfg.schedule.fuse_views:
        raise NotImplementedError("schedule.fuse_views (one fused multi-view launch) is not ported")
