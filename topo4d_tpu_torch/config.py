"""The subset of ``topo4d_tpu.config`` that the geometry tracking path reads.

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
class LearningRates:
    """Per-parameter Adam LRs: init (frame 0), track (frames > 0), polish
    (the last ``polish_iters`` iterations of a tracked frame)."""

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


@dataclasses.dataclass
class RasterizerConfig:
    max_span: int = 4  # tiles per axis per Gaussian before cropping
    bg: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclasses.dataclass
class ScheduleConfig:
    """Iteration schedule (reference train.py:767-780)."""

    init_opt_num: int = 7000
    opt_num: int = 1100
    polish_iters: int = 100
    eye_freeze_frac: float = 0.7
    log_freq: int = 500
    views_per_step: int = 1  # 1 = reference parity (the only mode ported)


@dataclasses.dataclass
class Config:
    schedule: ScheduleConfig = dataclasses.field(default_factory=ScheduleConfig)
    raster: RasterizerConfig = dataclasses.field(default_factory=RasterizerConfig)
    weights: LossWeights = dataclasses.field(default_factory=LossWeights)
    lrs: LearningRates = dataclasses.field(default_factory=LearningRates)
    iso_region_multipliers: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(ISO_REGION_MULTIPLIERS)
    )
    rigid_region_multipliers: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(RIGID_REGION_MULTIPLIERS)
    )
    rot_region_multipliers: Dict[str, float] = dataclasses.field(
        default_factory=lambda: dict(ROT_REGION_MULTIPLIERS)
    )
