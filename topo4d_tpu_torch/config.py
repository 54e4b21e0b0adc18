"""The run configuration (``topo4d_tpu/config.py``): every field the port
reads, with the JAX package's names and defaults, and the JSON file the CLI
saves beside its outputs.

Learning rates and loss weights stay host floats (they are passed to the
step as Python scalars, so a phase change moves no data to the card).
``Config.from_json`` also loads the ``config.json`` that the JAX CLI writes:
a key the port has no field for is accepted only at the JAX default
(``JAX_ONLY_DEFAULTS``), where it changes nothing.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Tuple

from topo4d_tpu_torch.topology.regions import (
    ISO_REGION_MULTIPLIERS,
    RIGID_REGION_MULTIPLIERS,
    ROT_REGION_MULTIPLIERS,
)

# Per-camera +/-90-degree rotation of the input views (reference
# train.py:28-35): -1 clockwise, +1 anticlockwise.
DEFAULT_ROTATE_MASK: Dict[str, int] = {
    "J87351627": -1, "K19210959": -1, "K98707288": 1, "K98707289": 1,
    "K98707290": -1, "K98707291": 1, "K98707292": -1, "K98707293": -1,
    "K98707294": -1, "K98707295": -1, "K98707296": 1, "K98707297": -1,
    "K99216880": -1, "K99216881": -1, "K99216882": 1, "K99216883": 1,
    "K99216885": 1, "K99216886": -1, "K99216887": 1, "K99216888": 1,
    "K99216890": -1, "K99216891": -1, "K99216892": 1, "K99216893": 1,
}

# Face-parsing label colormap indices (reference train.py:50-55).
DEFAULT_CMAP_INDEX: Dict[str, int] = {
    "background": 0, "skin": 1, "l_eyebrow": 2, "r_eyebrow": 3,
    "l_eye": 4, "r_eye": 5, "nose": 6, "upper_lip": 7,
    "inner_mouth": 8, "lower_lip": 9, "hair": 10, "l_ear": 11,
    "r_ear": 12, "glasses": 13,
}


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
    # "pallas": the hand-written blend kernels on CUDA tensors (their plain
    # versions on CPU tensors); "tiled" and "oracle": the plain PyTorch
    # renderers of rasterizer/tiled.py and rasterizer/reference.py, on the
    # tensors' device. The JAX package's names, so its command lines run.
    backend: str = "pallas"
    max_span: int = 4  # tiles per axis per Gaussian before cropping
    capacity: int = 1024  # the tiled backend's entries per tile (more are dropped and counted)
    near: float = 0.01
    far: float = 100.0
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
    # batched mode, pallas backend: render all views of a step in one K1 and
    # one K2 launch on a tall canvas (no batched multi-step then)
    fuse_views: bool = False
    # run a frame's checkpoint and export on a worker thread while the next
    # frame fits; at most one frame's IO in flight
    async_export: bool = True


@dataclasses.dataclass
class DataConfig:
    input_dir: str = ""
    dense_input_dir: str = ""
    output_dir: str = "output"
    exp: str = "exp_op1"  # reference argparse default (train.py:762)
    seq: str = "seq_01"
    down_ratio: int = 8
    dense_down_ratio: int = 1
    # dim the inner mouth of tracked frames' targets with the parsing masks
    use_mask: bool = True
    # the dense phase's loss: L1 over the parsing mask's facial regions
    use_mask_dense: bool = False
    startup_mesh: str = "face_v5.obj"
    regions_pkl: str = "assets/facial_regions.pkl"
    # the resume checkpoint: "pickle" (resume.pkl and its snapshot stream)
    # or "orbax" (a torch.distributed.checkpoint directory, resume_orbax/)
    checkpoint_backend: str = "pickle"
    rotate_mask: Dict[str, int] = dataclasses.field(default_factory=lambda: dict(DEFAULT_ROTATE_MASK))
    blacklist: List[str] = dataclasses.field(default_factory=list)
    cmap_index: Dict[str, int] = dataclasses.field(default_factory=lambda: dict(DEFAULT_CMAP_INDEX))
    # views rendered to <out>/%06d/vis<name>_<iter>.png at each geometry log row
    log_views: List[str] = dataclasses.field(default_factory=lambda: ["K98707293"])
    # the per-view camera corrections of a scene built without a view count
    # (``build_scene(num_views=None)``)
    max_cams: int = 24


@dataclasses.dataclass
class TextureConfig:
    """The dense texture phase (reference train.py:209-267, 715-743)."""

    gen_tex: bool = False  # build the dense UV-densified Gaussians
    tex_res: int = 8192  # the baked UV texture's side
    density: int = 30  # interior subdivision points per quad edge
    # the export's bake: "auto" and "pallas" bake through K6 (its plain
    # version for colors on the CPU) over a per-sequence binning; "xla" runs
    # the banded three-pass scatter bake (texture/bake.py) on the fit's
    # device, each triangle in a bake_window^2 pixel window (a larger
    # triangle raises), the canvas in bake_bands row bands
    bake_window: int = 16
    bake_bands: int = 8
    bake_backend: str = "auto"
    # the dense loop's binning cadence (pallas backend): 0 = one frozen
    # binning per (frame, view), bound up front (scan mode; the dense means3D
    # are fixed within a frame); k > 1 = re-bin a view after k uses, bound
    # lazily at its first use (loop mode; negative: never re-bin); 1 = a
    # fresh duplicate-and-sort in every render (the reference's cadence)
    rebin_freq: int = 0
    # shard each dense render's tile axis over the ranks of a multi-process
    # run (the dense phase renders one view per step, where the view mesh
    # cannot help); a single process ignores it
    tile_shard: bool = False
    # non-empty tiles a dense render blends: -1 = auto (the frame's
    # occupancy x 1.2, rounded up, never shrinking), 0 = off (full canvas),
    # > 0 = manual (tiles past it dropped and counted in num_overflow)
    tile_capacity: int = -1
    # gather only the learned packed rows per step; the frame-constant rows
    # are captured with the frozen binning
    split_pack: bool = True
    # recompute the dense photometric loss in the backward instead of
    # holding its SSIM intermediates (less memory, one more K5 launch per
    # step; the same values)
    remat_photometric: bool = False
    allview_eval: bool = False  # log the mean PSNR over all views per log row

    def __post_init__(self):
        check_bake_backend(self.bake_backend)


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

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        """A config from the JSON of ``to_json`` or of the JAX package's
        ``Config.to_json``. Missing keys keep their defaults. A key the port
        has no field for raises ``ValueError`` naming it, unless it holds the
        JAX default of ``JAX_ONLY_DEFAULTS``."""
        raw = dict(json.loads(text))
        sections = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, value in raw.items():
            if key not in sections:
                _accept_jax_only(key, value)
                continue
            ftype = _SECTIONS.get(key)
            if ftype is None:  # the per-region multiplier tables
                kwargs[key] = dict(value)
                continue
            known = {f.name for f in dataclasses.fields(ftype)}
            fields = {}
            for k, v in value.items():
                if k in known:
                    fields[k] = v
                else:
                    _accept_jax_only(f"{key}.{k}", v)
            if ftype is RasterizerConfig and "bg" in fields:
                fields["bg"] = tuple(fields["bg"])
            kwargs[key] = ftype(**fields)
        return cls(**kwargs)


_SECTIONS = {
    "data": DataConfig, "schedule": ScheduleConfig, "raster": RasterizerConfig, "weights": LossWeights,
    "dense_weights": DenseLossWeights, "lrs": LearningRates, "texture": TextureConfig,
}

# any value of a JAX-only key that changes no result
ANY = object()

# Keys of the JAX package's config that the port has no field for, each at
# the value for which the port's behaviour is the JAX package's: the Pallas
# interpreter off, any entry window of the Pallas blend (it changes no
# result), the one-ring weight sharpness the port computes with. The first
# two are TPU devices, not ported by design.
JAX_ONLY_DEFAULTS = {
    "raster.interpret": False,
    "raster.chunk": ANY,
    "neighbor_weight_k": 2000.0,
}


def _accept_jax_only(key: str, value) -> None:
    if key not in JAX_ONLY_DEFAULTS:
        raise ValueError(f"config key {key!r} is not a field of topo4d_tpu_torch's Config")
    if JAX_ONLY_DEFAULTS[key] is not ANY and value != JAX_ONLY_DEFAULTS[key]:
        raise ValueError(
            f"config key {key!r} = {value!r}: topo4d_tpu_torch runs only with {JAX_ONLY_DEFAULTS[key]!r}"
        )


BAKE_BACKENDS = ("auto", "pallas", "xla")


def check_bake_backend(backend: str) -> None:
    """Raise on a ``texture.bake_backend`` the port does not know (the JAX
    package bakes any value but "auto" and "pallas" as "xla")."""
    if backend not in BAKE_BACKENDS:
        raise ValueError(f"texture.bake_backend must be one of {', '.join(BAKE_BACKENDS)}, got {backend!r}")


def check_schedule(cfg: Config) -> None:
    """Raise on schedule settings the port does not run: ``views_per_step``
    other than 1 or 0 (the JAX package has only these two)."""
    if cfg.schedule.views_per_step not in (0, 1):
        raise ValueError(
            f"schedule.views_per_step must be 1 (parity) or 0 (all views batched), got {cfg.schedule.views_per_step}"
        )
