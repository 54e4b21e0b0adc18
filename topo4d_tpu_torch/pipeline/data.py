"""Sequence sources: a synthetic sequence and the per-frame view schedule
(pipeline/data.py :163, :223)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from topo4d_tpu_torch.core.camera import Camera
from topo4d_tpu_torch.core.gaussian import activate_params
from topo4d_tpu_torch.rasterizer.render import render_gaussians


class FrameData(NamedTuple):
    images: np.ndarray  # (V, 3, H, W) float32 in [0, 1]
    masks: Optional[np.ndarray]  # (V, 3, H, W) or None
    view_names: List[str]


@dataclasses.dataclass
class SyntheticSequence:
    """A known Gaussian scene whose vertices wobble over time; the targets
    are rendered with this package's renderer on the cameras' device.

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
            imgs = [
                render_gaussians(rv, cams[i], max_span=4).image.cpu().numpy()
                for i in range(self.num_views)
            ]
            self._frames[(t, full_res)] = FrameData(images=np.stack(imgs), masks=None, view_names=self.view_names)
        return self._frames[(t, full_res)]


def view_order(num_views: int, num_iters: int, seed: int) -> np.ndarray:
    """Random view schedule without replacement per epoch (train.py:105-112)."""
    rng = np.random.default_rng(seed)
    epochs = -(-num_iters // num_views)
    order = np.concatenate([rng.permutation(num_views) for _ in range(epochs)])
    return order[:num_iters].astype(np.int32)
