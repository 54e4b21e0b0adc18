"""Facial region masks and per-region loss-weight tables (topology/regions.py)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping

import numpy as np

# The 26 named regions (reference train.py:37-43).
FACE_REGION_NAMES: List[str] = [
    "Caruncle", "Chin", "Ear", "EarNeckBack", "EarSocket", "EyeLidBottom",
    "EyeLidInnerBottom", "EyeLidInnerTop", "EyeLidOuterTop",
    "EyeLidOuterBottom", "EyeLidTop", "EyeSocket", "Face", "HeadBack",
    "LipBottom", "LipInnerBottom", "LipInnerTop", "LipOuterBottom",
    "LipOuterTop", "LipTop", "MouthSocket", "MouthSocketBottom",
    "MouthSocketTop", "NeckBack", "NeckFront", "Nostril",
]


@dataclasses.dataclass
class FacialRegions:
    """The facial_regions schema: named regions, derived masks, flat faces."""

    region_masks: Dict[str, np.ndarray]  # name -> vertex indices
    masks: Dict[str, np.ndarray]  # derived mask name -> vertex indices
    flat_faces: Dict[str, np.ndarray]  # flatten subset name -> (F, 3) tris

    def mask(self, key: str) -> np.ndarray:
        if key in self.masks:
            return self.masks[key]
        return self.region_masks[key]


# Raw per-region multipliers of train.py:546-585 (applied as mult / weight).
ISO_REGION_MULTIPLIERS: Dict[str, float] = {
    "eye_lid_up_masks": 0.0,
    "EyeLidOuterTop": 0.0,
    "EyeLidTop": 0.0,
    "mouth_inner_masks": 5.0,
    "Chin": 0.0,
    "LipOuterTop": 0.0,
    "LipOuterBottom": 1.0,
    "EyeSocket": 0.0,
    "MouthSocket": 0.0,
    "NeckFront": 0.0,
    "face_flat_masks": 0.0,
}

RIGID_REGION_MULTIPLIERS: Dict[str, float] = {
    "eye_lid_up_masks": 0.0,
    "EyeLidOuterTop": 0.0,
    "EyeLidTop": 0.0,
    "mouth_inner_masks": 0.5,
    "Chin": 0.0,
    "LipOuterTop": 0.0,
    "LipOuterBottom": 0.1,
    "MouthSocket": 0.0,
    "EyeSocket": 0.0,
    "NeckFront": 0.0,
    "face_flat_masks": 0.0,
}

ROT_REGION_MULTIPLIERS: Dict[str, float] = {
    "EyeLidOuterTop": 50.0,
    "EyeLidTop": 50.0,
    "EyeLidBottom": 100.0,
    "EyeSocket": 100.0,
    "eye_inner_masks": 100.0,
}


def build_region_weight_matrix(
    base_weight: np.ndarray,
    regions: FacialRegions,
    multipliers: Mapping[str, float],
    global_weight: float,
) -> np.ndarray:
    """``w[mask] *= mult / global_weight``, applied in order (overlaps compound)."""
    w = base_weight.copy()
    if global_weight == 0:
        return w
    for key, mult in multipliers.items():
        w[regions.mask(key), :] *= mult / global_weight
    return w
