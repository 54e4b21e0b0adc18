"""Facial region masks and per-region loss-weight tables (topology/regions.py):
the ``facial_regions.pkl`` schema (26 named regions, the derived masks, the
flatten-face subsets) and its loader."""

from __future__ import annotations

import dataclasses
import pickle
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


# Derived masks present in the pkl (SURVEY §2.2).
DERIVED_MASK_KEYS: List[str] = [
    "face_flat_masks", "lip_socket_flat_masks", "eye_lid_up_masks",
    "lip_flat_edge_masks", "face_masks", "face_bottom_masks",
    "dynamic_masks", "dynamic_eye_masks", "dynamic_mouth_masks",
    "eye_around_masks", "eye_inner_masks", "eye_del_masks",
    "mouth_around_masks", "mouth_inner_masks", "static_masks",
]

# Precomputed flatten-loss face subsets in the pkl.
FLAT_FACE_KEYS: List[str] = [
    "flat_faces", "lip_bottom_flat_faces", "lip_flat_faces",
    "mouth_flat_faces", "lid_top_flat_faces", "lid_bottom_flat_faces",
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

    @classmethod
    def from_pickle(cls, path: str) -> "FacialRegions":
        """The regions of a ``facial_regions.pkl`` (a file this pipeline's
        assets provide: unpickling runs code, so never load one of unknown
        origin)."""
        with open(path, "rb") as fh:
            raw = pickle.load(fh)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: Mapping) -> "FacialRegions":
        region_masks = {k: np.asarray(v, np.int32) for k, v in raw["region_masks"].items()}
        masks = {k: np.asarray(raw[k], np.int32) for k in DERIVED_MASK_KEYS if k in raw}
        flat_faces = {k: np.asarray(raw[k], np.int32) for k in FLAT_FACE_KEYS if k in raw}
        return cls(region_masks=region_masks, masks=masks, flat_faces=flat_faces)

    def to_dict(self) -> Dict[str, object]:
        """The pkl's schema: ``region_masks`` and the derived masks and
        flat-face subsets as top-level keys (``from_dict``'s inverse)."""
        return {"region_masks": dict(self.region_masks), **self.masks, **self.flat_faces}


def load_facial_regions(path: str) -> FacialRegions:
    return FacialRegions.from_pickle(path)


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


def region_lookup(regions: FacialRegions, num_vertices: int) -> Dict[str, np.ndarray]:
    """A boolean (num_vertices,) membership vector for each region and mask."""
    out = {}
    for name, idx in {**regions.region_masks, **regions.masks}.items():
        b = np.zeros(num_vertices, bool)
        b[idx] = True
        out[name] = b
    return out
