"""The startup mesh record (topology/obj_io.py ``MeshObj``)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class MeshObj:
    vertices: np.ndarray  # (V, 3) float32
    uvs: np.ndarray  # (T, 2) float32 texture coordinates
    faces: List[List[int]]  # vertex indices, 0-based, len 3 or 4
    uv_faces: List[List[int]]  # uv indices, aligned with faces
    normals: Optional[np.ndarray] = None
