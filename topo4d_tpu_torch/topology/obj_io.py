"""The startup mesh record, its UV bookkeeping and the OBJ export
(topology/obj_io.py ``MeshObj``, ``vertex_uv_multiplicity``,
``write_obj_with_uv``)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class MeshObj:
    vertices: np.ndarray  # (V, 3) float32
    uvs: np.ndarray  # (T, 2) float32 texture coordinates
    faces: List[List[int]]  # vertex indices, 0-based, len 3 or 4
    uv_faces: List[List[int]]  # uv indices, aligned with faces
    normals: Optional[np.ndarray] = None


def vertex_uv_multiplicity(
    num_vertices: int,
    faces: Sequence[Sequence[int]],
    uv_faces: Sequence[Sequence[int]],
    uvs: np.ndarray,
) -> List[List[tuple]]:
    """Distinct UV coordinates per vertex (reference ``get_vertex_uvs``).

    Seam vertices map to more than one UV coordinate; the UV densifier shares
    subdivision points only across edges with a single-UV endpoint
    (helpers.py:436-467).
    """
    per_vertex: List[set] = [set() for _ in range(num_vertices)]
    for face, uv_face in zip(faces, uv_faces):
        for v, t in zip(face, uv_face):
            per_vertex[v].add(tuple(np.round(uvs[t], 8)))
    return [sorted(s) for s in per_vertex]


def write_obj_with_uv(
    path: str,
    vertices: np.ndarray,
    faces: Sequence[Sequence[int]],
    uvs: np.ndarray,
    uv_faces: Sequence[Sequence[int]],
) -> None:
    """Write an OBJ with v / vt / f v/vt records (reference helpers.py:258-273),
    faces in their original arity."""
    with open(path, "w") as fh:
        for v in vertices:
            fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for uv in uvs:
            fh.write(f"vt {uv[0]} {uv[1]}\n")
        for face, uv_face in zip(faces, uv_faces):
            fh.write("f" + "".join(f" {int(v) + 1}/{int(t) + 1}" for v, t in zip(face, uv_face)) + "\n")
