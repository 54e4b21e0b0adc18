"""Wavefront OBJ I/O with quad faces and UVs, host NumPy
(``topology/obj_io.py``): the startup mesh loader (faces keep their arity),
its UV bookkeeping, vertex colors sampled from the startup texture, and the
OBJ export."""

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

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]


def load_obj(path: str) -> MeshObj:
    """Parse v/vt/f records; keeps quads as quads (reference parity)."""
    vertices: List[List[float]] = []
    uvs: List[List[float]] = []
    normals: List[List[float]] = []
    faces: List[List[int]] = []
    uv_faces: List[List[int]] = []
    with open(path, "r") as fh:
        for line in fh:
            if line.startswith("v "):
                vertices.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                uvs.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("vn "):
                normals.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                parts = [p for p in line.strip().split(" ")[1:] if p]
                faces.append([int(p.split("/")[0]) - 1 for p in parts])
                # keep uv_faces corner-aligned with faces: a corner
                # without a vt index ("v" or "v//vn") falls back to its
                # vertex index so downstream zips never misalign; a face
                # with NO vt at all contributes the vertex indices
                # (valid when the mesh shares vertex/uv numbering)
                corner_uvs = []
                for p in parts:
                    bits = p.split("/")
                    if len(bits) > 1 and bits[1]:
                        corner_uvs.append(int(bits[1]) - 1)
                    else:
                        corner_uvs.append(int(bits[0]) - 1)
                uv_faces.append(corner_uvs)
    return MeshObj(
        vertices=np.asarray(vertices, np.float32),
        uvs=np.asarray(uvs, np.float32) if uvs else np.zeros((0, 2), np.float32),
        faces=faces,
        uv_faces=uv_faces,
        normals=np.asarray(normals, np.float32) if normals else None,
    )


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


def write_obj_del_vertex(
    path: str,
    vertices: np.ndarray,
    faces: Sequence[Sequence[int]],
    uvs: np.ndarray,
    uv_faces: Sequence[Sequence[int]],
    del_list: Sequence[int],
    neighbor_indices: Optional[np.ndarray] = None,
) -> None:
    """The OBJ export with a vertex subset removed (reference helpers.py:275-298).

    With ``neighbor_indices`` a vertex is deleted only if all of its one-ring
    neighbors are listed too (no dangling faces). Faces touching a deleted
    vertex are dropped and the remaining vertices renumbered; the UVs are
    written unchanged (the reference keeps the whole vt list).
    """
    del_set = set(int(v) for v in del_list)
    if neighbor_indices is not None:
        del_set = {v for v in del_set if all(int(n) in del_set for n in neighbor_indices[v])}
    keep = [i for i in range(vertices.shape[0]) if i not in del_set]
    remap = {old: new for new, old in enumerate(keep)}
    new_faces, new_uv_faces = [], []
    for face, uv_face in zip(faces, uv_faces):
        if any(v in del_set for v in face):
            continue
        new_faces.append([remap[v] for v in face])
        new_uv_faces.append(list(uv_face))
    write_obj_with_uv(path, vertices[keep], new_faces, uvs, new_uv_faces)


def sample_vertex_colors(
    texture: np.ndarray,  # (H, W, 3) float or uint8
    num_vertices: int,
    faces: Sequence[Sequence[int]],
    uv_faces: Sequence[Sequence[int]],
    uvs: np.ndarray,
) -> np.ndarray:
    """Average bilinear texture samples over each vertex's face-corner UVs.

    Vectorized equivalent of the reference's ``compute_vertex_colors``
    (helpers.py:181-208 + 300-333): u wraps mod 1, v flipped, bilinear with
    edge clamping; a vertex appearing in several faces averages its samples.
    Returns (V, 3) in the texture's value range.
    """
    tex = np.asarray(texture, np.float64)
    h, w = tex.shape[:2]
    v_idx: List[int] = []
    uv_list: List[np.ndarray] = []
    for face, uv_face in zip(faces, uv_faces):
        for v, t in zip(face, uv_face):
            v_idx.append(v)
            uv_list.append(uvs[t])
    v_idx_arr = np.asarray(v_idx)
    uv_arr = np.asarray(uv_list, np.float64)

    u = np.mod(uv_arr[:, 0], 1.0)
    vv = np.mod(uv_arr[:, 1], 1.0)
    # clamp into the valid sample grid (the reference assumes interior UVs
    # and would fault on exact 0/1 coords; clamping matches it elsewhere)
    x = np.clip(u * w, 0.0, w - 1)
    y = np.clip((1.0 - vv) * h, 0.0, h - 1)
    x1 = x.astype(np.int64)
    y1 = y.astype(np.int64)
    x2 = np.minimum(x1 + 1, w - 1)
    y2 = np.minimum(y1 + 1, h - 1)
    x1c = x1
    y1c = y1

    q11 = tex[y1c, x1c, :3]
    q21 = tex[y1c, x2, :3]
    q12 = tex[y2, x1c, :3]
    q22 = tex[y2, x2, :3]
    # fractional weights via 1 - frac (not x2 - x) so clamped x2 == x1
    # still yields a unit-weight sample
    fx1 = (x - x1)[:, None]
    fx2 = 1.0 - fx1
    fy1 = (y - y1)[:, None]
    fy2 = 1.0 - fy1
    r1 = fx2 * q11 + fx1 * q21
    r2 = fx2 * q12 + fx1 * q22
    samples = fy2 * r1 + fy1 * r2
    # reference truncates each sample to int before averaging, then the
    # average to int (helpers.py:333, :204)
    samples = np.floor(samples)

    sums = np.zeros((num_vertices, 3))
    counts = np.zeros((num_vertices, 1))
    np.add.at(sums, v_idx_arr, samples)
    np.add.at(counts, v_idx_arr, 1.0)
    counts = np.maximum(counts, 1.0)
    return (sums / counts).astype(np.int64).astype(np.float32)
