"""UV-space densification of quad faces (host NumPy; topology/densify_uv.py).

Every frontal quad is subdivided into a (D+1) x (D+1) grid of quads by
bilinear interpolation (the reference's ``build_dense_vertices_2``,
helpers.py:421-654). The D interior points of an edge are shared with the
adjacent quad unless the edge crosses a UV seam (shareable iff either
endpoint has a single UV coordinate, helpers.py:436-467); seam edges
duplicate their points per face. Vectorised grid index algebra; the ids
follow a deterministic block allocation: [shared edge points | seam
instance points | interior points].

Per new point (father quad, 4 bilinear weights) drive the per-frame dense
attribute interpolation (``interpolate.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from topo4d_tpu_torch.topology.adjacency import split_faces_by_mask, triangulate_faces


@dataclasses.dataclass
class DenseTopology:
    """Densified mesh: original verts/uvs first, then new points."""

    dense_vertices: np.ndarray  # (V + P, 3)
    dense_uvs: np.ndarray  # (T + P, 2)
    dense_quad_faces: np.ndarray  # (Fd, 4) vertex ids of densified quads
    dense_uv_quad_faces: np.ndarray  # (Fd, 4) uv ids
    father_face: np.ndarray  # (P,) index into the frontal quad array
    weights: np.ndarray  # (P, 4) bilinear weights over the father's corners
    quad_faces: np.ndarray  # (F, 4) the frontal quads that were densified
    num_base_vertices: int
    num_base_uvs: int
    num_shared_edges: int
    num_seam_edge_instances: int


# Grid corner convention: (i, j) in [0, D+1]^2 with corners
# (0,0)=c0, (D+1,0)=c1, (D+1,D+1)=c2, (0,D+1)=c3 and bilinear params
# t=i/(D+1) (c0->c1), u=j/(D+1) (c0->c3) — the reference's parametrization
# (helpers.py:532-540).
_EDGE_SLOTS = (
    (0, 1),  # j == 0 column,  i increasing: c0 -> c1
    (1, 2),  # i == D+1 row,   j increasing: c1 -> c2
    (3, 2),  # j == D+1 column, i increasing: c3 -> c2
    (0, 3),  # i == 0 row,     j increasing: c0 -> c3
)


def densify_quads(
    vertices: np.ndarray,  # (V, 3)
    uvs: np.ndarray,  # (T, 2)
    quad_faces: np.ndarray,  # (F, 4) vertex ids (frontal quads)
    quad_uv_faces: np.ndarray,  # (F, 4) uv ids
    density: int,
    uv_multiplicity: Sequence[int],  # per-vertex distinct-UV count
) -> DenseTopology:
    """Subdivide each quad into (density+1)^2 quads with shared-edge dedup."""
    v = int(vertices.shape[0])
    t = int(uvs.shape[0])
    f = int(quad_faces.shape[0])
    d = int(density)
    g = d + 2  # grid points per side
    quad_faces = np.asarray(quad_faces, np.int64)
    quad_uv_faces = np.asarray(quad_uv_faces, np.int64)
    mult = np.asarray(uv_multiplicity, np.int64)

    # ---- classify the 4 edges of every face ------------------------------
    # endpoints per (face, slot)
    ea = np.stack([quad_faces[:, a] for a, _ in _EDGE_SLOTS], axis=1)  # (F,4)
    eb = np.stack([quad_faces[:, b] for _, b in _EDGE_SLOTS], axis=1)
    shareable = (mult[ea] == 1) | (mult[eb] == 1)  # (F, 4)

    lo = np.minimum(ea, eb)
    hi = np.maximum(ea, eb)
    keys = lo * (v + 1) + hi  # canonical undirected edge key

    flat_keys = keys.reshape(-1)
    flat_share = shareable.reshape(-1)
    uniq_keys, first_pos, inverse = np.unique(
        np.where(flat_share, flat_keys, -1 - np.arange(flat_keys.size)),
        return_index=True,
        return_inverse=True,
    )
    # For shareable edges, inverse groups instances of the same edge; the
    # owner is the instance with the smallest flat position (first_pos).
    is_shared_group = uniq_keys >= 0
    num_shared = int(is_shared_group.sum())
    # map group -> dense shared-edge ordinal (only for shared groups)
    group_ordinal = np.full(uniq_keys.size, -1, np.int64)
    group_ordinal[is_shared_group] = np.arange(num_shared)

    shared_ord = group_ordinal[inverse].reshape(f, 4)  # (F,4), -1 if seam
    owner_flat_pos = first_pos[inverse].reshape(f, 4)  # owning (face,slot)
    is_owner = (
        owner_flat_pos == (np.arange(f)[:, None] * 4 + np.arange(4)[None, :])
    )

    seam = ~shareable  # per-instance allocation
    seam_ordinal = np.full((f, 4), -1, np.int64)
    seam_ordinal[seam] = np.arange(int(seam.sum()))
    num_seam = int(seam.sum())

    # ---- allocate new point ids -----------------------------------------
    # layout: [shared edge points | seam instance points | interior points]
    shared_base = 0
    seam_base = num_shared * d
    interior_base = seam_base + num_seam * d
    num_new = interior_base + f * d * d

    # ---- father / weights for every new point ---------------------------
    father = np.empty(num_new, np.int64)
    weights = np.empty((num_new, 4), np.float64)

    def corner_weights(tt: np.ndarray, uu: np.ndarray) -> np.ndarray:
        return np.stack(
            [(1 - tt) * (1 - uu), tt * (1 - uu), tt * uu, (1 - tt) * uu], axis=-1
        )

    # grid parameter of the m-th interior point of each edge slot, in the
    # OWNER face's (t, u) coords, ordered from the canonical lo -> hi vertex.
    m = np.arange(1, d + 1, dtype=np.float64) / (d + 1)  # (d,)

    # per-slot (t, u) along the slot's natural direction (a -> b)
    def slot_param(slot: int, mm: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if slot == 0:  # c0 -> c1: t = mm, u = 0
            return mm, np.zeros_like(mm)
        if slot == 1:  # c1 -> c2: t = 1, u = mm
            return np.ones_like(mm), mm
        if slot == 2:  # c3 -> c2: t = mm, u = 1
            return mm, np.ones_like(mm)
        return np.zeros_like(mm), mm  # c0 -> c3: t = 0, u = mm

    # shared edges: one block of d points per unique edge, owner's params
    own_face, own_slot = np.nonzero(is_owner & shareable)
    for slot in range(4):
        sel = own_slot == slot
        if not np.any(sel):
            continue
        faces_here = own_face[sel]
        ords = shared_ord[faces_here, slot]
        tt, uu = slot_param(slot, m)
        # canonical direction lo -> hi: flip if a > b along the slot
        flip = ea[faces_here, slot] > eb[faces_here, slot]
        base_ids = shared_base + ords[:, None] * d + np.arange(d)[None, :]
        w_fwd = corner_weights(tt, uu)  # (d, 4)
        w_rev = w_fwd[::-1]
        w = np.where(flip[:, None, None], w_rev[None], w_fwd[None])  # (n,d,4)
        father[base_ids.reshape(-1)] = np.repeat(faces_here, d)
        weights[base_ids.reshape(-1)] = w.reshape(-1, 4)

    # seam instances: d points per (face, slot), natural a -> b direction
    seam_face, seam_slot = np.nonzero(seam)
    for slot in range(4):
        sel = seam_slot == slot
        if not np.any(sel):
            continue
        faces_here = seam_face[sel]
        ords = seam_ordinal[faces_here, slot]
        tt, uu = slot_param(slot, m)
        base_ids = seam_base + ords[:, None] * d + np.arange(d)[None, :]
        w_fwd = corner_weights(tt, uu)
        father[base_ids.reshape(-1)] = np.repeat(faces_here, d)
        weights[base_ids.reshape(-1)] = np.tile(w_fwd, (faces_here.size, 1))

    # interior points: row-major (i, j) blocks per face
    ii, jj = np.meshgrid(np.arange(1, d + 1), np.arange(1, d + 1), indexing="ij")
    tt = ii.astype(np.float64) / (d + 1)
    uu = jj.astype(np.float64) / (d + 1)
    w_int = corner_weights(tt, uu).reshape(-1, 4)  # (d*d, 4)
    int_ids = interior_base + np.arange(f * d * d)
    father[int_ids] = np.repeat(np.arange(f), d * d)
    weights[int_ids] = np.tile(w_int, (f, 1))

    # ---- positions & uvs of new points ----------------------------------
    corner_pos = vertices[quad_faces]  # (F, 4, 3)
    corner_uv = uvs[quad_uv_faces]  # (F, 4, 2)
    new_pos = np.einsum("pk,pkc->pc", weights, corner_pos[father])
    new_uv = np.einsum("pk,pkc->pc", weights, corner_uv[father])

    dense_vertices = np.concatenate([vertices, new_pos], axis=0)
    dense_uvs = np.concatenate([uvs, new_uv], axis=0)

    # ---- grid index matrices & face assembly ----------------------------
    # Pidx[f, i, j]: global vertex id at grid point (i, j) of face f.
    pidx = np.empty((f, g, g), np.int64)
    uidx = np.empty((f, g, g), np.int64)

    # corners
    pidx[:, 0, 0] = quad_faces[:, 0]
    pidx[:, g - 1, 0] = quad_faces[:, 1]
    pidx[:, g - 1, g - 1] = quad_faces[:, 2]
    pidx[:, 0, g - 1] = quad_faces[:, 3]
    uidx[:, 0, 0] = quad_uv_faces[:, 0]
    uidx[:, g - 1, 0] = quad_uv_faces[:, 1]
    uidx[:, g - 1, g - 1] = quad_uv_faces[:, 2]
    uidx[:, 0, g - 1] = quad_uv_faces[:, 3]

    # edge interiors: slot -> grid positions along natural a -> b order
    def fill_edge(slot: int, ids: np.ndarray, faces_here: np.ndarray):
        """ids: (n, d) point ids in natural a -> b order for these faces."""
        rng = np.arange(1, d + 1)
        if slot == 0:
            pidx[faces_here[:, None], rng[None, :], 0] = v + ids
            uidx[faces_here[:, None], rng[None, :], 0] = t + ids
        elif slot == 1:
            pidx[faces_here[:, None], g - 1, rng[None, :]] = v + ids
            uidx[faces_here[:, None], g - 1, rng[None, :]] = t + ids
        elif slot == 2:
            pidx[faces_here[:, None], rng[None, :], g - 1] = v + ids
            uidx[faces_here[:, None], rng[None, :], g - 1] = t + ids
        else:
            pidx[faces_here[:, None], 0, rng[None, :]] = v + ids
            uidx[faces_here[:, None], 0, rng[None, :]] = t + ids

    for slot in range(4):
        # shared (both owners and borrowers)
        faces_here = np.nonzero(shareable[:, slot])[0]
        if faces_here.size:
            ords = shared_ord[faces_here, slot]
            ids = shared_base + ords[:, None] * d + np.arange(d)[None, :]
            flip = ea[faces_here, slot] > eb[faces_here, slot]
            ids = np.where(flip[:, None], ids[:, ::-1], ids)
            fill_edge(slot, ids, faces_here)
        # seams
        faces_here = np.nonzero(seam[:, slot])[0]
        if faces_here.size:
            ords = seam_ordinal[faces_here, slot]
            ids = seam_base + ords[:, None] * d + np.arange(d)[None, :]
            fill_edge(slot, ids, faces_here)

    # interiors
    int_grid = interior_base + (
        np.arange(f)[:, None, None] * d * d
        + (np.arange(d)[:, None] * d + np.arange(d)[None, :])[None]
    )
    pidx[:, 1 : d + 1, 1 : d + 1] = v + int_grid
    uidx[:, 1 : d + 1, 1 : d + 1] = t + int_grid

    # faces: quad (i-1,j-1), (i,j-1), (i,j), (i-1,j) — reference winding
    # (helpers.py:548-556)
    q00 = pidx[:, : g - 1, : g - 1]
    q10 = pidx[:, 1:, : g - 1]
    q11 = pidx[:, 1:, 1:]
    q01 = pidx[:, : g - 1, 1:]
    dense_quad_faces = np.stack([q00, q10, q11, q01], axis=-1).reshape(-1, 4)
    u00 = uidx[:, : g - 1, : g - 1]
    u10 = uidx[:, 1:, : g - 1]
    u11 = uidx[:, 1:, 1:]
    u01 = uidx[:, : g - 1, 1:]
    dense_uv_quad_faces = np.stack([u00, u10, u11, u01], axis=-1).reshape(-1, 4)

    return DenseTopology(
        dense_vertices=dense_vertices.astype(np.float32),
        dense_uvs=dense_uvs.astype(np.float32),
        dense_quad_faces=dense_quad_faces.astype(np.int32),
        dense_uv_quad_faces=dense_uv_quad_faces.astype(np.int32),
        father_face=father.astype(np.int32),
        weights=weights.astype(np.float32),
        quad_faces=quad_faces.astype(np.int32),
        num_base_vertices=v,
        num_base_uvs=t,
        num_shared_edges=num_shared,
        num_seam_edge_instances=num_seam,
    )


@dataclasses.dataclass
class DenseMesh:
    """Full dense topology (train.py:209-243 composition)."""

    topo: DenseTopology
    tri_faces: np.ndarray  # (Ft, 3) final triangulated dense faces
    tri_uv_faces: np.ndarray  # (Ft, 3)


def build_dense_topology(
    vertices: np.ndarray,
    uvs: np.ndarray,
    faces: Sequence[Sequence[int]],  # mixed-arity original faces
    uv_faces: Sequence[Sequence[int]],
    face_mask_vertices: Sequence[int],  # frontal-face vertex mask
    density: int,
    uv_multiplicity: Sequence[int],
) -> DenseMesh:
    """Densify frontal quads; keep tris + non-frontal quads; triangulate.

    Composition mirrors train.py:209-236: final faces =
    tris + densified frontal quads + untouched non-frontal quads,
    all fan-triangulated.
    """
    quad_faces = np.array([fc for fc in faces if len(fc) == 4])
    quad_idx = np.array([i for i, fc in enumerate(faces) if len(fc) == 4])
    tri_faces = [fc for fc in faces if len(fc) == 3]
    tri_uv_faces = [uv_faces[i] for i, fc in enumerate(faces) if len(fc) == 3]

    front_quads, front_idx, back_quads, back_idx = split_faces_by_mask(
        quad_faces, quad_idx, face_mask_vertices
    )
    front_uv = np.array([uv_faces[i] for i in front_idx])
    back_uv = [uv_faces[i] for i in back_idx]

    topo = densify_quads(
        vertices, uvs, front_quads, front_uv, density, uv_multiplicity
    )

    all_faces = (
        tri_faces
        + topo.dense_quad_faces.tolist()
        + [list(fc) for fc in back_quads]
    )
    all_uv_faces = (
        tri_uv_faces
        + topo.dense_uv_quad_faces.tolist()
        + [list(fc) for fc in back_uv]
    )
    tris = np.asarray(triangulate_faces(all_faces), np.int32)
    uv_tris = np.asarray(triangulate_faces(all_uv_faces), np.int32)
    return DenseMesh(topo=topo, tri_faces=tris, tri_uv_faces=uv_tris)
