"""Scene assembly: startup mesh -> params, statics, constraints.

Counterpart of ``pipeline/scene.py`` (``build_scene`` :62-235 with the dense
texture mesh, ``init_dense_params`` :237, ``merge_constraints`` :289,
``build_constraints`` :325, ``cache_first_frame_attrs`` :416,
``build_dense_pre_constraints`` :432).
Host NumPy throughout; the trainer moves the results to the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from topo4d_tpu_torch.config import Config
from topo4d_tpu_torch.core.quaternion import normal_to_quat_reference
from topo4d_tpu_torch.device import resolve_device
from topo4d_tpu_torch.losses.flatten import (
    DihedralQuadruples,
    UmbrellaFlatten,
    build_dihedral_quadruples,
    build_umbrella_flatten,
)
from topo4d_tpu_torch.opt.constraints import (
    DenseConstraint,
    ScatterConstraint,
    compile_dense_constraints,
    inverse_sigmoid,
)
from topo4d_tpu_torch.topology.adjacency import OneRing, build_one_ring, triangulate_faces
from topo4d_tpu_torch.topology.densify_uv import DenseMesh, build_dense_topology
from topo4d_tpu_torch.topology.interpolate import interpolate_dense_attribute
from topo4d_tpu_torch.topology.knn import mean_knn_sq_dist
from topo4d_tpu_torch.topology.normals import vertex_normals_np
from topo4d_tpu_torch.topology.obj_io import MeshObj, vertex_uv_multiplicity
from topo4d_tpu_torch.topology.regions import FacialRegions, build_region_weight_matrix


@dataclasses.dataclass
class SceneStatics:
    """Host-side precomputed constants for a sequence run."""

    ring: OneRing
    quadruples: Dict[str, DihedralQuadruples]
    umbrellas: Dict[str, UmbrellaFlatten]
    iso_w: np.ndarray
    rig_w: np.ndarray
    rot_w: np.ndarray
    init_scale: np.ndarray  # (N,) sqrt(mean knn sq dist)
    regions: FacialRegions
    faces: List[List[int]]
    tri_faces: np.ndarray
    trans_g: np.ndarray  # (4, 4) global transform (applied inverse at init)
    uvs: Optional[np.ndarray] = None  # (T, 2) texture coordinates
    uv_faces: Optional[List[List[int]]] = None
    dense: Optional[DenseMesh] = None  # the texture phase's mesh (gen_tex)


def build_scene(
    mesh: MeshObj,
    regions: FacialRegions,
    cfg: Config,
    num_views: Optional[int] = None,
    vertex_colors: Optional[np.ndarray] = None,  # (V, 3) in [0, 1]
    trans_g: Optional[np.ndarray] = None,
):
    """-> (params dict of NumPy arrays, SceneStatics). Mirrors train.py:115-269.

    ``num_views`` (the per-view ``cam_m`` / ``cam_c`` rows) defaults to
    ``cfg.data.max_cams``; ``vertex_colors`` to mid-gray (the reference
    samples them from the startup texture).
    """
    num_views = num_views or cfg.data.max_cams
    trans_g = np.eye(4) if trans_g is None else np.asarray(trans_g)
    inv_g = np.linalg.inv(trans_g)
    vertices = mesh.vertices @ inv_g[:3, :3].T + inv_g[:3, 3]
    n = vertices.shape[0]
    if vertex_colors is None:
        vertex_colors = np.full((n, 3), 0.5, np.float32)

    mean_sq = mean_knn_sq_dist(vertices, 1)  # k = 1 (train.py:132-133)
    tri_faces = np.asarray(triangulate_faces(mesh.faces), np.int32)
    normals = vertex_normals_np(vertices, tri_faces)
    q_init = normal_to_quat_reference(normals)

    params = {
        "means3D": vertices.astype(np.float32),
        "rgb_colors": np.asarray(vertex_colors, np.float32).copy(),
        "unnorm_rotations": q_init.astype(np.float32),
        # logit 1000 ~ opacity 1.0, as the reference (train.py:142)
        "logit_opacities": np.full((n, 1), 1000.0, np.float32),
        "log_scales": np.tile(np.log(np.sqrt(mean_sq) / 2.0)[:, None], (1, 3)).astype(np.float32),
        "cam_m": np.zeros((num_views, 3), np.float32),
        "cam_c": np.zeros((num_views, 3), np.float32),
    }

    ring = build_one_ring(vertices, mesh.faces, boundary_mask=regions.masks["eye_del_masks"])
    ff = regions.flat_faces
    quadruples = {
        "flat": build_dihedral_quadruples(ff["flat_faces"]),
        "flat_lip_bottom": build_dihedral_quadruples(ff["lip_bottom_flat_faces"]),
        "flat_lip": build_dihedral_quadruples(ff["lip_flat_faces"]),
        "flat_mouth": build_dihedral_quadruples(ff["mouth_flat_faces"]),
        "flat_lid_top": build_dihedral_quadruples(ff["lid_top_flat_faces"]),
        "flat_lid_bottom": build_dihedral_quadruples(ff["lid_bottom_flat_faces"]),
    }
    rm = regions.region_masks
    umbrellas = {
        "flat_eye": build_umbrella_flatten(
            ring.ragged, n,
            region=np.concatenate([rm["EyeLidOuterTop"], rm["EyeLidTop"], rm["EyeLidBottom"]]),
        ),
        "flat_lip_socket": build_umbrella_flatten(
            ring.ragged, n, region=regions.masks["lip_socket_flat_masks"]
        ),
        "flat_face_bottom": build_umbrella_flatten(
            ring.ragged, n,
            region=np.concatenate(
                [
                    rm[name]
                    for name in (
                        "LipOuterTop", "LipOuterBottom", "Chin", "NeckFront",
                        "LipBottom", "LipTop", "LipInnerBottom", "LipInnerTop",
                        "EyeLidOuterBottom", "EyeLidBottom",
                        "MouthSocket", "EyeSocket",
                    )
                ]
                + [regions.masks["face_flat_masks"]]
            ),
            ex_mask=regions.masks["lip_flat_edge_masks"].tolist(),
        ),
    }

    w = cfg.weights
    statics = SceneStatics(
        ring=ring,
        quadruples=quadruples,
        umbrellas=umbrellas,
        iso_w=build_region_weight_matrix(ring.weight, regions, cfg.iso_region_multipliers, w.iso),
        rig_w=build_region_weight_matrix(ring.weight, regions, cfg.rigid_region_multipliers, w.rigid),
        rot_w=build_region_weight_matrix(ring.weight, regions, cfg.rot_region_multipliers, w.rot),
        init_scale=np.sqrt(mean_sq).astype(np.float32),
        regions=regions,
        faces=mesh.faces,
        tri_faces=tri_faces,
        trans_g=trans_g,
        uvs=mesh.uvs,
        uv_faces=mesh.uv_faces,
    )

    # dense (texture) topology (train.py:209-267)
    if cfg.texture.gen_tex:
        mult = [len(m) for m in vertex_uv_multiplicity(n, mesh.faces, mesh.uv_faces, mesh.uvs)]
        statics.dense = build_dense_topology(
            vertices.astype(np.float32), mesh.uvs, mesh.faces, mesh.uv_faces,
            regions.masks["face_masks"], cfg.texture.density, mult,
        )

    # pre-loop writes (train.py:622-623): mouth region black, eye region white
    params["rgb_colors"][regions.masks["dynamic_mouth_masks"]] = 0.0
    params["rgb_colors"][regions.masks["dynamic_eye_masks"]] = 1.0
    return params, statics


def init_dense_params(
    params: Dict[str, np.ndarray],
    statics: SceneStatics,
    num_views: int,
) -> Dict[str, np.ndarray]:
    """Dense Gaussian attributes (train.py:244-263): colors interpolated from
    the geometry's (static, dynamic and inner-mouth regions black), opacity
    0.9999, isotropic scales sqrt(mean 4-NN squared distance), identity
    rotations. ``num_views`` is kept for the reference's signature."""
    if statics.dense is None:
        raise ValueError("the scene has no dense mesh (build it with texture.gen_tex)")
    topo = statics.dense.topo
    dense_v = topo.dense_vertices
    nd = dense_v.shape[0]
    mean_sq = mean_knn_sq_dist(dense_v, 4)
    m = statics.regions.masks
    aux = np.array(params["rgb_colors"], np.float32)
    aux[m["static_masks"]] = 0.0
    aux[m["dynamic_masks"]] = 0.0
    aux[m["mouth_inner_masks"]] = 0.0
    colors = interpolate_dense_attribute(
        torch.as_tensor(aux), torch.as_tensor(topo.quad_faces),
        torch.as_tensor(topo.father_face), torch.as_tensor(topo.weights),
    ).numpy()
    return {
        "dense_rgb_colors": colors.astype(np.float32),
        "dense_logit_opacities": np.full((nd, 1), inverse_sigmoid(0.9999), np.float32),
        "dense_log_scales": np.tile(np.log(np.sqrt(mean_sq))[:, None], (1, 3)).astype(np.float32),
        "dense_unnorm_rotations": np.tile(np.array([1.0, 0, 0, 0], np.float32), (nd, 1)),
    }


def _const(param, idx, value, like):
    idx = np.asarray(idx, np.int32)
    return ScatterConstraint(
        param=param, idx=idx, value=np.full((idx.shape[0],) + like.shape[1:], value, np.float32)
    )


def merge_constraints(cons: List[ScatterConstraint]) -> List[ScatterConstraint]:
    """One scatter per parameter: the reference writes its regions one
    after another (the last write wins where they overlap,
    train.py:676-700), so keeping each index's last value gives the same
    result in a single write."""
    by_param: Dict[str, Dict[int, int]] = {}
    values: Dict[str, list] = {}
    for c in cons:
        vals = np.asarray(c.value)
        if vals.ndim == 1:
            vals = np.broadcast_to(vals[None], (len(c.idx),) + vals.shape)
        slot = by_param.setdefault(c.param, {})
        vlist = values.setdefault(c.param, [])
        for j, idx in enumerate(np.asarray(c.idx)):
            slot[int(idx)] = len(vlist)
            vlist.append(vals[j])
    out = []
    for param, slot in by_param.items():
        idx = np.fromiter(slot.keys(), np.int32, len(slot))
        sel = np.fromiter(slot.values(), np.int64, len(slot))
        out.append(ScatterConstraint(param=param, idx=idx, value=np.stack(values[param])[sel]))
    return out


def build_constraints(
    phase: str,
    params0: Dict[str, np.ndarray],  # frame-0 initial params (host)
    regions: FacialRegions,
    first_frame_attrs: Optional[Dict[str, np.ndarray]] = None,
    device="cuda",
    merge: bool = True,
    dense: bool = True,
) -> List[Union[DenseConstraint, ScatterConstraint]]:
    """Post-step region writes for ``phase`` in {"init_early", "init", "track"}
    (train.py:676-700).

    init_early covers the first 70% of frame-0 iterations, where the eye
    region is additionally frozen (train.py:682-686). With ``dense`` (the
    form the trainer runs) the writes are compiled to one masked select per
    parameter; else with ``merge`` to one scatter per parameter
    (``merge_constraints``), else they stay the sequential scatters. The
    scatters' values are put on ``device``.
    """
    m = regions.masks
    rm = regions.region_masks
    p0 = params0
    cons: List[ScatterConstraint] = [
        ScatterConstraint(
            param="means3D", idx=np.asarray(m["static_masks"], np.int32),
            value=np.asarray(p0["means3D"])[m["static_masks"]],
        ),
        _const("logit_opacities", m["eye_inner_masks"], inverse_sigmoid(1e-6), p0["logit_opacities"]),
        _const("rgb_colors", m["dynamic_mouth_masks"], 0.0, p0["rgb_colors"]),
        _const("logit_opacities", m["dynamic_mouth_masks"], inverse_sigmoid(0.99999), p0["logit_opacities"]),
        _const("log_scales", m["dynamic_mouth_masks"], float(np.log(0.01)), p0["log_scales"]),
        _const("log_scales", m["mouth_inner_masks"], float(np.log(0.002)), p0["log_scales"]),
    ]
    if phase == "init_early":
        cons += [
            _const("log_scales", m["dynamic_eye_masks"], float(np.log(0.0025)), p0["log_scales"]),
            _const("logit_opacities", m["dynamic_eye_masks"], inverse_sigmoid(0.99999), p0["logit_opacities"]),
        ]
    if phase in ("init_early", "init"):
        cons += [
            ScatterConstraint(
                param="rgb_colors", idx=np.asarray(m["face_masks"], np.int32),
                value=np.asarray(p0["rgb_colors"])[m["face_masks"]],
            ),
            _const("rgb_colors", m["mouth_inner_masks"], 0.0, p0["rgb_colors"]),
        ]
    if phase == "track":
        if first_frame_attrs is None:
            raise ValueError("the track phase needs the frame-0 attributes")
        ffa = first_frame_attrs
        cons += [
            ScatterConstraint(param="rgb_colors", idx=np.asarray(m["dynamic_eye_masks"], np.int32),
                              value=ffa["dynamic_eye_colors"]),
            _const("rgb_colors", m["eye_del_masks"], 0.0, p0["rgb_colors"]),
            ScatterConstraint(param="rgb_colors", idx=np.asarray(m["eye_around_masks"], np.int32),
                              value=ffa["eye_around_colors"]),
            ScatterConstraint(param="rgb_colors", idx=np.asarray(rm["EyeLidBottom"], np.int32),
                              value=ffa["eye_bottom_colors"]),
            ScatterConstraint(param="rgb_colors", idx=np.asarray(m["mouth_around_masks"], np.int32),
                              value=ffa["mouth_around_colors"]),
            ScatterConstraint(param="rgb_colors", idx=np.asarray(m["face_bottom_masks"], np.int32),
                              value=ffa["face_bottom_colors"]),
            _const("rgb_colors", m["mouth_inner_masks"], 0.0, p0["rgb_colors"]),
        ]
    if dense:
        return compile_dense_constraints(p0, cons, device)
    dev = resolve_device(device)
    return [
        dataclasses.replace(c, value=torch.as_tensor(np.asarray(c.value, np.float32), device=dev))
        for c in (merge_constraints(cons) if merge else cons)
    ]


def cache_first_frame_attrs(params, regions: FacialRegions) -> Dict[str, np.ndarray]:
    """Frame-0 attribute snapshot as host arrays (train.py:441-451)."""
    rgb = params["rgb_colors"]
    rgb = rgb.detach().cpu().numpy() if isinstance(rgb, torch.Tensor) else np.asarray(rgb)
    m = regions.masks
    return {
        "dynamic_eye_colors": rgb[m["dynamic_eye_masks"]],
        "eye_around_colors": rgb[m["eye_around_masks"]],
        "eye_bottom_colors": rgb[regions.region_masks["EyeLidBottom"]],
        "mouth_around_colors": rgb[m["mouth_around_masks"]],
        "face_bottom_colors": rgb[m["face_bottom_masks"]],
    }


def build_dense_pre_constraints(
    params0_dense: Dict[str, np.ndarray], regions: FacialRegions, device="cuda"
) -> List[DenseConstraint]:
    """Texture-phase color zeroing before every step (train.py:731-734)."""
    m = regions.masks
    like = params0_dense["dense_rgb_colors"]
    cons = [
        _const("dense_rgb_colors", m["static_masks"], 0.0, like),
        _const("dense_rgb_colors", m["dynamic_masks"], 0.0, like),
        _const("dense_rgb_colors", m["mouth_inner_masks"], 0.0, like),
    ]
    return compile_dense_constraints(params0_dense, cons, device)
