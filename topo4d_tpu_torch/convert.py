"""Turn the JAX package's state, as NumPy arrays, into this package's objects.

Used by the tests that run the JAX reference and this port on the same
inputs. Every function takes plain arrays or objects with the reference's
attribute names (duck typing); nothing here imports JAX. Arrays are
copied: a tensor never aliases a buffer the caller's framework owns.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from topo4d_tpu_torch.core.camera import Camera
from topo4d_tpu_torch.device import resolve_device
from topo4d_tpu_torch.losses.flatten import DihedralQuadruples, UmbrellaFlatten
from topo4d_tpu_torch.losses.temporal import TemporalPriors
from topo4d_tpu_torch.mesh3d.bfm import MorphableModel
from topo4d_tpu_torch.opt.adam import AdamState
from topo4d_tpu_torch.opt.densify import DensifyState
from topo4d_tpu_torch.opt.step import GeometryPriors
from topo4d_tpu_torch.pipeline.scene import SceneStatics
from topo4d_tpu_torch.texture.dense import TextureState
from topo4d_tpu_torch.topology.adjacency import OneRing
from topo4d_tpu_torch.topology.densify_uv import DenseMesh, DenseTopology
from topo4d_tpu_torch.topology.regions import FacialRegions


def _t(a, dev, dtype=None):
    a = np.array(a)
    if dtype is None:
        dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) else None
    out = torch.as_tensor(a, device=dev)
    return out.to(dtype) if dtype is not None else out


def params_from_numpy(params, device="cuda") -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v, np.float32), device=dev) for k, v in params.items()}


def camera_from_numpy(cam, device="cuda") -> Camera:
    """A reference Camera (w2c, fx, fy, cx, cy, width, height, near, far)."""
    dev = resolve_device(device)
    f = lambda a: torch.as_tensor(np.array(a, np.float32), device=dev)
    return Camera(
        w2c=f(cam.w2c), fx=f(cam.fx), fy=f(cam.fy), cx=f(cam.cx), cy=f(cam.cy),
        width=int(cam.width), height=int(cam.height), near=cam.near, far=cam.far,
    )


def adam_state_from_numpy(opt, device="cuda") -> AdamState:
    """A reference AdamState (step, mu, nu dicts)."""
    dev = resolve_device(device)
    return AdamState(
        step={k: int(np.asarray(v)) for k, v in opt.step.items()},
        mu=params_from_numpy(opt.mu, dev),
        nu=params_from_numpy(opt.nu, dev),
    )


def densify_state_from_numpy(s, device="cuda") -> DensifyState:
    """A reference DensifyState (alive mask, gradient sums, counts, radii)."""
    dev = resolve_device(device)
    f = lambda a: torch.as_tensor(np.array(a, np.float32), device=dev)
    return DensifyState(
        alive=torch.as_tensor(np.array(s.alive, bool), device=dev), grad_accum=f(s.grad_accum), denom=f(s.denom),
        max_radius=f(s.max_radius),
    )


def priors_from_numpy(p, device="cuda") -> GeometryPriors:
    """A reference GeometryPriors (one-ring tables already (K, N))."""
    dev = resolve_device(device)
    f = lambda a: _t(np.array(a, np.float32), dev)
    return GeometryPriors(
        neighbor_indices=_t(p.neighbor_indices, dev, torch.int64),
        neighbor_dist=f(p.neighbor_dist),
        iso_w=f(p.iso_w),
        rig_w=f(p.rig_w),
        rot_w=f(p.rot_w),
        init_scale=f(p.init_scale),
        temporal=TemporalPriors(
            prev_inv_rot=f(p.temporal.prev_inv_rot), prev_offset=f(p.temporal.prev_offset)
        ),
        cos_init=f(p.cos_init),
    )


def regions_from_numpy(r) -> FacialRegions:
    return FacialRegions(
        region_masks={k: np.asarray(v) for k, v in r.region_masks.items()},
        masks={k: np.asarray(v) for k, v in r.masks.items()},
        flat_faces={k: np.asarray(v) for k, v in r.flat_faces.items()},
    )


def texture_state_from_numpy(ts, device="cuda") -> TextureState:
    """A reference TextureState (dense params, AdamState)."""
    return TextureState(params=params_from_numpy(ts.params, device), opt=adam_state_from_numpy(ts.opt, device))


def dense_mesh_from_numpy(d) -> DenseMesh:
    """A reference DenseMesh (its DenseTopology and triangulated faces)."""
    topo = DenseTopology(**{
        f.name: np.array(getattr(d.topo, f.name)) if isinstance(getattr(d.topo, f.name), np.ndarray)
        else getattr(d.topo, f.name)
        for f in dataclasses.fields(DenseTopology)
    })
    return DenseMesh(topo=topo, tri_faces=np.array(d.tri_faces), tri_uv_faces=np.array(d.tri_uv_faces))


def statics_from_numpy(s) -> SceneStatics:
    """A reference SceneStatics (geometry, UV and dense-mesh fields) as this
    package's statics."""
    return SceneStatics(
        ring=OneRing(
            indices=np.asarray(s.ring.indices), dist=np.asarray(s.ring.dist),
            weight=np.asarray(s.ring.weight), ragged=[list(r) for r in s.ring.ragged],
        ),
        quadruples={k: DihedralQuadruples(*(np.asarray(f) for f in q)) for k, q in s.quadruples.items()},
        umbrellas={k: UmbrellaFlatten(*(np.asarray(f) for f in u)) for k, u in s.umbrellas.items()},
        iso_w=np.asarray(s.iso_w),
        rig_w=np.asarray(s.rig_w),
        rot_w=np.asarray(s.rot_w),
        init_scale=np.asarray(s.init_scale),
        regions=regions_from_numpy(s.regions),
        faces=[list(f) for f in s.faces],
        tri_faces=np.asarray(s.tri_faces),
        trans_g=np.asarray(s.trans_g),
        uvs=None if s.uvs is None else np.asarray(s.uvs),
        uv_faces=None if s.uv_faces is None else [list(f) for f in s.uv_faces],
        dense=None if s.dense is None else dense_mesh_from_numpy(s.dense),
    )


def morphable_model_from_numpy(m, device="cuda") -> MorphableModel:
    """A reference MorphableModel (float32 bases, int32 triangles and
    keypoint indices, optional texture PCA) on ``device``: floats stay
    float32, indices become int64."""
    dev = resolve_device(device)
    return MorphableModel(**{
        name: None if getattr(m, name) is None else _t(getattr(m, name), dev)
        for name in MorphableModel._fields
    })
