"""The geometry train step: render -> losses -> Adam -> constraints (opt/step.py).

Phases:
- "init": frame 0 - photometric + scale/scale_max + soft-flatten losses,
  whose current dihedral cosines are returned for caching (train.py:360-368);
- "track": frames > 0 - photometric + rigid/rot/iso + the flatten and
  umbrella losses (train.py:330-357).

One step is eager PyTorch: a forward, one ``torch.autograd.grad`` and a
no-grad update. Loss weights and learning rates are host floats and the
view id a host int, so a step reads nothing back from the card.

``make_geometry_multi_step`` runs a segment of identically configured
steps (the JAX package's scan); with frozen binnings it bins each view once
at the segment's entry and every step packs along its view's permutation.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from topo4d_tpu_torch.core.camera import Camera
from topo4d_tpu_torch.core.gaussian import GaussianRenderVars, activate_params
from topo4d_tpu_torch.device import resolve_device
from topo4d_tpu_torch.losses.flatten import (
    DihedralQuadruples,
    UmbrellaFlatten,
    build_fused_flatten,
    build_fused_umbrella,
    fused_flatten_loss,
    fused_umbrella_from_nb,
    fused_umbrella_loss,
    prepare_quad_gather,
    to_device,
)
from topo4d_tpu_torch.losses.image import photometric_loss, psnr
from topo4d_tpu_torch.losses.neighbors import build_inverse_incidence
from topo4d_tpu_torch.losses.temporal import TemporalPriors, rigid_rot_iso_losses
from topo4d_tpu_torch.opt.adam import AdamState, adam_update
from topo4d_tpu_torch.opt.constraints import DenseConstraint, apply_constraints

SOFT_FLATTEN_KEYS = ("flat_lid_top", "flat_lid_bottom", "flat_lip", "flat_mouth")
HARD_FLATTEN_KEYS = ("flat", "flat_lip_bottom")
UMBRELLA_KEYS = ("flat_eye", "flat_lip_socket", "flat_face_bottom")


class GeometryPriors(NamedTuple):
    """Per-run constants + per-frame temporal caches; one-ring tables (K, N)."""

    neighbor_indices: torch.Tensor  # (K, N) int64
    neighbor_dist: torch.Tensor  # (K, N)
    iso_w: torch.Tensor  # (K, N)
    rig_w: torch.Tensor  # (K, N)
    rot_w: torch.Tensor  # (K, N)
    init_scale: torch.Tensor  # (N,) sqrt(mean knn sq dist)
    temporal: TemporalPriors
    cos_init: torch.Tensor  # (Es,) fused soft-flatten initial cosines


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt: AdamState
    max_2d_radius: torch.Tensor  # (N,) float


def build_topo_losses(
    quadruples: Dict[str, DihedralQuadruples],
    umbrellas: Dict[str, UmbrellaFlatten],
    num_vertices: int,
    ring_indices: Optional[np.ndarray] = None,  # (N, K) - priors.neighbor_indices pre-transpose
    device="cuda",
) -> Callable:
    """The shared topological/temporal loss assembly (train.py:330-368).

    Returns ``topo(rv, priors, weights, phase) -> (losses, new_cos,
    pre_weighted)``; ``pre_weighted`` (flatten + umbrella) is already
    weight-scaled. When the umbrella sets' one-ring table equals
    ``ring_indices``, the umbrella loss reuses the temporal losses' gather.
    """
    dev = resolve_device(device)
    fused_quads = build_fused_flatten(quadruples, HARD_FLATTEN_KEYS, SOFT_FLATTEN_KEYS)
    quad_gather = prepare_quad_gather(fused_quads.quads, num_vertices, dev)
    fused_umb = build_fused_umbrella(umbrellas, UMBRELLA_KEYS)
    umb_shares_ring = (
        fused_umb is not None
        and ring_indices is not None
        and np.array_equal(fused_umb.neighbor_indices, ring_indices)
    )
    if fused_umb is not None:
        fused_umb = to_device(fused_umb, dev)
    ring_inv = None
    if ring_indices is not None:
        ring_inv = torch.as_tensor(
            build_inverse_incidence(np.asarray(ring_indices).T.reshape(-1), ring_indices.shape[0]),
            device=dev,
        )

    def topo(rv: GaussianRenderVars, priors: GeometryPriors, weights, phase: str):
        losses: Dict[str, torch.Tensor] = {}
        new_cos = priors.cos_init
        pre_weighted = torch.zeros((), device=rv.means3d.device)
        if phase == "init":
            losses["scale"] = torch.sum(torch.amin(rv.scales, dim=1))
            max_scale = torch.amax(rv.scales, dim=1)
            losses["scale_max"] = torch.sum(torch.relu(max_scale - priors.init_scale * 1.5))
            # only the soft sets are active at frame 0 (train.py:364-368)
            w0 = dict(weights)
            for k in fused_quads.hard_sets:
                w0[k] = 0.0
            flat_total, new_cos = fused_flatten_loss(
                rv.means3d, fused_quads, w0, soft_cos_init=None, gather=quad_gather
            )
            pre_weighted = pre_weighted + flat_total
        else:
            umb_fn = None
            if umb_shares_ring:
                umb_fn = lambda nb, xt: fused_umbrella_from_nb(nb, xt, fused_umb, weights)
            temporal = rigid_rot_iso_losses(
                rv.means3d, rv.rotations, priors.temporal, priors.neighbor_indices,
                priors.neighbor_dist, priors.rig_w, priors.rot_w, priors.iso_w,
                extra=umb_fn, ring_inv=ring_inv,
            )
            umb_pre = temporal.pop("extra", None)
            if umb_pre is not None:
                pre_weighted = pre_weighted + umb_pre
            losses.update(temporal)
            flat_total, _ = fused_flatten_loss(
                rv.means3d, fused_quads, weights, soft_cos_init=priors.cos_init,
                gather=quad_gather,
            )
            pre_weighted = pre_weighted + flat_total
            if fused_umb is not None and not umb_shares_ring:
                pre_weighted = pre_weighted + fused_umbrella_loss(rv.means3d, fused_umb, weights)
        return losses, new_cos, pre_weighted

    return topo


def update_state(
    state: TrainState,
    params: Dict[str, torch.Tensor],
    total: torch.Tensor,
    radii: torch.Tensor,
    constraints: Sequence[DenseConstraint],
    lr: Dict[str, float],
) -> TrainState:
    """Adam on the gradient of ``total`` with respect to ``params`` (the
    leaves of ``state.params`` made differentiable), the constraint writes,
    and ``max_2d_radius`` raised where ``radii`` saw a Gaussian."""
    keys = list(params)
    g = torch.autograd.grad(total, [params[k] for k in keys], allow_unused=True)
    grads = {k: gk if gk is not None else torch.zeros_like(params[k]) for k, gk in zip(keys, g)}
    return apply_gradients(state, grads, radii, constraints, lr)


def apply_gradients(
    state: TrainState,
    grads: Dict[str, torch.Tensor],
    radii: torch.Tensor,
    constraints: Sequence[DenseConstraint],
    lr: Dict[str, float],
) -> TrainState:
    """Adam on ``grads``, the constraint writes, and ``max_2d_radius``
    raised where ``radii`` saw a Gaussian."""
    new_params, new_opt = adam_update(state.params, grads, state.opt, lr)
    new_params = apply_constraints(new_params, constraints)
    with torch.no_grad():
        max_radius = torch.where(
            radii > 0, torch.maximum(radii.to(torch.float32), state.max_2d_radius), state.max_2d_radius
        )
    return TrainState(params=new_params, opt=new_opt, max_2d_radius=max_radius)


def _build_step_impl(
    quadruples: Dict[str, DihedralQuadruples],
    umbrellas: Dict[str, UmbrellaFlatten],
    render_fn: Callable[[GaussianRenderVars, Camera], object],
    num_vertices: int,
    ring_indices: Optional[np.ndarray] = None,
    device="cuda",
    binned_render_fn: Optional[Callable] = None,
) -> Callable:
    """The step body; ``binned_render_fn(rv, cam, binning)`` renders along a
    frozen binning when the step is given one."""
    topo = build_topo_losses(quadruples, umbrellas, num_vertices, ring_indices, device)

    def loss_fn(params, gt, cam, view_id: int, priors, weights, phase, binning=None):
        rv = activate_params(params)
        out = render_fn(rv, cam) if binning is None else binned_render_fn(rv, cam, binning)
        im = (
            torch.exp(params["cam_m"][view_id])[:, None, None] * out.image
            + params["cam_c"][view_id][:, None, None]
        )
        losses, new_cos, pre_weighted = topo(rv, priors, weights, phase)
        losses["im"] = photometric_loss(im, gt)
        losses["flatten"] = pre_weighted  # already weight-scaled
        total = sum(weights[k] * v for k, v in losses.items() if k in weights) + pre_weighted
        return total, (losses, new_cos, out.radii, im)

    def step_impl(
        state: TrainState,
        gt: torch.Tensor,  # (3, H, W) target of the chosen view
        cams: Camera,  # batched cameras
        view_id: int,
        priors: GeometryPriors,
        constraints: Sequence[DenseConstraint],
        lr: Dict[str, float],
        weights: Dict[str, float],
        phase: str,
        with_metrics: bool = True,
        binning=None,
    ) -> Tuple[TrainState, GeometryPriors, Dict[str, torch.Tensor]]:
        cam = cams[view_id]
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        total, (losses, new_cos, radii, im) = loss_fn(
            params, gt, cam, view_id, priors, weights, phase, binning
        )
        new_state = update_state(state, params, total, radii, constraints, lr)
        with torch.no_grad():
            metrics = {("loss_" + k): v.detach() for k, v in losses.items()}
            metrics["loss_total"] = total.detach()
            if with_metrics:
                metrics["psnr"] = torch.mean(psnr(im.detach(), gt))
        return new_state, priors._replace(cos_init=new_cos), metrics

    return step_impl


def make_geometry_step(
    quadruples: Dict[str, DihedralQuadruples],
    umbrellas: Dict[str, UmbrellaFlatten],
    render_fn: Callable[[GaussianRenderVars, Camera], object],
    num_vertices: int,
    ring_indices: Optional[np.ndarray] = None,
    device="cuda",
) -> Callable:
    """The single-iteration geometry step. ``render_fn(rv, cam) -> RenderOutput``.

    Returns ``step(state, gt, cams, view_id, priors, constraints, lr,
    weights, phase, with_metrics) -> (state, priors, metrics)``; metrics are
    detached 0-d tensors (PSNR only ``with_metrics``).
    """
    return _build_step_impl(quadruples, umbrellas, render_fn, num_vertices, ring_indices, device)


def make_geometry_multi_step(
    quadruples: Dict[str, DihedralQuadruples],
    umbrellas: Dict[str, UmbrellaFlatten],
    render_fn: Callable[[GaussianRenderVars, Camera], object],
    num_vertices: int,
    ring_indices: Optional[np.ndarray] = None,
    binned_render_fn: Optional[Callable] = None,
    binnings_fn: Optional[Callable] = None,
    device="cuda",
) -> Callable:
    """A segment of identically configured steps (``opt/step.py:274``).

    Returns ``multi_step(state, images, cams, view_ids, priors,
    constraints, lr, weights, phase) -> (state, priors, loss_total (S,))``:
    the steps of ``step`` with ``with_metrics=False`` over the segment's
    view ids (host ints), in order. The JAX package scans the segment into
    one program; the semantics, not that device, are ported.

    With ``binnings_fn(params, cams) -> per-view Binning list`` and
    ``binned_render_fn(rv, cam, binning)``, each view is binned once at the
    segment's entry from the entry state, and every step packs its current
    values along its view's frozen permutation (``raster.track_rebin_freq``
    caps the segment length, so the staleness).
    """
    step_impl = _build_step_impl(
        quadruples, umbrellas, render_fn, num_vertices, ring_indices, device, binned_render_fn
    )
    freeze = binnings_fn is not None and binned_render_fn is not None

    def multi_step(state, images, cams, view_ids, priors, constraints, lr, weights, phase):
        binnings = binnings_fn(state.params, cams) if freeze else None
        losses = []
        for vid in view_ids:
            vid = int(vid)
            state, priors, m = step_impl(
                state, images[vid], cams, vid, priors, constraints, lr, weights, phase,
                with_metrics=False, binning=None if binnings is None else binnings[vid],
            )
            losses.append(m["loss_total"])
        return state, priors, torch.stack(losses)

    return multi_step
