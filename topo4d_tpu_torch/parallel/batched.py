"""The view-batched geometry step (``parallel/batched.py``), single device.

The reference optimizes one random view per Adam step. The batched mode
(``schedule.views_per_step == 0``) renders every view in one step, takes
the mean of the per-view photometric losses (one backward through all of
them), adds the topological terms once and applies one Adam step and the
constraint writes: a deliberate semantic change of the JAX package, the
scaling mode its README documents.

Views render one after another through ``render_fn`` (the JAX package's
``sequential_views`` path), or all at once through ``multiview_render_fn``
(``schedule.fuse_views``: one K1 and one K2 launch per step). The JAX
``mesh`` path (views sharded over devices) is not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from topo4d_tpu_torch.core.camera import Camera
from topo4d_tpu_torch.core.gaussian import activate_params
from topo4d_tpu_torch.losses.flatten import DihedralQuadruples, UmbrellaFlatten
from topo4d_tpu_torch.losses.image import photometric_loss, psnr
from topo4d_tpu_torch.opt.constraints import DenseConstraint
from topo4d_tpu_torch.opt.step import GeometryPriors, TrainState, build_topo_losses, update_state


def _build_batched_step_impl(
    quadruples: Dict[str, DihedralQuadruples],
    umbrellas: Dict[str, UmbrellaFlatten],
    render_fn: Callable,
    num_vertices: int,
    ring_indices: Optional[np.ndarray] = None,
    device="cuda",
    binned_render_fn: Optional[Callable] = None,
    multiview_render_fn: Optional[Callable] = None,
) -> Callable:
    """The all-views step body (``parallel/batched.py:33``).

    ``step_impl(state, images, cams, priors, constraints, lr, weights,
    phase, binnings=None, with_metrics=True)`` renders every view of
    ``images`` (V, 3, H, W) with its ``cam_m``/``cam_c`` exposure (through
    ``binned_render_fn(rv, cam, binnings[v])`` when per-view frozen
    binnings are given), takes the mean of the per-view photometric losses
    and of the per-view mean PSNRs and the max of the radii over the views,
    adds the topological terms once, and applies Adam and the constraints.
    With ``multiview_render_fn(rv, cams)`` (batched leaves) every view
    renders in one call instead (``:79-89``), and frozen binnings are not
    taken.
    """
    topo = build_topo_losses(quadruples, umbrellas, num_vertices, ring_indices, device)

    def per_view_losses(params, rv, images, cams, binnings, with_metrics):
        if multiview_render_fn is not None:
            out = multiview_render_fn(rv, cams)
            v = images.shape[0]
            im = torch.exp(params["cam_m"][:v])[:, :, None, None] * out.image + params["cam_c"][:v][:, :, None, None]
            losses = torch.stack([photometric_loss(im[i], images[i]) for i in range(v)])
            mean_psnr = None
            if with_metrics:
                with torch.no_grad():
                    mean_psnr = torch.mean(torch.stack([torch.mean(psnr(im[i].detach(), images[i])) for i in range(v)]))
            return torch.mean(losses), mean_psnr, torch.amax(out.radii, dim=0)
        losses, psnrs, radii = [], [], None
        for v in range(images.shape[0]):
            cam = cams[v]
            out = render_fn(rv, cam) if binnings is None else binned_render_fn(rv, cam, binnings[v])
            im = torch.exp(params["cam_m"][v])[:, None, None] * out.image + params["cam_c"][v][:, None, None]
            losses.append(photometric_loss(im, images[v]))
            if with_metrics:
                with torch.no_grad():
                    psnrs.append(torch.mean(psnr(im.detach(), images[v])))
            radii = out.radii if radii is None else torch.maximum(radii, out.radii)
        mean_psnr = torch.mean(torch.stack(psnrs)) if with_metrics else None
        return torch.mean(torch.stack(losses)), mean_psnr, radii

    def step_impl(
        state: TrainState,
        images: torch.Tensor,  # (V, 3, H, W)
        cams: Camera,  # batched, V views
        priors: GeometryPriors,
        constraints: Sequence[DenseConstraint],
        lr: Dict[str, float],
        weights: Dict[str, float],
        phase: str,
        binnings=None,  # per-view frozen Binning list, or None
        with_metrics: bool = True,
    ) -> Tuple[TrainState, GeometryPriors, Dict[str, torch.Tensor]]:
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        rv = activate_params(params)
        im_loss, mean_psnr, max_radii = per_view_losses(params, rv, images, cams, binnings, with_metrics)
        losses, new_cos, pre_weighted = topo(rv, priors, weights, phase)
        losses["im"] = im_loss
        losses["flatten"] = pre_weighted  # already weight-scaled
        total = sum(weights[k] * v for k, v in losses.items() if k in weights) + pre_weighted
        new_state = update_state(state, params, total, max_radii, constraints, lr)
        metrics = {("loss_" + k): v.detach() for k, v in losses.items()}
        metrics["loss_total"] = total.detach()
        if with_metrics:
            metrics["psnr"] = mean_psnr
        return new_state, priors._replace(cos_init=new_cos), metrics

    return step_impl


def make_batched_geometry_step(
    quadruples: Dict[str, DihedralQuadruples],
    umbrellas: Dict[str, UmbrellaFlatten],
    render_fn: Callable,
    num_vertices: int,
    ring_indices: Optional[np.ndarray] = None,
    device="cuda",
    multiview_render_fn: Optional[Callable] = None,
) -> Callable:
    """The all-views step (``parallel/batched.py:174``): ``step(state,
    images, cams, priors, constraints, lr, weights, phase) -> (state,
    priors, metrics)``, metrics with the mean PSNR over the views. With
    ``multiview_render_fn`` all views render in one fused call."""
    return _build_batched_step_impl(
        quadruples, umbrellas, render_fn, num_vertices, ring_indices, device, multiview_render_fn=multiview_render_fn
    )


def make_batched_geometry_multi_step(
    quadruples: Dict[str, DihedralQuadruples],
    umbrellas: Dict[str, UmbrellaFlatten],
    render_fn: Callable,
    num_vertices: int,
    ring_indices: Optional[np.ndarray] = None,
    binned_render_fn: Optional[Callable] = None,
    binnings_fn: Optional[Callable] = None,
    device="cuda",
) -> Callable:
    """A segment of identically configured all-views steps
    (``parallel/batched.py:191``).

    ``multi_step(state, images, cams, priors, constraints, lr, weights,
    phase, num_steps) -> (state, priors, loss_total (num_steps,))``: the
    same steps as looping the batched step (without its PSNR). With
    ``binnings_fn(params, cams)`` and ``binned_render_fn``, each view is
    binned once at the segment's entry and every step renders along those
    frozen permutations.
    """
    step_impl = _build_batched_step_impl(
        quadruples, umbrellas, render_fn, num_vertices, ring_indices, device, binned_render_fn
    )
    freeze = binnings_fn is not None and binned_render_fn is not None

    def multi_step(state, images, cams, priors, constraints, lr, weights, phase, num_steps: int):
        binnings = binnings_fn(state.params, cams) if freeze else None
        losses = []
        for _ in range(num_steps):
            state, priors, m = step_impl(
                state, images, cams, priors, constraints, lr, weights, phase, binnings, with_metrics=False
            )
            losses.append(m["loss_total"])
        return state, priors, torch.stack(losses)

    return multi_step
