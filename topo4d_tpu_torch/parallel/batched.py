"""The view-batched geometry step (``parallel/batched.py``).

The reference optimizes one random view per Adam step. The batched mode
(``schedule.views_per_step == 0``) renders every view in one step, takes
the mean of the per-view photometric losses, adds the topological terms
once and applies one Adam step and the constraint writes: a deliberate
semantic change of the JAX package, the scaling mode its README documents.
The gradient is the photometric terms' plus the topological terms'.

On one card, views render one after another through ``render_fn`` (the JAX
package's ``sequential_views`` path), or all at once through
``multiview_render_fn`` (``schedule.fuse_views``: one K1 and one K2 launch
per step). With a view ``mesh`` (``parallel/mesh.py``) each rank renders its
own block of the views (``parallel/sharded.py``) and the step sums the
ranks' photometric gradients, rank 0's with the topological terms, in one
``all_reduce``: every rank then takes the same Adam step on the same bits.
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
from topo4d_tpu_torch.opt.step import GeometryPriors, TrainState, apply_gradients, build_topo_losses
from topo4d_tpu_torch.parallel.mesh import ViewMesh, all_reduce_flat
from topo4d_tpu_torch.parallel.sharded import local_view_sums, make_sharded_view_loss


def _grads(loss: torch.Tensor, params: Dict[str, torch.Tensor], retain: bool) -> Dict[str, torch.Tensor]:
    """d loss / d params, zero for the leaves it does not reach."""
    if not loss.requires_grad:
        return {k: torch.zeros_like(p) for k, p in params.items()}
    g = torch.autograd.grad(loss, list(params.values()), retain_graph=retain, allow_unused=True)
    return {k: gk if gk is not None else torch.zeros_like(p) for (k, p), gk in zip(params.items(), g)}


def _build_batched_step_impl(
    quadruples: Dict[str, DihedralQuadruples],
    umbrellas: Dict[str, UmbrellaFlatten],
    render_fn: Callable,
    num_vertices: int,
    ring_indices: Optional[np.ndarray] = None,
    device="cuda",
    binned_render_fn: Optional[Callable] = None,
    multiview_render_fn: Optional[Callable] = None,
    mesh: Optional[ViewMesh] = None,
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
    taken. With a ``mesh``, ``images`` and ``cams`` are this rank's block
    of the views (``shard_view_batch``) and binnings are not taken
    (``:65-76``).
    """
    topo = build_topo_losses(quadruples, umbrellas, num_vertices, ring_indices, device)
    sharded_loss = make_sharded_view_loss(render_fn, mesh) if mesh is not None else None

    def per_view_losses(params, rv, images, cams, binnings, with_metrics):
        if sharded_loss is not None:
            return sharded_loss(params, rv, images, cams, with_metrics)
        v = images.shape[0]
        n = torch.tensor(float(v), dtype=torch.float32, device=images.device)
        if multiview_render_fn is not None:
            out = multiview_render_fn(rv, cams)
            im = torch.exp(params["cam_m"][:v])[:, :, None, None] * out.image + params["cam_c"][:v][:, :, None, None]
            losses = torch.stack([photometric_loss(im[i], images[i]) for i in range(v)])
            mean_psnr = None
            if with_metrics:
                with torch.no_grad():
                    mean_psnr = torch.sum(torch.stack([torch.mean(psnr(im[i].detach(), images[i])) for i in range(v)])) / n
            return torch.sum(losses) / n, mean_psnr, torch.amax(out.radii, dim=0)
        photo, psnr_sum, radii = local_view_sums(
            render_fn, params, rv, images, cams, 0, with_metrics, binnings, binned_render_fn
        )
        return photo / n, psnr_sum / n if with_metrics else None, radii

    def step_impl(
        state: TrainState,
        images: torch.Tensor,  # (V, 3, H, W), or this rank's block of them
        cams: Camera,  # batched, V views (or the block)
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
        topo_total = sum(weights[k] * v for k, v in losses.items() if k in weights) + pre_weighted
        losses["im"] = im_loss
        losses["flatten"] = pre_weighted  # already weight-scaled
        total = weights["im"] * im_loss + topo_total
        # the photometric gradient, then the topological terms': once, on
        # one rank of a mesh; a mesh sums the ranks' gradients
        grads = _grads(weights["im"] * im_loss, params, retain=True)
        if mesh is None or mesh.rank == 0:
            g_topo = _grads(topo_total, params, retain=False)
            grads = {k: grads[k] + g_topo[k] for k in grads}
        if mesh is not None:
            grads = dict(zip(grads, all_reduce_flat(list(grads.values()), mesh.group)))
        new_state = apply_gradients(state, grads, max_radii, constraints, lr)
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
    mesh: Optional[ViewMesh] = None,
) -> Callable:
    """The all-views step (``parallel/batched.py:174``): ``step(state,
    images, cams, priors, constraints, lr, weights, phase) -> (state,
    priors, metrics)``, metrics with the mean PSNR over the views. With
    ``multiview_render_fn`` all views render in one fused call; with a view
    ``mesh``, ``images`` and ``cams`` are this rank's block of the views and
    the results are replicated over the ranks."""
    if mesh is not None and multiview_render_fn is not None:
        raise ValueError("a view mesh renders its local views one after another; fused views are single-card")
    return _build_batched_step_impl(
        quadruples, umbrellas, render_fn, num_vertices, ring_indices, device,
        multiview_render_fn=multiview_render_fn, mesh=mesh,
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
