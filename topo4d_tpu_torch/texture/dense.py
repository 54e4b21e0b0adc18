"""Dense-Gaussian texture optimization (texture/dense.py).

The reference's texture loop (train.py:381-417, 715-743): a second, denser
Gaussian set sampled in UV space renders the full-resolution views; only
``dense_rgb_colors`` and ``dense_unnorm_rotations`` learn; the loss is
0.8 L1 + 0.2 (1 - SSIM) plus 0.02 times a soft L1 anchor to the previous
frame's colors; the static, dynamic and inner-mouth colors are zeroed
before every step. The dense means3D follow the tracked geometry each frame
(``topology.interpolate``) and take no gradient.

One step is eager PyTorch; the JAX package's scanned multi-step
(``make_texture_multi_step``) is a plain loop over this step with metrics
off. Under ``use_mask_dense`` the photometric term is the L1 over the
parsing mask's facial regions (``DENSE_MASK_LABELS``), without SSIM
(train.py:392-405). Under ``texture.remat_photometric`` the unmasked
photometric loss runs inside ``torch.utils.checkpoint``: its saved SSIM
maps are recomputed in the backward (one more K5 launch per step on the
card) instead of held, with the same values bit for bit.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.utils.checkpoint

from topo4d_tpu_torch.core.camera import Camera
from topo4d_tpu_torch.core.gaussian import GaussianRenderVars
from topo4d_tpu_torch.core.quaternion import quat_normalize
from topo4d_tpu_torch.losses.image import l1_abs, l1_loss_sum_last, photometric_loss, psnr
from topo4d_tpu_torch.opt.adam import AdamState, adam_update
from topo4d_tpu_torch.opt.constraints import DenseConstraint, apply_constraints
from topo4d_tpu_torch.pipeline.masks import get_mask
from topo4d_tpu_torch.rasterizer.tiles import Binning
from topo4d_tpu_torch.utils.profiling import span, traced

# facial regions kept in the masked dense loss (reference train.py:396-398)
DENSE_MASK_LABELS = (
    "skin", "l_eyebrow", "r_eyebrow", "nose", "upper_lip", "lower_lip",
    "l_ear", "r_ear", "hair",
)


class TextureState(NamedTuple):
    params: Dict[str, torch.Tensor]  # dense_* parameters
    opt: AdamState


def dense_rendervars(params: Dict[str, torch.Tensor], dense_means3d: torch.Tensor) -> GaussianRenderVars:
    """params2rendervar_dense (reference helpers.py:102-112): means frozen."""
    return GaussianRenderVars(
        means3d=dense_means3d.detach(),
        colors=params["dense_rgb_colors"],
        rotations=quat_normalize(params["dense_unnorm_rotations"]),
        opacities=torch.sigmoid(params["dense_logit_opacities"]).reshape(-1),
        scales=torch.exp(params["dense_log_scales"]),
    )


def make_texture_step(
    render_fn: Callable,
    use_mask: bool = False,
    cmap_index: Optional[Dict[str, int]] = None,
    remat: bool = False,
) -> Callable:
    """The single texture iteration: pre-step color zeroing -> render ->
    loss -> Adam (train.py:729-741).

    ``render_fn(rv, cam, binning) -> RenderOutput``; ``binning`` is a frozen
    per-view binning (``rasterizer.render.binning_for``) or None. Returns
    ``step(state, dense_means3d, gt, cams, view_id, anchor_colors,
    pre_constraints, lr, weights, binning, with_metrics, mask) -> (state,
    metrics)``; metrics are detached 0-d tensors (PSNR only
    ``with_metrics``), so a step reads nothing back from the card.

    ``use_mask`` (the reference's ``use_mask_dense``): the photometric term
    is the sum of |im - gt| over the pixels of ``DENSE_MASK_LABELS`` in the
    view's (3, H, W) parsing image ``mask`` (colors per ``cmap_index``)
    over max(their count, 1). ``remat`` (``texture.remat_photometric``):
    the unmasked photometric loss is recomputed in the backward instead of
    saving its intermediates (``texture/dense.py:87-93``).

    Under a profiler each step is the span ``dense.step``, and its parts the
    spans ``dense.constraints``, ``render.forward``, ``dense.loss``,
    ``dense.backward`` and ``dense.update`` (``utils/profiling.py``).
    """

    @traced("dense.step")
    def step(
        state: TextureState,
        dense_means3d: torch.Tensor,
        gt: torch.Tensor,  # (3, H, W)
        cams: Camera,
        view_id: int,
        anchor_colors: torch.Tensor,  # the previous frame's dense colors
        pre_constraints: Sequence[DenseConstraint],
        lr: Dict[str, float],
        weights: Dict[str, float],
        binning: Optional[Binning] = None,
        with_metrics: bool = True,
        mask: Optional[torch.Tensor] = None,  # (3, H, W) parsing image when use_mask
    ) -> Tuple[TextureState, Dict[str, torch.Tensor]]:
        with span("dense.constraints"):
            params = apply_constraints(state.params, pre_constraints)
        keys = list(params)
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        with span("render.forward"):
            out = render_fn(dense_rendervars(p, dense_means3d), cams[view_id], binning)
        with span("dense.loss"):
            if use_mask:
                m = get_mask(DENSE_MASK_LABELS, mask, cmap_index)
                im_loss = torch.sum(l1_abs((out.image - gt) * m)) / torch.clamp(torch.sum(m), min=1.0)
            elif remat:
                im_loss = torch.utils.checkpoint.checkpoint(
                    photometric_loss, out.image, gt, use_reentrant=False, preserve_rng_state=False
                )
            else:
                im_loss = photometric_loss(out.image, gt)
            losses = {
                "im": im_loss,
                "soft_color": l1_loss_sum_last(p["dense_rgb_colors"], anchor_colors),
            }
            total = sum(weights[k] * v for k, v in losses.items() if k in weights)
        with span("dense.backward"):
            g = torch.autograd.grad(total, [p[k] for k in keys], allow_unused=True)
            grads = {k: torch.zeros_like(p[k]) if gk is None else gk for k, gk in zip(keys, g)}
        with span("dense.update"):
            new_params, new_opt = adam_update(params, grads, state.opt, lr)
        with torch.no_grad():
            metrics = {("loss_" + k): v.detach() for k, v in losses.items()}
            metrics["loss_total"] = total.detach()
            # tiles dropped by a manual compact capacity (0 when sized right)
            metrics["num_tile_overflow"] = out.num_overflow
            if with_metrics:
                metrics["psnr"] = torch.mean(psnr(out.image.detach(), gt))
        return TextureState(params=new_params, opt=new_opt), metrics

    return step


def make_texture_eval(render_fn: Callable) -> Callable:
    """Mean PSNR of one view at the current dense params, without a step
    (the trainer's fixed-view ``tex_psnr_fixed``)."""

    @torch.no_grad()
    def eval_psnr(
        state: TextureState,
        dense_means3d: torch.Tensor,
        gt: torch.Tensor,
        cams: Camera,
        view_id: int,
        binning: Optional[Binning] = None,
    ) -> torch.Tensor:
        out = render_fn(dense_rendervars(state.params, dense_means3d), cams[view_id], binning)
        return torch.mean(psnr(out.image, gt))

    return eval_psnr


def make_texture_multi_step(
    render_fn: Callable,
    use_mask: bool = False,
    cmap_index: Optional[Dict[str, int]] = None,
    remat: bool = False,
) -> Callable:
    """A run of texture iterations (``texture/dense.py:183``): the step of
    ``make_texture_step`` looped with metrics off.

    Returns ``multi_step(state, dense_means3d, images, cams, view_ids,
    anchor_colors, pre_constraints, lr, weights, binnings=None, masks=None)
    -> (state, losses)``: ``images`` (V, 3, H, W), ``view_ids`` the
    iterations' views, ``binnings`` one frozen binning per view or None,
    ``masks`` (V, 3, H, W) parsing images when ``use_mask``; ``losses`` the
    (S,) stacked ``loss_total`` values, on the card.
    """
    step = make_texture_step(render_fn, use_mask, cmap_index, remat)

    def multi_step(
        state: TextureState,
        dense_means3d: torch.Tensor,
        images: torch.Tensor,
        cams: Camera,
        view_ids: Sequence[int],
        anchor_colors: torch.Tensor,
        pre_constraints: Sequence[DenseConstraint],
        lr: Dict[str, float],
        weights: Dict[str, float],
        binnings: Optional[Sequence[Optional[Binning]]] = None,
        masks: Optional[torch.Tensor] = None,
    ) -> Tuple[TextureState, torch.Tensor]:
        losses = []
        for v in view_ids:
            v = int(v)
            state, m = step(
                state, dense_means3d, images[v], cams, v, anchor_colors, pre_constraints, lr, weights,
                None if binnings is None else binnings[v], with_metrics=False,
                mask=None if masks is None else masks[v],
            )
            losses.append(m["loss_total"])
        return state, torch.stack(losses)

    return multi_step
