"""The view-sharded photometric loss (``parallel/sharded.py``).

Each rank of a view mesh renders its local views one after another through
``render_fn`` (K1/K2 per view on the card, K5 in each view's SSIM), sums
their photometric losses and PSNRs, and one ``all_reduce`` (SUM) over the
ranks gives the replicated mean over all views; the radii take an
``all_reduce`` (MAX), JAX's ``pmax``. The loss is differentiable with
shard_map's transpose: its cotangent stays with each rank, whose gradient
is then its own views' share. The step sums the ranks' shares
(``parallel/batched.py``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from topo4d_tpu_torch.core.camera import Camera
from topo4d_tpu_torch.losses.image import photometric_loss, psnr
from topo4d_tpu_torch.parallel.mesh import AllReduceSum, ViewMesh


def local_view_sums(
    render_fn: Callable,
    params,
    rv,
    images: torch.Tensor,  # (v, 3, H, W)
    cams: Camera,  # batched, v views
    first_view: int = 0,
    with_metrics: bool = True,
    binnings=None,
    binned_render_fn: Optional[Callable] = None,
):
    """Render views ``0..v-1`` (global views ``first_view + i``, whose
    ``cam_m``/``cam_c`` exposures they take) -> (sum of their photometric
    losses, sum of their mean PSNRs or None, the max of their radii). With
    per-view frozen ``binnings`` each view renders through
    ``binned_render_fn(rv, cam, binnings[i])``."""
    losses, psnrs, radii = [], [], None
    for i in range(images.shape[0]):
        cam = cams[i]
        out = render_fn(rv, cam) if binnings is None else binned_render_fn(rv, cam, binnings[i])
        v = first_view + i
        im = torch.exp(params["cam_m"][v])[:, None, None] * out.image + params["cam_c"][v][:, None, None]
        losses.append(photometric_loss(im, images[i]))
        if with_metrics:
            with torch.no_grad():
                psnrs.append(torch.mean(psnr(im.detach(), images[i])))
        radii = out.radii if radii is None else torch.maximum(radii, out.radii)
    return torch.sum(torch.stack(losses)), torch.sum(torch.stack(psnrs)) if with_metrics else None, radii


def make_sharded_view_loss(render_fn: Callable, mesh: ViewMesh) -> Callable:
    """``fn(params, rv, images, cams, with_metrics=True) -> (loss, mean
    psnr, max radii)`` (``parallel/sharded.py:26``).

    ``images``/``cams`` are this rank's block of the views
    (``shard_view_batch``); the results are replicated: the mean loss and
    PSNR over every rank's views (the PSNR 0 without metrics) and the
    per-Gaussian max radii over all of them. A rank outside the mesh joins
    with zeros. ``rv`` must be this rank's activation of ``params``.
    """

    def sharded(params, rv, images, cams, with_metrics: bool = True):
        dev = rv.means3d.device
        count = images.shape[0]
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        if count:
            photo, psnr_sum, radii = local_view_sums(
                render_fn, params, rv, images, cams, mesh.rank * count, with_metrics
            )
            psnr_sum = psnr_sum if with_metrics else zero
        else:
            photo, psnr_sum = zero, zero
            radii = torch.zeros(rv.means3d.shape[0], dtype=torch.int32, device=dev)
        n = torch.tensor(float(count), dtype=torch.float32, device=dev)
        red = AllReduceSum.apply(torch.stack([photo, psnr_sum, n]), mesh.group)
        total_views = red[2].detach()
        radii = radii.clone()
        dist.all_reduce(radii, op=dist.ReduceOp.MAX, group=mesh.group)
        return red[0] / total_views, (red[1] / total_views).detach(), radii

    return sharded
