"""Adaptive densification (clone, split, prune) in a fixed capacity
(``opt/densify.py``).

The reference inherits Dynamic3DGaussians' densification
(external.py:119-331) and never calls it from train.py (SURVEY §1): the
mesh-bound Gaussians keep their count. It is kept for parity with the JAX
package, in its design: the Gaussians live in a buffer of fixed capacity
with an ``alive`` mask, clones and split children are written into free
slots (the k-th request into the k-th free slot), prunes clear the mask,
and requests past the free slots are dropped and counted (``overflow``).
The thresholds are the reference's (external.py:184-232): densify where the
mean screen-space gradient norm reaches ``grad_thresh``, clone the small
Gaussians and split the large into ``split_n`` children drawn inside the
parent and scaled by 1 / (0.8 n), prune by opacity and size.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from topo4d_tpu_torch.core.quaternion import quat_to_rotmat

PARAM_KEYS = ("means3D", "rgb_colors", "unnorm_rotations", "logit_opacities", "log_scales")


class DensifyState(NamedTuple):
    alive: torch.Tensor  # (N_cap,) bool
    grad_accum: torch.Tensor  # (N_cap,) accumulated means2D gradient norms
    denom: torch.Tensor  # (N_cap,) accumulation counts
    max_radius: torch.Tensor  # (N_cap,) float


def densify_init(n_alive: int, capacity: int, device="cuda") -> DensifyState:
    from topo4d_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    z = torch.zeros(capacity, dtype=torch.float32, device=dev)
    return DensifyState(alive=torch.arange(capacity, device=dev) < n_alive, grad_accum=z, denom=z, max_radius=z)


def pad_params(params: Dict[str, torch.Tensor], capacity: int) -> Dict[str, torch.Tensor]:
    """The parameters of ``PARAM_KEYS`` grown with zero rows to ``capacity``."""
    out = dict(params)
    for k in PARAM_KEYS:
        v = params[k]
        out[k] = torch.cat([v, v.new_zeros((capacity - v.shape[0],) + tuple(v.shape[1:]))], dim=0)
    return out


def accumulate_stats(
    state: DensifyState, means2d_grad: torch.Tensor, seen: torch.Tensor, radii: Optional[torch.Tensor] = None
) -> DensifyState:
    """Add the screen-space gradient norms of the alive, seen Gaussians
    (external.py:119-123) and keep their largest 2D radius (the reference's
    ``max_2D_radius``, train.py:373-376)."""
    norm = torch.linalg.vector_norm(means2d_grad[:, :2], dim=-1)
    upd = seen & state.alive
    max_radius = state.max_radius
    if radii is not None:
        max_radius = torch.where(upd, torch.maximum(max_radius, radii.to(torch.float32)), max_radius)
    return state._replace(
        grad_accum=torch.where(upd, state.grad_accum + norm, state.grad_accum),
        denom=torch.where(upd, state.denom + 1.0, state.denom),
        max_radius=max_radius,
    )


@torch.no_grad()
def densify_step(
    params: Dict[str, torch.Tensor],
    state: DensifyState,
    generator: Optional[torch.Generator],
    scene_radius: float,
    grad_thresh: float = 2e-4,
    prune_opacity: float = 0.005,
    split_n: int = 2,
    opt=None,
    noise: Optional[torch.Tensor] = None,
):
    """One clone, split and prune pass inside the fixed capacity.

    Returns (params, state, stats), or (params, opt, state, stats) when an
    ``AdamState`` is passed: every slot written gets zero moments, as the
    reference's optimizer surgery gives new points (external.py:126-181);
    step counts stay. ``stats`` counts ``clones``, ``splits``, ``prunes``,
    ``alive`` and ``overflow``, the requests dropped for want of a free slot.
    Slots freed in this pass take requests: children read their sources
    from the arrays as they were.

    The split children's offsets are standard normals times the parent's
    scales, rotated into its frame: ``noise`` (split_n, N_cap, 3) when given
    (the JAX package's ``jax.random.normal`` draws, for a test), else drawn
    from ``generator``.
    """
    cap = state.alive.shape[0]
    dev = state.alive.device
    grads = torch.where(state.denom > 0, state.grad_accum / state.denom, torch.zeros_like(state.grad_accum))
    scales = torch.exp(params["log_scales"])
    max_scale = torch.max(scales, dim=1).values

    hot = state.alive & (grads >= grad_thresh)
    to_clone = hot & (max_scale <= 0.01 * scene_radius)
    to_split = hot & (max_scale > 0.01 * scene_radius)
    opacity = torch.sigmoid(params["logit_opacities"][:, 0])
    to_prune = state.alive & ((opacity < prune_opacity) | (max_scale > 0.1 * scene_radius))

    # each clone asks for one slot, each split for split_n (its parent goes)
    want = to_clone.to(torch.int64) + to_split.to(torch.int64) * split_n
    free = ~state.alive | to_prune | to_split
    n_free = torch.sum(free)
    req_rank = torch.cumsum(want, 0) - want  # exclusive prefix of the requests
    free_idx = torch.full((cap,), cap, dtype=torch.int64, device=dev)
    slots = torch.nonzero(free).flatten()
    free_idx[: slots.shape[0]] = slots
    overflow = torch.sum(torch.minimum(want, torch.clamp(req_rank + want - n_free, min=0)))

    new_params = dict(params)
    new_alive = state.alive & ~to_prune & ~to_split
    mu = dict(opt.mu) if opt is not None else None
    nu = dict(opt.nu) if opt is not None else None

    def place(child: int, src_mask, jitter):
        """Copies of the masked sources written into their free slots."""
        nonlocal new_alive
        offs = req_rank + child
        ok = src_mask & (offs < n_free)
        dst = free_idx[torch.clamp(offs, max=cap - 1)][ok]
        for k in PARAM_KEYS:
            val = params[k] + jitter[k] if k in jitter else params[k] + 0.0
            new_params[k] = new_params[k].clone()
            new_params[k][dst] = val[ok]
            if opt is not None:  # a reused slot takes no moments of its last occupant
                for m in (mu, nu):
                    m[k] = m[k].clone()
                    m[k][dst] = 0.0
        new_alive = new_alive.clone()
        new_alive[dst] = True

    place(0, to_clone, {})  # clones: exact copies (external.py:191-194)
    rots = quat_to_rotmat(params["unnorm_rotations"])
    shrink = torch.log(torch.tensor(1.0 / (0.8 * split_n), dtype=torch.float32, device=dev))
    for child in range(split_n):  # splits (external.py:199-210)
        if noise is not None:
            eps = noise[child].to(dev)
        else:
            eps = torch.randn(params["means3D"].shape, generator=generator, device=dev)
        offset = torch.einsum("nij,nj->ni", rots, eps * torch.exp(params["log_scales"]))
        place(child, to_split, {"means3D": offset, "log_scales": shrink * torch.ones_like(params["log_scales"])})

    stats = {
        "clones": torch.sum(to_clone), "splits": torch.sum(to_split), "prunes": torch.sum(to_prune),
        "overflow": overflow, "alive": torch.sum(new_alive),
    }
    z = torch.zeros(cap, dtype=torch.float32, device=dev)
    new_state = DensifyState(alive=new_alive, grad_accum=z, denom=z, max_radius=z)
    if opt is not None:
        return new_params, opt._replace(mu=mu, nu=nu), new_state, stats
    return new_params, new_state, stats


def reset_opacity(params: Dict[str, torch.Tensor], value: float = 0.01) -> Dict[str, torch.Tensor]:
    """Cap every opacity at ``value`` (external.py:228-230)."""
    logit = float(np.log(value / (1 - value)))
    return {**params, "logit_opacities": torch.clamp(params["logit_opacities"], max=logit)}
