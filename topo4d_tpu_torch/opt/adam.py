"""Adam with per-parameter learning rates given on every step (opt/adam.py).

torch.optim.Adam semantics (the reference optimizer: eps 1e-15 outside the
sqrt, default betas), with learning rates as a per-step input and per-leaf
step counts so the per-frame moment reset (external.py:126-138) is exact.
Step counts and learning rates are host numbers: the bias corrections are
host scalars and a step moves nothing from the host to the card.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch


class AdamState(NamedTuple):
    step: Dict[str, int]  # per-leaf step count
    mu: Dict[str, torch.Tensor]  # first moment
    nu: Dict[str, torch.Tensor]  # second moment


def adam_init(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(
        step={k: 0 for k in params},
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
    )


@torch.no_grad()
def adam_update(
    params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    state: AdamState,
    lr: Dict[str, float],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
):
    """One Adam step -> (new_params, new_state).

    new_p = p - (lr / (1 - b1^t)) * mu / (sqrt(nu / (1 - b2^t)) + eps).
    """
    new_p, mu, nu, step = {}, {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        t = state.step[k] + 1
        mu[k] = b1 * state.mu[k] + (1.0 - b1) * g
        nu[k] = b2 * state.nu[k] + (1.0 - b2) * (g * g)
        scale = float(lr[k]) / (1.0 - b1**t)
        denom_corr = 1.0 / (1.0 - b2**t)
        new_p[k] = p - scale * mu[k] / (torch.sqrt(nu[k] * denom_corr) + eps)
        step[k] = t
    return new_p, AdamState(step=step, mu=mu, nu=nu)


def reset_moments(state: AdamState, keys) -> AdamState:
    """Zero first/second moments for ``keys``, keep step counts
    (the reference's per-timestep optimizer surgery, train.py:434-435)."""
    mu = dict(state.mu)
    nu = dict(state.nu)
    for k in keys:
        mu[k] = torch.zeros_like(mu[k])
        nu[k] = torch.zeros_like(nu[k])
    return AdamState(step=dict(state.step), mu=mu, nu=nu)
