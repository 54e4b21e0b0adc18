"""Post-step region constraint writes (opt/constraints.py).

The reference hard-writes region attributes after every optimizer step
(train.py:619-700). Ordered scatter writes are merged on the host into one
masked select per parameter (``compile_dense_constraints``, the form the
trainer runs); ``apply_constraints`` also applies the scatters themselves.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from topo4d_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ScatterConstraint:
    """params[param][idx] = value, applied after the optimizer step."""

    idx: np.ndarray  # (M,) int, host
    value: Union[np.ndarray, torch.Tensor]  # (M, C) or broadcastable
    param: str


@dataclasses.dataclass(frozen=True)
class DenseConstraint:
    """params[param] = where(mask, value, params[param])."""

    mask: torch.Tensor  # (N, 1) bool
    value: torch.Tensor  # (N, C)
    param: str


def compile_dense_constraints(
    params_like: Dict[str, np.ndarray],
    constraints: Sequence[ScatterConstraint],
    device="cuda",
) -> List[DenseConstraint]:
    """Merge ordered ScatterConstraints into one DenseConstraint per param.

    Later writes to the same index win, preserving apply order.
    """
    dev = resolve_device(device)
    acc: Dict[str, tuple] = {}
    order: list = []
    for c in constraints:
        shape = tuple(params_like[c.param].shape)
        if c.param not in acc:
            acc[c.param] = (np.zeros((shape[0], 1), bool), np.zeros(shape, np.float32))
            order.append(c.param)
        mask, val = acc[c.param]
        idx = np.asarray(c.idx, np.int64)
        mask[idx] = True
        val[idx] = np.asarray(c.value)
    return [
        DenseConstraint(
            mask=torch.as_tensor(acc[k][0], device=dev),
            value=torch.as_tensor(acc[k][1], device=dev),
            param=k,
        )
        for k in order
    ]


@torch.no_grad()
def apply_constraints(
    params: Dict[str, torch.Tensor], constraints: Sequence[Union[DenseConstraint, ScatterConstraint]]
) -> Dict[str, torch.Tensor]:
    """The writes in order: a DenseConstraint as a masked select, a
    ScatterConstraint as an indexed write."""
    out = dict(params)
    for c in constraints:
        if isinstance(c, ScatterConstraint):
            p = out[c.param]
            idx = torch.as_tensor(np.asarray(c.idx, np.int64), device=p.device)
            out[c.param] = p.index_put((idx,), torch.as_tensor(c.value, dtype=p.dtype, device=p.device))
            continue
        mask = c.mask
        # an (N, 1) mask against an (N,) param would broadcast to (N, N)
        while mask.dim() > out[c.param].dim():
            mask = mask[..., 0]
        out[c.param] = torch.where(mask, c.value, out[c.param])
    return out


def constant_constraint(param: str, idx: np.ndarray, value, shape_like: torch.Tensor) -> ScatterConstraint:
    """A constraint writing the scalar ``value`` to params[param][idx], in
    ``shape_like``'s dtype and on its device."""
    idx = np.asarray(idx, np.int32)
    val = torch.full((idx.shape[0],) + tuple(shape_like.shape[1:]), value, dtype=shape_like.dtype,
                     device=shape_like.device)
    return ScatterConstraint(param=param, idx=idx, value=val)


def inverse_sigmoid(x: float) -> float:
    return float(np.log(x / (1.0 - x)))
