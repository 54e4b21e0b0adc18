"""Per-frame dense attribute interpolation (topology/interpolate.py).

``dense_attr = concat(attr, sum_k w_k * attr[quad[father, k]])``: a gather
and a weighted sum on the attribute's device, in place of the reference's
host round trip (helpers.py:237-253, train.py:504-506).
"""

from __future__ import annotations

import torch


def interpolate_dense_attribute(
    attr: torch.Tensor,  # (V, C) base-vertex attribute
    quad_faces: torch.Tensor,  # (F, 4) frontal quads (vertex ids)
    father_face: torch.Tensor,  # (P,) new point -> frontal quad index
    weights: torch.Tensor,  # (P, 4) bilinear weights
) -> torch.Tensor:
    """-> (V + P, C): the base attributes, then the interpolated ones."""
    corners = attr[quad_faces.long()[father_face.long()]]  # (P, 4, C)
    new = torch.einsum("pk,pkc->pc", weights.to(attr.dtype), corners)
    return torch.cat([attr, new], dim=0)
