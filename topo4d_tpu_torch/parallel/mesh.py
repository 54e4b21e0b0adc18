"""The view mesh and the collectives of the multi-rank paths
(``parallel/mesh.py``).

The camera rig is the first parallel axis: a batched step's views are
independent given the summed-gradient rule, so each rank of the view mesh
renders a contiguous block of them, and the Gaussian parameters stay
replicated: every rank holds the same bits after every step. The mesh spans
the first ``n`` ranks of the world; with a view count that ``n`` divides,
``n`` is the largest such count up to the world size (24 views on 5 ranks:
4). Ranks outside it hold no views but join every collective with zeros.

The collectives are ``all_reduce`` (SUM, MAX) and ``broadcast`` only: gloo
takes no other collective on CUDA tensors, and ranks that share one card
run on gloo. ``AllReduceSum`` and ``SumGradAcrossRanks`` carry the two
halves of shard_map's transpose: a replicated output's cotangent stays with
each rank, a replicated input's cotangents sum over the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from topo4d_tpu_torch.core.camera import Camera
from topo4d_tpu_torch.pipeline.checkpoint import tree_map


@dataclasses.dataclass(frozen=True)
class ViewMesh:
    """The first ``size`` ranks of the world hold the views; this process is
    ``rank`` and runs on ``device``. ``group`` None is the default process
    group."""

    size: int
    rank: int
    device: torch.device
    group: Optional[object] = None

    @property
    def holds_views(self) -> bool:
        return self.rank < self.size

    def block(self, num_views: int):
        """(first view, view count) of this rank's contiguous block."""
        if num_views % self.size:
            raise ValueError(f"{num_views} views do not divide over a view mesh of {self.size} ranks")
        per = num_views // self.size
        return (self.rank * per, per) if self.holds_views else (0, 0)


def mesh_size(num_views: int, world: int) -> int:
    """The largest rank count up to ``world`` that divides ``num_views``
    (``pipeline/trainer.py:206-218``)."""
    n = world
    while n > 1 and num_views % n:
        n -= 1
    return n


def make_view_mesh(n: Optional[int] = None, device="cuda", group=None) -> ViewMesh:
    """A view mesh over the first ``n`` ranks (default: all) of the
    initialized process group, this rank on ``device``."""
    if not dist.is_initialized():
        raise RuntimeError("a view mesh needs an initialized process group (initialize_multihost)")
    world = dist.get_world_size(group)
    n = world if n is None else n
    if not 1 <= n <= world:
        raise ValueError(f"a view mesh of {n} ranks does not fit a world of {world}")
    return ViewMesh(size=n, rank=dist.get_rank(group), device=torch.device(device), group=group)


def shard_view_batch(mesh: ViewMesh, batch):
    """This rank's contiguous block of the leading view axis of ``batch`` (a
    tensor, a ``Camera`` or a nest of them), on the mesh's device."""
    if isinstance(batch, Camera):
        v = int(batch.fx.shape[0])
        off, cnt = mesh.block(v)
        return _camera_to(batch[off : off + cnt], mesh.device)
    if isinstance(batch, torch.Tensor):
        off, cnt = mesh.block(batch.shape[0])
        return batch[off : off + cnt].to(mesh.device)
    return tree_map(lambda x: shard_view_batch(mesh, x), batch)


def _camera_to(cams: Camera, device) -> Camera:
    return dataclasses.replace(
        cams, w2c=cams.w2c.to(device), fx=cams.fx.to(device), fy=cams.fy.to(device), cx=cams.cx.to(device),
        cy=cams.cy.to(device),
    )


def replicated(mesh: ViewMesh, tree):
    """``tree`` with every tensor replaced by rank 0's copy (a broadcast),
    on the mesh's device, contiguous (NCCL broadcasts no other layout)."""

    def bcast(x):
        if not isinstance(x, torch.Tensor):
            return x
        y = x.detach().to(mesh.device).clone(memory_format=torch.contiguous_format)
        dist.broadcast(y, src=0, group=mesh.group)
        return y

    return tree_map(bcast, tree)


def all_reduce_flat(tensors: Sequence[torch.Tensor], group=None) -> List[torch.Tensor]:
    """SUM over the ranks of each tensor (one collective over a flat buffer
    of all of them) -> new tensors of the same shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return [f.view_as(t) for f, t in zip(torch.split(flat, [t.numel() for t in tensors]), tensors)]


class AllReduceSum(torch.autograd.Function):
    """SUM over the ranks in the forward; the cotangent of the replicated
    sum stays with each rank in the backward (psum's transpose in
    shard_map)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class SumGradAcrossRanks(torch.autograd.Function):
    """Identity in the forward; the SUM over the ranks of the cotangent in
    the backward: the gradient of an input that every rank holds replicated
    and uses for its own share of the work."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class AssembleRows(torch.autograd.Function):
    """Each rank's rows ``local`` written at ``offset`` of a zero-filled
    (``rows``, ...) buffer, summed over the ranks: the blocks of one array
    that the ranks computed apart. Each row has one writer, so the sum is
    exact. The backward hands each rank its own rows of the cotangent."""

    @staticmethod
    def forward(ctx, local, offset: int, rows: int, group):
        buf = local.new_zeros((rows,) + tuple(local.shape[1:]))
        buf[offset : offset + local.shape[0]] = local
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        ctx.span = (offset, local.shape[0])
        return buf

    @staticmethod
    def backward(ctx, g):
        off, n = ctx.span
        return g[off : off + n], None, None, None
