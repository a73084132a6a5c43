"""The collectives of the model ('model', tensor-parallel) axis, as
autograd functions: what GSPMD inserts around the JAX package's sharded
weights (transception_tpu/parallel/mesh.py:62-120), written out.

A column-parallel product takes its input through `copy` (the identity;
the backward sums the ranks' partial input gradients), a row-parallel one
gives its fp32 partial to `reduce` (the sum over the ranks; the backward
is the identity, since what follows is replicated), a statistic that each
rank uses on its own channels goes through `sum` (a sum both ways), and a
column-parallel output that replicated code reads whole goes through
`gather` (each rank's block written into zeros, then the sum: adding
zeros is exact; the backward keeps the rank's block). The bridge's
sequence sharding (models/bridge.py) takes this rank's block of rows
(`rows`), computes on it and gathers the blocks; the gradients that its
replicated weights get from a block alone are summed once after the
backward (`sum_grads_`, one flat all_reduce).

Every collective is an all_reduce (sum) over the model group: the one
collective, with broadcast, that the gloo backend takes on CUDA tensors,
so that two ranks can share one card. The collectives run in the current
stream's order, as parallel.mesh.global_sum does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    return y


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def _gather(x, dim, size, rank, group):
    n = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = n * size
    full = x.new_zeros(shape)
    full.narrow(dim, rank * n, n).copy_(x)
    dist.all_reduce(full, group=group)
    return full


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, size, rank, group):
        ctx.block = (dim, rank, x.shape[dim])
        return _gather(x, dim, size, rank, group)

    @staticmethod
    def backward(ctx, g):
        dim, rank, n = ctx.block
        return g.narrow(dim, rank * n, n).contiguous(), None, None, None, \
            None


@dataclass(frozen=True)
class ModelAxis:
    """This rank's place `rank` on a model axis of `size` ranks, and its
    process group."""

    size: int
    rank: int
    group: object

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """x; the backward sums the ranks' gradients."""
        return _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the ranks; the backward is the identity."""
        return _Reduce.apply(x, self.group)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the ranks, differentiably both ways."""
        return _Sum.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int = -1,
               grad: bool = True) -> torch.Tensor:
        """The ranks' blocks of equal size along `dim`, in rank order; the
        backward keeps this rank's block. grad=False: no graph."""
        dim = dim % x.dim()
        if not grad:
            return _gather(x, dim, self.size, self.rank, self.group)
        return _Gather.apply(x, dim, self.size, self.rank, self.group)

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the ranks in place, outside autograd."""
        dist.all_reduce(x, group=self.group)
        return x

    def block(self, n: int) -> slice:
        """This rank's block of n channels (n divisible by the size)."""
        b = n // self.size
        return slice(self.rank * b, (self.rank + 1) * b)

    def rows(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's block of x along `dim` (divisible by the size): the
        inverse of gather; a view."""
        blk = self.block(x.shape[dim])
        return x.narrow(dim, blk.start, blk.stop - blk.start)

    def sum_grads_(self, tensors) -> None:
        """Each tensor (of one dtype) summed over the ranks in place,
        outside autograd: one all_reduce of the tensors flattened into one
        buffer (the partial gradients of the sequence-sharded bridge's
        fp32 weights, taken between the backward and the update)."""
        tensors = list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(v.view_as(t))
