"""Megatron's collectives for tensor-parallel layers, as autograd Functions
over a model group.

  * ``copy_to_group`` (Megatron's f): the identity forward, an all-reduce of
    the gradient backward. It sits before the column-parallel linears, whose
    input every rank holds whole;
  * ``reduce_from_group`` (g): an all-reduce forward, the identity backward.
    It sums the row-parallel linears' partial outputs;
  * ``gather_last`` joins the column-parallel shards of the last axis in rank
    order (all-gather forward, this rank's slice of the gradient backward).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from psalm_tpu_torch.parallel.mesh import gather_axis


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, parts):
        ctx.rank, ctx.size = rank, x.shape[-1]
        return gather_axis(x, x.ndim - 1, group, parts)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(-1, ctx.rank * ctx.size, ctx.size).contiguous(),
                None, None, None)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def gather_last(x: torch.Tensor, mesh) -> torch.Tensor:
    return _GatherLast.apply(x, mesh.model_group, mesh.model_rank, mesh.model)
