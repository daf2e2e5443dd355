"""Collectives with gradients, on ``torch.distributed``.

GSPMD writes svpc_tpu's collectives from its sharding annotations; in
eager PyTorch each one is written out.  These are Megatron's:

  ``copy_to_tp``      identity forward, tp all-reduce backward: where a
                      replicated activation enters a column-parallel
                      product (each rank's gradient is a partial sum);
  ``reduce_from_tp``  tp all-reduce forward, identity backward: the
                      partial products of a row-parallel product or a
                      vocab-parallel lookup;
  ``gather_from_tp``  all-gather along the last axis forward, this rank's
                      slice backward: heads before a LayerNorm, vocab
                      columns before the softmax;
  ``all_reduce_dp``   dp all-reduce (sum) forward and backward: gradients
                      and metrics.

Each takes the group to run on (a ``Mesh``'s ``tp_group`` or
``dp_group``) and calls ``torch.distributed`` whatever the backend: gloo
on the CPU (and, on one card, with CUDA tensors), NCCL across cards.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return gather_dim(x, -1, group)

    @staticmethod
    def backward(ctx, grad):
        lo = dist.get_rank(ctx.group) * ctx.width
        return grad[..., lo:lo + ctx.width].contiguous(), None


class _AllReduceDP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherFromTP.apply(x, group)


def all_reduce_dp(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceDP.apply(x, group)


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (no
    gradient): a sharded tensor made whole for a checkpoint, or each dp
    block's decoded tokens."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)
