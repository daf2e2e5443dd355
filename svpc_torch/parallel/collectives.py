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

and the pipeline's (svpc_tpu's ``lax.ppermute`` and ``psum`` inside its
gpipe ``shard_map``, whose transposes JAX derives):

  ``ppermute``        forward: this stage's block to stage + 1 (stage 0
                      gets the last stage's, which it never reads);
                      backward: the gradient to stage - 1;
  ``trunk_entry``     identity forward, pp all-reduce backward: only stage
                      0 consumes the trunk's input, but every stage runs
                      the replicated embeddings before it and needs their
                      whole gradient;
  ``trunk_exit``      forward: the last stage's output buffer to every
                      stage (an all-reduce of the buffer, zero on the other
                      stages); backward: identity, since every stage runs
                      the same head and loss and so already holds the one
                      cotangent (a sum would count it pp times).

Each takes the group to run on (a ``Mesh``'s ``tp_group``, ``dp_group``
or ``pp_group``) and calls ``torch.distributed`` whatever the backend:
gloo on the CPU (and, on one card, with CUDA tensors), NCCL across cards.
``ppermute`` is an all-gather over the pp group that keeps the
neighbour's block, not a ``send`` / ``recv`` pair: gloo's all-gather is
known to take CUDA tensors on one card, and every stage issuing the same
collective in the same order is what keeps the pipeline's backward free
of deadlock.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
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


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, -1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, +1), None


def _shift(x: torch.Tensor, group, by: int) -> torch.Tensor:
    """The block of the stage ``by`` away (modulo the group's size)."""
    parts = all_gather_list(x, group)
    return parts[(dist.get_rank(group) + by) % len(parts)]


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def ppermute(x: torch.Tensor, group) -> torch.Tensor:
    return _PPermute.apply(x, group)


def trunk_entry(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def trunk_exit(buf: torch.Tensor, is_last: torch.Tensor, group
               ) -> torch.Tensor:
    """``buf`` of the last stage (``is_last`` a bool tensor, so the graph
    is the same on every stage) on every stage of ``group``."""
    return _ReduceFrom.apply(torch.where(is_last, buf, torch.zeros_like(buf)),
                             group)


def gather_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _GatherFromTP.apply(x, group)


def all_reduce_dp(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceDP.apply(x, group)


def all_gather_list(x: torch.Tensor, group) -> list:
    """Every rank's ``x`` in rank order (no gradient)."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (no
    gradient): a sharded tensor made whole for a checkpoint, or each dp
    block's decoded tokens."""
    return torch.cat(all_gather_list(x, group), dim=dim)
