"""Straight-through Gumbel-softmax sampling: the port of
svpc_tpu/ops/gumbel.py (``F.gumbel_softmax(logits, tau, hard=True)`` of
the textual re-simulator, reference model.py:1018).

The noise comes from a ``torch.Generator`` instead of ``jax.random``: the
sampling path is stochastic, so only the distribution has to agree.  The
parity tests hand both packages the same noise."""

from __future__ import annotations

from typing import Optional

import torch

from svpc_torch.parallel.mesh import uniform


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Standard Gumbel samples -log(-log(u)) in float32, u uniform in
    [tiny, 1) (as jax.random.gumbel draws them); over the global shape
    under a mesh (``parallel.mesh.uniform``)."""
    u = uniform(shape, generator, device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def straight_through(logits: torch.Tensor, noise: torch.Tensor,
                     tau: float) -> torch.Tensor:
    """One-hot of argmax((logits + noise) / tau) in the forward pass, the
    gradient of the soft sample in the backward.  Noise and softmax run in
    float32 whatever the logits' dtype."""
    y_soft = torch.softmax((logits.float() + noise) / tau, dim=-1) \
        .to(logits.dtype)
    index = y_soft.argmax(dim=-1, keepdim=True)
    y_hard = torch.zeros_like(y_soft).scatter_(-1, index, 1.0)
    return y_hard + y_soft - y_soft.detach()


def gumbel_softmax_st(logits: torch.Tensor, tau: float,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """Hard one-hot sample over the last axis with straight-through
    softmax gradients; the noise is drawn from ``generator``."""
    return straight_through(
        logits, gumbel_noise(logits.shape, generator, logits.device), tau)
