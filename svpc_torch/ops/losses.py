"""Loss functions with the reference's exact (quirky) semantics: the port of
svpc_tpu/ops/losses.py.

All losses use SUM reduction over examples/steps: the reference sums
per-example losses, never averages (model.py:1110-1115, :1188).
"""

from __future__ import annotations

from typing import Optional

import torch

from svpc_torch.tokenization import IGNORE


def label_smoothing_kl(probs: torch.Tensor, labels: torch.Tensor,
                       ext_size, label_smoothing: float,
                       eps: float = 1e-12) -> torch.Tensor:
    """Label-smoothed KL caption loss over an OOV-extended vocabulary.

    Reproduces LabelSmoothingLoss (reference model.py:15-55) with its
    quirks: the model emits *probabilities*, logged with ``+1e-12``; the
    smoothing mass is ``ls/(C-1)`` over the C columns of each row's
    *actual* extended vocabulary; ``one_hot[ignore_index=-1] = 0`` zeroes
    the smoothing mass of the LAST column; the gold column gets
    ``1 - label_smoothing`` (a scatter, so a gold label in the last column
    keeps full confidence).  KL terms with a zero target are 0.

    probs (N, C), zero beyond ``ext_size``; labels (N,) extended ids,
    IGNORE rows dropped; ext_size an int or (N,).  Returns a scalar."""
    probs = probs.float()
    n, c = probs.shape
    ext_size = torch.as_tensor(ext_size, device=probs.device).long() \
        .expand(n)
    cols = torch.arange(c, device=probs.device)[None, :]
    ext = ext_size[:, None]

    smooth = label_smoothing / (ext_size.float() - 1.0)
    zero = probs.new_zeros(())
    target = torch.where(cols < ext, smooth[:, None], zero)
    target = torch.where(cols == ext - 1, zero, target)  # one_hot[-1] = 0
    safe_labels = labels.clamp(0, c - 1)
    target = torch.where(cols == safe_labels[:, None],
                         probs.new_tensor(1.0 - label_smoothing), target)

    logp = torch.log(probs + eps)
    terms = torch.where(target > 0,
                        target * (torch.log(target.clamp(min=eps)) - logp),
                        zero)
    valid = (labels != IGNORE).float()
    return (terms.sum(-1) * valid).sum()


def bce_sum(probs: torch.Tensor, targets: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary cross-entropy on probabilities, sum reduction: torch's
    ``BCELoss(reduction="sum")`` (model.py:871) with its -100 clamp of the
    logs.  The log's input is floored at 1e-35 (a normal f32) instead of
    branching, so gradients stay finite at p in {0, 1}."""
    tiny = 1e-35
    probs = probs.float()
    targets = targets.float()
    logp = torch.log(probs.clamp(min=tiny)).clamp(min=-100.0)
    log1mp = torch.log((1.0 - probs).clamp(min=tiny)).clamp(min=-100.0)
    loss = -(targets * logp + (1.0 - targets) * log1mp)
    if mask is not None:
        loss = loss * mask
    return loss.sum()


def asymmetric_loss_sum(probs: torch.Tensor, targets: torch.Tensor,
                        row_mask: Optional[torch.Tensor] = None,
                        gamma_neg: float = 4.0, gamma_pos: float = 1.0,
                        clip: float = 0.05, eps: float = 1e-8
                        ) -> torch.Tensor:
    """Asymmetric multi-label loss (ASL) on probabilities, as the reference
    invokes the vendored AsymmetricLoss (libs/ASL/src/loss_functions/
    losses.py:5-50): sigmoid probabilities in, only rows with at least one
    positive verb scored (model.py:1103-1104), via ``row_mask``."""
    probs = probs.float()
    targets = targets.float()
    xs_neg = (1.0 - probs + clip).clamp(max=1.0)
    loss = (targets * torch.log(probs.clamp(min=eps))
            + (1.0 - targets) * torch.log(xs_neg.clamp(min=eps)))
    pt = probs * targets + xs_neg * (1.0 - targets)
    gamma = gamma_pos * targets + gamma_neg * (1.0 - targets)
    # the base is floored so that base -> 0 keeps gradients finite
    loss = loss * torch.pow((1.0 - pt).clamp(min=1e-38), gamma)
    if row_mask is not None:
        loss = loss * row_mask[..., None]
    return -loss.sum()
