"""Visual simulator: the entity reasoning network.

The port of svpc_tpu/model/reasoner.py (reference EntitiyReasoningNetwork,
model.py:742-823).  Every parameterized projection depends only on the
per-step vector, so all of them run batched over (B, S) outside the
recurrence; the S-step loop (``lax.scan`` in the JAX package) carries only
``(entity_vectors, prev_attn)`` and is parameter-free.  Invalid entity
slots are masked (probability 0).  Every product runs in the dtype of
``step_vectors`` (bfloat16 for the visual simulator under bfloat16
compute, float32 for the textual re-simulator, which reads the BiLSTM).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from svpc_torch.config import ModelConfig
from svpc_torch.model.layers import Linear, _dropout
from svpc_torch.parallel.collectives import copy_to_tp, reduce_from_tp
from svpc_torch.parallel.mesh import module_tp_dim


class ReasonerOutputs(NamedTuple):
    ent_probs: torch.Tensor            # (B, S, E) sigmoid entity probabilities
    ac_probs: torch.Tensor             # (B, S, A) sigmoid action probabilities
    step_entity_vectors: torch.Tensor  # (B, S, H) attended entity vector
    all_entity_vectors: torch.Tensor   # (B, S, E, H) post-update entity memory
    step_action_vectors: torch.Tensor  # (B, S, W) prob-weighted action embedding


def _safe_div(num, den):
    """num / den where den > 0, else 0."""
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


class EntityReasoner(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        H, L, A = cfg.hidden_size, cfg.lstm_hidden_size, cfg.action_vocab_size
        self.dropout_p = cfg.reasoner_dropout_prob
        # reference indices: Linear 0, ReLU 1, Dropout 2, Linear 3
        self.action_selector = nn.Sequential(
            Linear(H, L), nn.ReLU(), nn.Dropout(cfg.reasoner_dropout_prob),
            Linear(L, A))
        self.action_embeddings = nn.Parameter(
            torch.zeros(A, cfg.word_vec_size))
        self.W1 = nn.Sequential(Linear(H, L), nn.ReLU())
        self.W2 = Linear(L + A, L)
        self.W3 = Linear(L, 3)
        self.W4 = Linear(cfg.word_vec_size, 1)

    def forward(self, step_vectors, entity_init, entity_mask,
                deterministic: bool = True,
                generator=None) -> ReasonerOutputs:
        """step_vectors (B,S,H), entity_init (B,E,H) already zero on invalid
        slots, entity_mask (B,E)."""
        B, S, _ = step_vectors.shape
        E = entity_init.shape[1]

        # (1) action selector (Eq.1)
        h = torch.relu(self.action_selector[0](step_vectors))
        h = _dropout(h, self.dropout_p, deterministic, generator)
        ac_probs = torch.sigmoid(self.action_selector[3](h))      # (B,S,A)
        weights = _safe_div(ac_probs, ac_probs.sum(-1, keepdim=True))
        table = self.action_embeddings.to(step_vectors.dtype)
        if module_tp_dim(self, "action_embeddings") == 0:
            # this rank's rows of the table: a partial product, all-reduced
            n, group = table.shape[0], self.mesh.tp_group
            lo = self.mesh.tp_index * n
            bar_ft = reduce_from_tp(
                copy_to_tp(weights, group)[..., lo:lo + n] @ table, group)
        else:
            bar_ft = weights @ table
        # (2) entity selector precomputations (Eq.2-3)
        hat_ht = self.W1(step_vectors)
        w2_vec = self.W2(torch.cat([hat_ht, ac_probs], dim=-1))  # (B,S,H)
        choice = torch.softmax(self.W3(hat_ht), dim=-1)           # (B,S,3)
        # (3) updater gate (Eq.6)
        w4 = self.W4(bar_ft)                                      # (B,S,1)

        dt = step_vectors.dtype
        emask = entity_mask.to(dt)
        entities = entity_init * emask[..., None]
        # the recurrence's elementwise steps run in float32 and round to
        # the compute dtype where svpc_tpu stores a value (the scan's
        # carries and outputs, the products' operands and results), as
        # XLA's fused bfloat16 arithmetic does; in float32 nothing changes
        emask32, choice32, w4_32 = emask.float(), choice.float(), w4.float()
        prev_attn = step_vectors.new_zeros(B, E).float()
        ent_probs, bar_ets, all_entities = [], [], []
        for s in range(S):
            p32 = torch.sigmoid(torch.einsum(
                "beh,bh->be", entities, w2_vec[:, s]).float()) * emask32
            c = choice32[:, s]
            attn = c[:, 0:1] * p32 + c[:, 1:2] * prev_attn
            attn_norm = _safe_div(attn, attn.sum(-1, keepdim=True))
            bar_et = torch.einsum("be,beh->bh", attn_norm.to(dt), entities)
            kt = torch.relu(w4_32[:, s] * bar_et.float())
            entities = (attn[..., None] * kt[:, None, :]
                        + (1.0 - attn)[..., None] * entities.float()).to(dt)
            ent_prob = p32.to(dt)
            prev_attn = ent_prob.float()
            ent_probs.append(ent_prob)
            bar_ets.append(bar_et)
            all_entities.append(entities)

        return ReasonerOutputs(
            ent_probs=torch.stack(ent_probs, 1),
            ac_probs=ac_probs,
            step_entity_vectors=torch.stack(bar_ets, 1),
            all_entity_vectors=torch.stack(all_entities, 1),
            step_action_vectors=bar_ft)
