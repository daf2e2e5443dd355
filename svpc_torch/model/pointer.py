"""Pointer-generator copy network: the port of svpc_tpu/model/pointer.py.

Reference: pointer_generator_network (model.py:896-923).  The copy scatter
onto the OOV-extended vocabulary is a dense ``(E, C)`` copy matrix built
from per-entity id groups (``copy_ids`` / ``copy_weights``).  The two
projections (``Wing``, ``pgen_linear.0``) sit at the top of the reference
module tree, so SVPCModel owns them and passes them in.  ``wing`` computes
in the entity vectors' dtype and ``pgen`` in the decoder outputs'; the
attention logits over entities and their softmax are float32, the logits
taken from the operands widened to float32 (the same products as
svpc_tpu's bfloat16 einsum with a float32 result).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e30


def pointer_generator(wing: nn.Linear, pgen: nn.Linear,
                      decoder_outputs, ingr_vectors, entity_mask,
                      copy_ids, copy_weights, vocab_probs,
                      max_oov: int) -> torch.Tensor:
    """
    decoder_outputs (B, S, T, H); ingr_vectors (B, S, E, H) per-step entity
    vectors; entity_mask (B, E); copy_ids / copy_weights (B, E, K);
    vocab_probs (B, S, T, V).  Returns (B, S, T, C), C = V + max_oov.
    """
    C = vocab_probs.shape[-1] + max_oov
    attn_logits = torch.einsum("bseh,bsth->bste", wing(ingr_vectors).float(),
                               decoder_outputs.float())
    emask = entity_mask.float()[:, None, None, :]
    attn_logits = torch.where(emask > 0, attn_logits,
                              torch.full_like(attn_logits, NEG_INF))
    attn = torch.softmax(attn_logits, dim=-1) * emask  # all-invalid rows -> 0

    attended = torch.einsum("bste,bseh->bsth", attn.to(ingr_vectors.dtype),
                            ingr_vectors)
    p_gen = torch.sigmoid(pgen(torch.cat([decoder_outputs, attended], -1)
                               .to(decoder_outputs.dtype)))

    gen = F.pad(vocab_probs * p_gen, (0, max_oov))
    copy_attn = attn * (1.0 - p_gen)                        # (B,S,T,E)
    copy_matrix = torch.einsum(
        "bekc,bek->bec", F.one_hot(copy_ids.long(), C).to(gen.dtype),
        copy_weights)
    return gen + torch.einsum("bste,bec->bstc", copy_attn, copy_matrix)
