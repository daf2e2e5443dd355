"""Greedy autoregressive decoding: the port of svpc_tpu/decode/greedy.py.

Reference: translator.py:45-163.  The semantics are the reference's: UNK
suppressed with -1e10, copy-produced OOV ids tracked in a parallel
extended-id buffer and fed back as UNK, position 0 forced to [BOS].  The
``lax.scan`` of the JAX package is a Python loop over positions here.
"""

from __future__ import annotations

from typing import Dict

import torch

from svpc_torch import tokenization as tok
from svpc_torch.model.svpc import clip_view, scatter_clips

NEG = -1e10


@torch.no_grad()
def greedy_decode(model, batch: Dict[str, torch.Tensor],
                  use_cache: bool = True) -> torch.Tensor:
    """Extended token ids (B, S, T) on the batch's device: [BOS], then the
    argmax tokens (plain ids in video mode).

    ``use_cache=True`` decodes incrementally with per-layer KV caches
    (O(T)); ``False`` re-runs the decoder over all positions for every
    token, as the reference does.  Both give the same tokens."""
    cfg = model.cfg
    T, V, C = cfg.max_t_len, cfg.vocab_size, cfg.extended_vocab_size
    packed = "clip_video" in batch
    if packed:  # pseudo-batch of packed clips: batch axis N, one step
        B, S = batch["clip_input_ids"].shape[0], 1
        head_batch = clip_view(batch)
    else:
        B, S = batch["input_ids"].shape[:2]
        head_batch = batch
    dev = batch["step_mask"].device

    state = model.encode(batch, deterministic=True)

    cols = torch.arange(C, device=dev)
    if cfg.model_mode == "video":
        ext = torch.full((B,), V, dtype=torch.long, device=dev)
    else:
        ext = V + head_batch["oov_count"]
    col_ok = (cols[None, :] < ext[:, None]) & (cols[None, :] != tok.UNK)
    col_ok = col_ok[:, None, :]                              # (B, 1, C)

    text_ids = torch.zeros(B, S, T, dtype=torch.long, device=dev)  # [PAD]
    ext_ids = torch.zeros_like(text_ids)
    text_mask = torch.zeros(B, S, T, device=dev)
    next_sym = torch.full((B, S), tok.BOS, dtype=torch.long, device=dev)
    oov_next = next_sym.clone()

    def argmax_step(cur):
        # torch.argmax, like jnp.argmax, returns the first maximum
        nw = torch.argmax(cur.masked_fill(~col_ok, NEG), dim=-1)
        return torch.where(nw >= V, torch.full_like(nw, tok.UNK), nw), nw

    # T-1 scoring iterations: iteration t writes position t, then selects
    # the token for position t+1; the last one is written after the loop
    if use_cache:
        caches, enc_kv = model.init_decode_caches((B, S), state)
    for t in range(T - 1):
        text_ids[:, :, t] = next_sym
        ext_ids[:, :, t] = oov_next
        if use_cache:
            cur, caches = model.score_position_cached(
                head_batch, state, next_sym, t, caches, enc_kv)
        else:
            text_mask[:, :, t] = 1.0
            cur = model.score_position(head_batch, state, text_ids,
                                       text_mask, t)
        next_sym, oov_next = argmax_step(cur)
    text_ids[:, :, T - 1] = next_sym
    ext_ids[:, :, T - 1] = oov_next

    out = text_ids if cfg.model_mode == "video" else ext_ids
    if packed:  # the (N, 1, T) clip rows back onto the (B, S, T) grid
        out = scatter_clips(batch, out[:, 0], tuple(batch["step_mask"].shape))
    return out
