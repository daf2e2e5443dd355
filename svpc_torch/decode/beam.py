"""Batched beam-search decoding: the port of svpc_tpu/decode/beam.py.

Every (video, step) decodes K hypotheses together, with the greedy
decoder's masking (UNK suppressed, per-example OOV-extended columns, copy
ids kept in an extended buffer and fed back as UNK).  Runs on the dense
(B, S, ...) grid and on the packed clip layout, whose clips decode as a
pseudo-batch and scatter back onto the (B, S) grid.

Scoring: the sum of token log-probabilities, optionally divided by the
GNMT length penalty ((5 + len) / 6) ** alpha.  ``n_best > 1`` returns the
ranked top-n hypotheses with their scores.

Ties rank the lower index first, as ``lax.top_k`` and ``jnp.argsort``
do: candidates are ordered by a stable descending sort.  The cached
path's self-attention caches are gathered with the beams on every
reorder (new contiguous tensors, which the attention kernel takes as
they are); the caches are updated in place within a step.
"""

from __future__ import annotations

from typing import Dict

import torch

from svpc_torch import tokenization as tok
from svpc_torch.model.svpc import clip_view, scatter_clips

NEG = -1e9

HEAD_KEYS = ("entity_mask", "copy_ids", "copy_weights", "oov_count")


def _repeat(x, k: int):
    """Every tensor of ``x`` (a tensor, None or a tuple of them, nested)
    repeated ``k`` times along dim 0, each row's copies adjacent."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return torch.repeat_interleave(x, k, dim=0)
    return type(x)(*(_repeat(v, k) for v in x))


def _gather_beams(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """x (B, K, S, ...) gathered along K by src (B, K', S) -> (B, K', S,
    ...)."""
    idx = src.reshape(src.shape + (1,) * (x.dim() - 3)).expand(
        src.shape + x.shape[3:])
    return torch.gather(x, 1, idx)


@torch.no_grad()
def beam_decode(model, batch: Dict[str, torch.Tensor], beam_size: int = 2,
                length_penalty: float = 0.0, use_cache: bool = True,
                n_best: int = 1):
    """Extended token ids (B, S, T) of the best beam when ``n_best == 1``
    (plain ids in video mode); with ``n_best > 1`` ``(tokens, scores)``,
    tokens (B, n_best, S, T) ranked best-first and scores (B, n_best, S)
    after the length penalty.

    ``use_cache=True`` scores each position with per-layer KV caches;
    ``False`` re-runs the decoder over all positions.  Both give the same
    tokens."""
    cfg = model.cfg
    T, V, C = cfg.max_t_len, cfg.vocab_size, cfg.extended_vocab_size
    K = beam_size
    if not 1 <= n_best <= K:
        raise ValueError(f"n_best={n_best} must be in [1, beam_size={K}]")
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
    col_ok = col_ok[:, None, None, :]                       # (B, 1, 1, C)

    # K copies of what the scorers read: the four head keys and the
    # encoded state (not the batch's video features)
    beam_batch = {k: _repeat(head_batch[k], K) for k in HEAD_KEYS
                  if k in head_batch}
    beam_state = _repeat(state, K)

    text_ids = torch.zeros(B, K, S, T, dtype=torch.long, device=dev)
    ext_ids = torch.zeros_like(text_ids)
    mask = (None if use_cache
            else torch.zeros(B, K, S, T, device=dev))
    scores = torch.zeros(B, K, S, device=dev)
    scores[:, 1:] = NEG          # only beam 0 is live: all start equal
    next_sym = torch.full((B, K, S), tok.BOS, dtype=torch.long, device=dev)
    oov_next = next_sym.clone()
    finished = torch.zeros(B, K, S, dtype=torch.bool, device=dev)
    lengths = torch.zeros(B, K, S, device=dev)
    pad_only = torch.full((C,), NEG, device=dev)
    pad_only[tok.PAD] = 0.0
    if use_cache:
        caches, enc_kv = model.init_decode_caches((B * K, S), beam_state)

    # T-1 select iterations: iteration t writes position t and selects
    # the token for position t+1 (selecting at T-1 would score a token no
    # buffer holds); the last selection lands in the final slot below
    for t in range(T - 1):
        text_ids[..., t] = next_sym
        ext_ids[..., t] = oov_next
        if use_cache:
            probs, caches = model.score_position_cached(
                beam_batch, beam_state, next_sym.reshape(B * K, S), t,
                caches, enc_kv)
        else:
            mask[..., t] = 1.0
            probs = model.score_position(
                beam_batch, beam_state, text_ids.reshape(B * K, S, T),
                mask.reshape(B * K, S, T), t)
        logp = torch.log(probs.reshape(B, K, S, C) + 1e-12)
        logp = torch.where(col_ok, logp, logp.new_tensor(NEG))
        # finished beams: only a PAD continuation, at no cost
        logp = torch.where(finished[..., None], pad_only, logp)

        cand = scores[..., None] + logp                     # (B, K, S, C)
        cand_flat = cand.permute(0, 2, 1, 3).reshape(B, S, K * C)
        top_scores, top_idx = torch.sort(cand_flat, dim=-1, descending=True,
                                         stable=True)
        top_scores = top_scores[..., :K].permute(0, 2, 1)   # (B, K, S)
        top_idx = top_idx[..., :K].permute(0, 2, 1)
        src_beam = torch.div(top_idx, C, rounding_mode="floor")
        token = top_idx % C

        text_ids = _gather_beams(text_ids, src_beam)
        ext_ids = _gather_beams(ext_ids, src_beam)
        finished = torch.gather(finished, 1, src_beam)
        lengths = torch.gather(lengths, 1, src_beam)
        if use_cache:
            # a reordered beam inherits its source beam's KV history; cache
            # rows are (B*K*S, ...) in (b, k, s) order
            caches = [tuple(
                _gather_beams(c.reshape((B, K, S) + c.shape[1:]), src_beam)
                .reshape(c.shape) for c in layer) for layer in caches]

        lengths = torch.where(finished, lengths, lengths + 1.0)
        finished = finished | (token == tok.EOS)
        scores = top_scores
        oov_next = token
        next_sym = torch.where(token >= V, torch.full_like(token, tok.UNK),
                               token)
    text_ids[..., T - 1] = next_sym
    ext_ids[..., T - 1] = oov_next

    if length_penalty > 0:
        scores = scores / ((5.0 + lengths) / 6.0) ** length_penalty
    out = ext_ids if cfg.model_mode != "video" else text_ids

    # rank the beams best-first and keep n_best
    order = torch.argsort(-scores, dim=1, stable=True)[:, :n_best]  # (B,n,S)
    ranked_scores = torch.gather(scores, 1, order)
    ranked = _gather_beams(out, order)                        # (B, n, S, T)

    if packed:  # the (N, n, 1, T) clip rows back onto the (Bv, n, Sv, T) grid
        grid = tuple(batch["step_mask"].shape)
        ranked = scatter_clips(batch, ranked[:, :, 0], grid) \
            .permute(0, 2, 1, 3).contiguous()
        ranked_scores = scatter_clips(batch, ranked_scores[:, :, 0], grid) \
            .permute(0, 2, 1).contiguous()

    if n_best == 1:
        return ranked[:, 0]
    return ranked, ranked_scores
