"""Operations and bytes counted from shapes: the model's matrix products
for one served or trained video, and the attention kernel's bound for one
call.  Counts are 2 operations a multiply-add, over the real (unpadded)
extents: a clip's own frames, a video's own clips and ingredients, so
the same work is counted whatever layout or kernel computes it.  Element
wise work, softmaxes, norms and table lookups are left out.
``attention_bound_s`` is chip_smoke.py's ``_bound_ms`` at commit aeb5374.
"""

from __future__ import annotations

from typing import Dict, Sequence

from pbench import peaks


def _encoder_layer(c: Dict, n: int) -> int:
    """One encoder layer over a sequence of n positions."""
    H, I = c["hidden_size"], c["intermediate_size"]
    return 2 * n * H * (4 * H + 2 * I) + 4 * n * n * H


def _reasoner(c: Dict, steps: int, entities: int) -> int:
    H, L, A, W = (c["hidden_size"], c["lstm_hidden_size"],
                  c["action_vocab_size"], c["word_vec_size"])
    per_step = 2 * (H * L + L * A + A * W + H * L + (L + A) * L + L * 3 + W)
    return steps * (per_step + 6 * entities * H)


def _memory_rows(c: Dict) -> int:
    return {"full": 3, "reason_copy": 3, "copy": 2, "video": 1}[
        c["model_mode"]]


def encode_flops(c: Dict, frames: Sequence[int], entities: int,
                 ingredient_tokens: int) -> int:
    """``SVPCModel.encode`` of one video: ``frames`` the real feature rows
    of each clip (the clip encoder sees them plus [CLS] and [SEP])."""
    H, D, W = c["hidden_size"], c["video_feature_size"], c["word_vec_size"]
    layers = c["num_hidden_layers"]
    S = len(frames)
    total = 0
    for f in frames:
        n = f + 2
        total += 2 * n * D * H + layers * _encoder_layer(c, n)
    total += layers * _encoder_layer(c, S)
    mode = c["model_mode"]
    if mode != "video":
        total += 2 * ingredient_tokens * W * H \
            + 2 * entities * ingredient_tokens * H
    if mode in ("full", "reason_copy"):
        total += _reasoner(c, S, entities) + 2 * S * (H * H + W * H)
    return total


def decode_position_flops(c: Dict, keys: int, entities: int) -> int:
    """One decoder position attending to ``keys`` earlier positions, the
    head and the copy network (cross-attention K/V are per clip)."""
    H, W, V = c["hidden_size"], c["word_vec_size"], c["vocab_size"]
    M = _memory_rows(c)
    layer = 2 * 5 * H * H + 4 * keys * H + 4 * M * H
    total = 2 * W * H + c["num_hidden_layers"] * layer + 2 * H * (H + V)
    if c["model_mode"] != "video":
        total += 4 * entities * H + 4 * H + 2 * entities * (V + c["max_oov"])
    return total


def clip_decode_setup_flops(c: Dict, entities: int) -> int:
    """Per clip, once: the cross-attention K/V of the memory rows and the
    copy network's projection of the entity vectors."""
    H = c["hidden_size"]
    total = c["num_hidden_layers"] * 4 * _memory_rows(c) * H * H
    if c["model_mode"] != "video":
        total += 2 * entities * H * c["intermediate_size"]
    return total


def serve_video_flops(c: Dict, frames: Sequence[int], entities: int,
                      ingredient_tokens: int) -> int:
    """A greedy decode of one video: encode, then for each clip T - 1
    positions scored, position t attending to t + 1 keys."""
    T = c["max_t_len"]
    per_clip = clip_decode_setup_flops(c, entities) + sum(
        decode_position_flops(c, t + 1, entities) for t in range(T - 1))
    return encode_flops(c, frames, entities, ingredient_tokens) \
        + len(frames) * per_clip


def train_video_flops(c: Dict, frames: Sequence[int], entities: int,
                      ingredient_tokens: int) -> int:
    """Forward and backward (twice the forward) of one video under teacher
    forcing: encode, the causal decoder over T positions, and in "full"
    mode the textual re-simulator (the straight-through bag of words over
    the vocabulary, the recipe BiLSTM, the second reasoner)."""
    H, W, V, T = (c["hidden_size"], c["word_vec_size"], c["vocab_size"],
                  c["max_t_len"])
    S = len(frames)
    fwd = encode_flops(c, frames, entities, ingredient_tokens)
    # the decoder over all T positions: position t attends to t + 1 keys
    fwd += S * (clip_decode_setup_flops(c, entities) + sum(
        decode_position_flops(c, t + 1, entities) for t in range(T)))
    if c["model_mode"] == "full":
        fwd += S * 2 * T * V * W
        fwd += 2 * S * (2 * W * 4 * H + 2 * H * 4 * H)
        fwd += _reasoner(c, S, entities)
    return 3 * fwd


def attention_bound_s(n: int, lq: int, lk: int, hidden: int,
                      mask_numel: int, itemsize: int, mask_itemsize: int,
                      dtype: str) -> float:
    """The least time one attention call can take on the card: the larger
    of its operations (QK^T and PV: 4 n lq lk hidden) over the peak and its
    bytes (q, k, v and the mask read once, the output written once) over
    the memory bandwidth."""
    ops = 4 * n * lq * lk * hidden
    nbytes = (2 * n * lq * hidden + 2 * n * lk * hidden) * itemsize \
        + mask_numel * mask_itemsize
    return max(ops / peaks.ATTENTION_FLOPS_PER_S[dtype],
               nbytes / peaks.HBM_BYTES_PER_S)
