"""Embedding modules: the port of svpc_tpu/model/embeddings.py.

Reference: model.py:67-140 (sinusoidal PEs), :484-562 (untied text /
video / ingredient embeddings).  The sinusoidal tables are non-persistent
buffers: deterministic, so they stay out of the state dict (the reference
checkpoint carries them; model/from_jax.py drops them on load).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from svpc_torch.config import ModelConfig
from svpc_torch.model.layers import LayerNorm, Linear, _dropout
from svpc_torch.parallel.collectives import reduce_from_tp
from svpc_torch.parallel.mesh import module_tp_dim
from svpc_torch.precision import check_compute_dtype


def sinusoid_table(max_len: int, dim: int) -> np.ndarray:
    """Classic transformer PE table (reference model.py:80-92)."""
    pe = np.zeros((max_len, dim), dtype=np.float32)
    position = np.arange(0, max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                      * -(math.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


def pe_buffer(module: nn.Module, max_len: int, dim: int) -> None:
    module.register_buffer("pe", torch.from_numpy(sinusoid_table(max_len, dim)),
                           persistent=False)


def lookup(embedding: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    """``embedding(ids)`` as a product with one-hot rows: the same values
    (one non-zero term a row), and a backward that is a matrix product.
    On the card the embedding's own backward is not bitwise repeatable
    when rows repeat many times (the 4-row token-type table, looked up at
    every video frame, gave two identical steps different gradients), which
    made a resumed run drift from an uninterrupted one.

    A table split over tp holds this rank's rows: ids outside them get a
    zero one-hot row, and the partial lookups are all-reduced."""
    w = embedding.weight
    if module_tp_dim(embedding) != 0:
        return F.one_hot(ids, w.shape[0]).to(w.dtype) @ w
    n = w.shape[0]
    local = ids - embedding.mesh.tp_index * n
    mine = (local >= 0) & (local < n)
    onehot = F.one_hot(torch.where(mine, local, 0), n).to(w.dtype) \
        * mine[..., None].to(w.dtype)
    return reduce_from_tp(onehot @ w, embedding.mesh.tp_group)


def add_position_encoding(x: torch.Tensor, pe: torch.Tensor) -> torch.Tensor:
    """x (..., L, D) + pe[:L]."""
    return x + pe[: x.shape[-2]].to(x.dtype)


class WordFC(nn.Sequential):
    """LN -> dropout -> Linear -> ReLU -> LN (reference model.py:493-499);
    indices 0/2/4 carry the reference parameter names.  The input is cast
    to the compute dtype first (svpc_tpu's WordFC casts the looked-up word
    vectors, and its model casts the video features before their block),
    so everything after runs in it."""

    def __init__(self, cfg: ModelConfig, in_features: int):
        super().__init__(
            LayerNorm(in_features, cfg.layer_norm_eps),
            nn.Dropout(cfg.hidden_dropout_prob),
            Linear(in_features, cfg.hidden_size),
            nn.ReLU(),
            LayerNorm(cfg.hidden_size, cfg.layer_norm_eps))
        self.dropout_p = cfg.hidden_dropout_prob
        self.compute_dtype = check_compute_dtype(cfg)

    def forward(self, x, deterministic: bool = True, generator=None):
        h = _dropout(self[0](x.to(self.compute_dtype)), self.dropout_p,
                     deterministic, generator)
        return self[4](torch.relu(self[2](h)))


class TextEmbeddings(nn.Module):
    """word embedding -> WordFC -> positional encoding
    (reference BertEmbeddingsTextUntied)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.padded_vocab_size,
                                            cfg.word_vec_size)
        self.word_fc = WordFC(cfg, cfg.word_vec_size)
        pe_buffer(self, cfg.max_position_embeddings, cfg.hidden_size)

    def forward(self, text_ids, deterministic: bool = True, generator=None):
        emb = self.word_fc(lookup(self.word_embeddings, text_ids),
                           deterministic, generator)
        return add_position_encoding(emb, self.pe)

    def embed_position(self, tok_ids, t: int):
        """Embed tokens that all sit at sequence position ``t``:
        tok_ids (..., 1) -> (..., 1, H) with PE row t added."""
        emb = self.word_fc(lookup(self.word_embeddings, tok_ids), True)
        return emb + self.pe[t].to(emb.dtype)

    @property
    def table(self):
        return self.word_embeddings.weight


class VideoEmbeddings(nn.Module):
    """LN -> dropout -> Linear -> ReLU -> LN -> PE
    (reference BertEmbeddingsVideoUntied)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.video_embeddings = WordFC(cfg, cfg.video_feature_size)
        pe_buffer(self, cfg.max_position_embeddings, cfg.hidden_size)

    def forward(self, video_features, deterministic: bool = True,
                generator=None):
        h = self.video_embeddings(video_features, deterministic, generator)
        return add_position_encoding(h, self.pe)


def entity_segment_matrix(ingr_sep_mask: torch.Tensor,
                          max_entities: int) -> torch.Tensor:
    """(.., I) sep mask -> (.., E, I) mean-pool matrix.

    Row e averages the word positions strictly between the (e-1)-th and
    e-th [SEP] (reference model.py:125-134: the span excludes the SEP).
    Rows for absent entities are all-zero."""
    sep = ingr_sep_mask.float()
    seg_id = torch.cumsum(sep, dim=-1) - sep
    pos_is_word = 1.0 - sep
    e_ids = torch.arange(max_entities, dtype=seg_id.dtype,
                         device=seg_id.device)
    member = ((seg_id[..., None, :] == e_ids[:, None]).float()
              * pos_is_word[..., None, :])
    n_entities = sep.sum(-1, keepdim=True)
    exists = (e_ids[:, None] < n_entities[..., None, :]).float()
    member = member * exists
    counts = member.sum(-1, keepdim=True)
    return member / torch.clamp(counts, min=1.0)


class IngredientEmbeddings(nn.Module):
    """word embedding -> WordFC -> per-ingredient span mean-pool ->
    ingredient-level sinusoidal PE (reference model.py:106-140, :515-537)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.max_entities = cfg.max_entities
        self.word_embeddings = nn.Embedding(cfg.padded_vocab_size,
                                            cfg.word_vec_size)
        self.word_fc = WordFC(cfg, cfg.word_vec_size)
        pe_buffer(self, max(cfg.max_position_embeddings, cfg.max_entities),
                  cfg.hidden_size)

    def forward(self, ingr_ids, ingr_sep_mask, deterministic: bool = True,
                generator=None):
        emb = self.word_fc(lookup(self.word_embeddings, ingr_ids),
                           deterministic, generator)
        seg = entity_segment_matrix(ingr_sep_mask, self.max_entities)
        pooled = torch.einsum("bei,bih->beh", seg.to(emb.dtype), emb)
        return add_position_encoding(pooled, self.pe)
