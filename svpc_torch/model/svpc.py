"""State-aware recursive transformer — the top model.

The port of svpc_tpu/model/svpc.py (reference StateAwareRecursiveTransformer,
model.py:826-1189): encoding in all four ablation modes ("full" = vivt,
"reason_copy" = viv, "copy" = vi, "video" = v), the teacher-forced scorer,
the KV-cached incremental scorer that greedy decoding drives, the textual
re-simulator (``reconstruct``) and the training forward with its losses.
Every random draw (dropout, Gumbel noise) comes from the ``generator``
passed to ``forward``.

Batches are dicts of tensors in the JAX package's layouts: dense
``(B, S, ...)`` grids, or the packed per-clip layout of data/packing.py
(``clip_*`` keys), which runs as a pseudo-batch of N clips with one step.

Under ``compute_dtype="bfloat16"`` the parameters stay float32 and the
activations are bfloat16 from the entry points on (the video features,
the word vectors), with svpc_tpu's exceptions: the head's softmax, the
copy network's mixture and everything downstream of it (losses, the
textual re-simulator) are float32.

``SVPCModel.shard(mesh)`` cuts a built model to this rank's tp shards
(svpc_tpu's ``shard_params`` rules, parallel/mesh.py): attention heads,
FFN columns and the vocabulary split over tp, the head's logits gathered
before the softmax, the rest replicated.  A model is always built whole
(an initializer draws every full tensor from the one generator, a
checkpoint loads whole) and then sharded, so tp=T starts from tp=1's
weights; ``full_state_dict`` gathers them back.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from svpc_torch import tokenization as tok
from svpc_torch.config import ModelConfig
from svpc_torch.model.embeddings import (IngredientEmbeddings, TextEmbeddings,
                                         VideoEmbeddings,
                                         add_position_encoding, lookup,
                                         sinusoid_table)
from svpc_torch.model.layers import (Decoder, Encoder, Linear,
                                     LMPredictionHead, MultiHeadAttention)
from svpc_torch.model.lstm import BiLSTM
from svpc_torch.model.pointer import pointer_generator
from svpc_torch.model.reasoner import EntityReasoner, ReasonerOutputs
from svpc_torch.ops.gumbel import gumbel_softmax_st
from svpc_torch.ops.losses import (asymmetric_loss_sum, bce_sum,
                                   label_smoothing_kl)
from svpc_torch.parallel.collectives import copy_to_tp, reduce_from_tp
from svpc_torch.parallel.mesh import (gather_params, module_tp_dim,
                                      shard_module, shard_params)
from svpc_torch.precision import check_compute_dtype

NEG_INF = -1e30


FEATURE_KEYS = ("video_feature", "clip_video_feature")


def to_tensors(batch: Dict[str, np.ndarray], device: torch.device,
               feature_dtype: torch.dtype = torch.float32
               ) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``: integers as int64 (index
    dtype), floats as float32, and the video features then cast to
    ``feature_dtype`` on ``device``.  svpc_tpu casts them on the host
    before the copy (``cast_transform``), which halves the copied bytes in
    bfloat16 but costs the host the cast; on the H100 neither order was
    faster over 15 timed pairs of a served batch (PERF.md, bf16).  The
    values are the same either way."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        t = t.long() if not t.is_floating_point() else t.float()
        t = t.to(device, non_blocking=True)
        out[k] = t.to(feature_dtype) if k in FEATURE_KEYS else t
    return out


def scatter_clips(batch, rows: torch.Tensor,
                  grid_shape: Tuple[int, int]) -> torch.Tensor:
    """Packed per-clip rows (N, ...) -> the (B, S, ...) step grid, zero at
    padded steps (padding clips are masked out before the scatter)."""
    cmask = batch["clip_mask"].reshape((-1,) + (1,) * (rows.dim() - 1))
    rows = rows * cmask.to(rows.dtype)
    grid = rows.new_zeros(grid_shape + rows.shape[1:])
    return grid.index_put((batch["clip_video"], batch["clip_step"]), rows,
                          accumulate=True)


def clip_view(batch) -> Dict[str, torch.Tensor]:
    """Per-clip view of the per-video arrays the LM head + pointer read,
    so the scorers run on a packed (N, 1, ...) pseudo-batch unchanged."""
    cv = batch["clip_video"]
    return {k: batch[k][cv]
            for k in ("entity_mask", "copy_ids", "copy_weights", "oov_count")}


class ModelOutputs(NamedTuple):
    total_loss: torch.Tensor
    caption_loss: torch.Tensor
    entity_loss: torch.Tensor
    action_loss: torch.Tensor
    re_entity_loss: torch.Tensor
    re_action_loss: torch.Tensor
    prediction_scores: torch.Tensor      # (B, S, T, C) probabilities
    ent_probs: Optional[torch.Tensor]    # (B, S, E)
    ac_probs: Optional[torch.Tensor]     # (B, S, A)
    re_ent_probs: Optional[torch.Tensor]
    re_ac_probs: Optional[torch.Tensor]
    memory: Optional[Dict[str, torch.Tensor]]


class EncodedState(NamedTuple):
    """Everything the decoder needs, computed once per batch."""
    step_vectors: torch.Tensor             # (B, S, H)
    ingr_vectors: torch.Tensor             # (B, E, H), invalid rows zeroed
    ga_inputs: torch.Tensor                # (B, S, M, H) cross-attn memory
    pointer_vectors: Optional[torch.Tensor]  # (B, S, E, H), None in video mode
    reasoner: Optional[ReasonerOutputs]


def init_parameters(model: nn.Module, std: float,
                    generator: torch.Generator) -> None:
    """The JAX package's initializers, drawn from ``generator`` in module
    order: dense kernels and embedding tables N(0, std), biases 0, LN
    weight 1 / bias 0, LSTM weights U(-1/sqrt(H), 1/sqrt(H))."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=generator)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, EntityReasoner):
                mod.action_embeddings.normal_(0.0, std, generator=generator)
            elif isinstance(mod, BiLSTM):
                k = 1.0 / math.sqrt(mod.hidden_size)
                for p in mod.parameters():
                    p.uniform_(-k, k, generator=generator)


class SVPCModel(nn.Module):
    """Parameters are initialized from ``generator`` when one is given
    (else they wait for ``load_state_dict``).  Build on the CPU, then
    ``.to(device)``: the same generator seed gives the same weights on
    every device."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        cfg.validate()
        self.compute_dtype = dt = check_compute_dtype(cfg)
        self.cfg = cfg
        mode = cfg.model_mode
        if mode != "video":
            self.ingredient_embeddings = IngredientEmbeddings(cfg)
        self.video_embeddings = VideoEmbeddings(cfg)
        self.text_embeddings = TextEmbeddings(cfg)
        # indexed by the video span's TOKEN ids (PAD/CLS/SEP/VID), not by
        # token_type_ids, as the reference does (model.py:890)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.encoder = Encoder(cfg)
        self.step_wise_encoder = Encoder(cfg)
        # PositionEncoding(max_len=50) over steps (model.py:839)
        self.register_buffer(
            "step_pe", torch.from_numpy(sinusoid_table(50, cfg.hidden_size)),
            persistent=False)
        if mode in ("full", "reason_copy"):
            self.reasoner = EntityReasoner(cfg)
            self.Wac = nn.Sequential(Linear(cfg.word_vec_size,
                                            cfg.hidden_size, compute_dtype=dt))
            self.Went = nn.Sequential(Linear(cfg.hidden_size,
                                             cfg.hidden_size, compute_dtype=dt))
        self.decoder = Decoder(cfg)
        self.decoder_classifier = LMPredictionHead(cfg)
        if mode != "video":
            self.Wing = Linear(cfg.hidden_size, cfg.intermediate_size)
            self.pgen_linear = nn.Sequential(Linear(2 * cfg.hidden_size, 1))
        if mode == "full":
            self.recipe_encoder = BiLSTM(cfg.word_vec_size, cfg.hidden_size)
            self.recipe_reasoner = EntityReasoner(cfg)
        if generator is not None:
            init_parameters(self, cfg.initializer_range, generator)
        self.mesh = None
        self.full_shapes = {n: tuple(p.shape)
                            for n, p in self.named_parameters()}
        self.param_tp_dims = {n: None for n in self.full_shapes}

    # ------------------------------------------------------------------ #
    # tensor parallelism
    # ------------------------------------------------------------------ #

    def shard(self, mesh, report: Optional[dict] = None) -> "SVPCModel":
        """Keep only this rank's tp shards of the (whole) parameters, in
        place; a dp-only mesh changes nothing but ``self.mesh``.
        ``report`` as ``parallel.mesh.shard_params``."""
        self.mesh = mesh
        if mesh is None or mesh.tp_size == 1:
            return self
        heads = self.cfg.num_attention_heads
        if self.cfg.hidden_size % mesh.tp_size == 0 and \
                heads % mesh.tp_size:
            raise ValueError(f"tp={mesh.tp_size} splits the hidden size but "
                             f"not the {heads} attention heads")
        self.param_tp_dims = shard_module(self, mesh, report)
        for mod in self.modules():
            if isinstance(mod, MultiHeadAttention) and \
                    module_tp_dim(mod.query) == 0:
                mod.num_heads = heads // mesh.tp_size
        return self

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole parameters, gathered over tp (every rank of the tp
        group calls it)."""
        return gather_params(self.state_dict(), self.param_tp_dims,
                             self.mesh)

    def load_full_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Load whole parameters (this rank keeps its tp shards),
        strictly."""
        if self.mesh is not None and self.mesh.tp_size > 1:
            state = shard_params(state, self.mesh)
        self.load_state_dict(state, strict=True)

    # ------------------------------------------------------------------ #
    # encoding
    # ------------------------------------------------------------------ #

    def _step_encode(self, cls_grid, step_mask, deterministic, generator):
        step_in = add_position_encoding(cls_grid, self.step_pe)
        return self.step_wise_encoder(step_in, step_mask, False,
                                      deterministic, generator)

    def encode_clips(self, batch, deterministic: bool = True,
                     generator=None):
        """Dense layout: encode every (B*S) clip's video span and step-encode
        the [CLS] summaries -> (B, S, H)."""
        B, S, L = batch["input_ids"].shape
        Lv = L - self.cfg.max_t_len
        flat = lambda x: x.reshape((B * S,) + x.shape[2:])
        vid_ids = flat(batch["input_ids"][:, :, :Lv])
        emb = self.video_embeddings(
            flat(batch["video_feature"][:, :, :Lv]).to(self.compute_dtype),
            deterministic, generator)
        emb = emb + lookup(self.token_type_embeddings, vid_ids).to(emb.dtype)
        enc = self.encoder(emb, flat(batch["input_mask"][:, :, :Lv]), False,
                           deterministic, generator)
        return self._step_encode(enc[:, 0].reshape(B, S, -1),
                                 batch["step_mask"], deterministic, generator)

    def encode_clips_packed(self, batch, deterministic: bool = True,
                            generator=None):
        """Packed layout: encode only the real clips (N, L) and scatter
        their [CLS] summaries onto the (B, S) step grid (zeros at padded
        steps)."""
        N, L = batch["clip_input_ids"].shape
        Lv = L - self.cfg.max_t_len
        B, S = batch["step_mask"].shape
        emb = self.video_embeddings(
            batch["clip_video_feature"][:, :Lv].to(self.compute_dtype),
            deterministic, generator)
        emb = emb + lookup(self.token_type_embeddings,
                           batch["clip_input_ids"][:, :Lv]).to(emb.dtype)
        enc = self.encoder(emb, batch["clip_input_mask"][:, :Lv], False,
                           deterministic, generator)
        grid = scatter_clips(batch, enc[:, 0], (B, S))
        return self._step_encode(grid, batch["step_mask"], deterministic,
                                 generator)

    def encode(self, batch, deterministic: bool = True,
               generator=None) -> EncodedState:
        """Clips, ingredients, reasoner and cross-attention memory.  In the
        packed layout ga_inputs / pointer_vectors come out gathered per
        clip as (N, 1, M, H) / (N, 1, E, H)."""
        cfg = self.cfg
        mode = cfg.model_mode
        packed = "clip_video" in batch
        step_vectors = (
            self.encode_clips_packed(batch, deterministic, generator)
            if packed else self.encode_clips(batch, deterministic, generator))
        B, S, H = step_vectors.shape

        ingr_vectors = reasoner_out = pointer_vectors = None
        if mode != "video":
            ingr_vectors = self.ingredient_embeddings(
                batch["ingr_ids"], batch["ingr_sep_mask"], deterministic,
                generator)
            ingr_vectors = ingr_vectors * batch["entity_mask"][..., None] \
                .to(ingr_vectors.dtype)

        if mode in ("full", "reason_copy"):
            reasoner_out = self.reasoner(step_vectors, ingr_vectors,
                                         batch["entity_mask"], deterministic,
                                         generator)
            ent_vec = torch.relu(self.Went(reasoner_out.step_entity_vectors))
            act_vec = torch.relu(self.Wac(reasoner_out.step_action_vectors))
            ga_inputs = torch.stack([step_vectors, ent_vec, act_vec], dim=2)
            pointer_vectors = reasoner_out.all_entity_vectors
        elif mode == "copy":
            # mean over valid entities (reference model.py:989)
            emask = batch["entity_mask"][..., None]
            mean_ingr = ((ingr_vectors * emask).sum(1)
                         / torch.clamp(emask.sum(1), min=1.0))     # (B, H)
            ga_inputs = torch.stack(
                [step_vectors, mean_ingr[:, None].expand_as(step_vectors)],
                dim=2)
            pointer_vectors = ingr_vectors[:, None].expand(
                (B, S) + ingr_vectors.shape[1:])
        else:
            ga_inputs = step_vectors[:, :, None]                  # (B,S,1,H)

        if packed:
            cv, cs = batch["clip_video"], batch["clip_step"]
            ga_inputs = ga_inputs[cv, cs][:, None]
            if pointer_vectors is not None:
                pointer_vectors = pointer_vectors[cv, cs][:, None]

        return EncodedState(
            step_vectors=step_vectors,
            ingr_vectors=(ingr_vectors if ingr_vectors is not None
                          else step_vectors.new_zeros(
                              B, cfg.max_entities, H, dtype=torch.float32)),
            ga_inputs=ga_inputs,
            pointer_vectors=pointer_vectors,
            reasoner=reasoner_out)

    # ------------------------------------------------------------------ #
    # decoding
    # ------------------------------------------------------------------ #

    def decode_hidden(self, state: EncodedState, text_ids, text_mask,
                      deterministic: bool = True, generator=None):
        """Causal decoder over a text hypothesis -> (B, S, T, H)."""
        B, S, T = text_ids.shape
        M = state.ga_inputs.shape[2]
        text_emb = self.text_embeddings(text_ids.reshape(B * S, T),
                                        deterministic, generator)
        dec = self.decoder(text_emb, text_mask.reshape(B * S, T),
                           state.ga_inputs.reshape(B * S, M, -1),
                           text_emb.new_ones(B * S, M), deterministic,
                           generator)
        return dec.reshape(B, S, T, -1)

    def head_probs(self, batch, state: EncodedState, dec):
        """LM head (+ pointer-generator) over dec (B, S, T', H) ->
        (B, S, T', C) probabilities; columns beyond each example's
        extended vocabulary are zero."""
        cfg = self.cfg
        shared = (self.text_embeddings.table if cfg.share_wd_cls_weight
                  else None)
        logits = self.decoder_classifier(dec, shared)
        vocab_probs = torch.softmax(logits.float(), dim=-1)
        if cfg.model_mode == "video":
            return F.pad(vocab_probs, (0, cfg.max_oov))
        probs = pointer_generator(
            self.Wing, self.pgen_linear[0], dec, state.pointer_vectors,
            batch["entity_mask"], batch["copy_ids"], batch["copy_weights"],
            vocab_probs, cfg.max_oov)
        cols = torch.arange(cfg.extended_vocab_size, device=probs.device)
        ext = cfg.vocab_size + batch["oov_count"]
        col_valid = (cols[None, :] < ext[:, None]).to(probs.dtype)
        return probs * col_valid[:, None, None, :]

    def score_text(self, batch, state: EncodedState, text_ids, text_mask,
                   deterministic: bool = True, generator=None):
        """Decoder + head over a text hypothesis -> (B, S, T, C)."""
        dec = self.decode_hidden(state, text_ids, text_mask, deterministic,
                                 generator)
        return self.head_probs(batch, state, dec)

    def score_position(self, batch, state: EncodedState, text_ids,
                       text_mask, t: int):
        """Scores for position ``t`` only -> (B, S, C); the decoder still
        attends causally over positions <= t."""
        dec = self.decode_hidden(state, text_ids, text_mask, True)
        return self.head_probs(batch, state, dec[:, :, t:t + 1])[:, :, 0]

    def init_decode_caches(self, batch_shape: Tuple[int, int],
                           state: EncodedState):
        """Per-layer zeroed self-attention (k, v) caches in the compute
        dtype, and the cross-attention K/V of the static encoder memory
        projected once.  Returns ``(self_caches, enc_kv)``."""
        cfg = self.cfg
        B, S = batch_shape
        ref = state.ga_inputs
        # this rank's heads under tp
        width = self.decoder.layer[0].self_attention.key.weight.shape[0]
        shape = (B * S, cfg.max_t_len, width)
        caches: List[Tuple[torch.Tensor, torch.Tensor]] = [
            (ref.new_zeros(shape, dtype=self.compute_dtype),
             ref.new_zeros(shape, dtype=self.compute_dtype))
            for _ in range(cfg.num_hidden_layers)]
        M = ref.shape[2]
        return caches, self.decoder.project_enc_kv(ref.reshape(B * S, M, -1))

    def score_position_cached(self, batch, state: EncodedState, tok_t,
                              t: int, caches, enc_kv):
        """Embed the tokens at position ``t``, run one cached decoder step
        (caches updated in place), score that position.
        tok_t (B, S) -> (probs (B, S, C), caches)."""
        B, S = tok_t.shape
        M = enc_kv[0][0].shape[1]
        x_t = self.text_embeddings.embed_position(tok_t.reshape(B * S, 1), t)
        y_t = self.decoder.step(x_t, caches, t, enc_kv, x_t.new_ones(B * S, M))
        probs = self.head_probs(batch, state, y_t.reshape(B, S, 1, -1))
        return probs[:, :, 0], caches

    # ------------------------------------------------------------------ #
    # textual re-simulator
    # ------------------------------------------------------------------ #

    def reconstruct(self, batch, prediction_scores, text_mask, ingr_vectors,
                    deterministic: bool = True, oov_count=None,
                    generator=None) -> ReasonerOutputs:
        """Straight-through re-simulation over generated text (reference
        model.py:1017-1025).  Dense: prediction_scores (B, S, T, C).
        Packed: (N, 1, T, C) with ``oov_count`` gathered per clip; the
        per-step bag-of-words means are scattered onto the (B, S) grid
        before the recipe BiLSTM."""
        cfg = self.cfg
        C = prediction_scores.shape[-1]
        logits = torch.log(prediction_scores + 1e-12)
        # exclude the fixed-shape padding columns the reference never has
        if oov_count is None:
            oov_count = batch["oov_count"]
        ext = cfg.vocab_size + oov_count
        cols = torch.arange(C, device=logits.device)
        logits = torch.where(cols < ext[:, None, None, None], logits,
                             logits.new_tensor(NEG_INF))
        onehot = gumbel_softmax_st(logits, cfg.temperature, generator)
        V = cfg.vocab_size
        table = self.text_embeddings.table
        if module_tp_dim(self.text_embeddings.word_embeddings) == 0:
            # this rank's rows of the vocabulary, a partial sum all-reduced
            group = self.mesh.tp_group
            lo = self.mesh.tp_index * table.shape[0]
            hi = max(lo, min(lo + table.shape[0], V))
            bow = reduce_from_tp(copy_to_tp(onehot, group)[..., lo:hi]
                                 @ table[:hi - lo], group)
        else:
            bow = onehot[..., :V] @ table[:V]                   # (B,S,T,W)

        tm = text_mask[..., None]
        counts = torch.clamp(tm.sum(2), min=1.0)
        step_bow = (bow * tm).sum(2) / counts                   # (B, S, W)
        if "clip_video" in batch:
            step_bow = scatter_clips(batch, step_bow[:, 0],
                                     tuple(batch["step_mask"].shape))

        hs = self.recipe_encoder(step_bow, batch["step_mask"])  # (B, S, 2H)
        hs = hs[..., :cfg.hidden_size] + hs[..., cfg.hidden_size:]
        return self.recipe_reasoner(hs, ingr_vectors, batch["entity_mask"],
                                    deterministic, generator)

    # ------------------------------------------------------------------ #
    # training forward + losses
    # ------------------------------------------------------------------ #

    def _action_loss(self, probs, targets, row_mask):
        """ASL by default (the reference hardcodes AsymmetricLoss at
        model.py:872); ``use_asl=False`` is the advertised BCE ablation."""
        if self.cfg.use_asl:
            return asymmetric_loss_sum(probs, targets, row_mask)
        return bce_sum(probs, targets, row_mask[..., None])

    def forward(self, batch, deterministic: bool = True,
                return_memory: bool = False,
                generator: Optional[torch.Generator] = None) -> ModelOutputs:
        """Teacher-forced scores and every loss (svpc_tpu/model/svpc.py
        ``__call__``).  The total is ``caption + entity + action +
        lambda_ * (re_entity + re_action)``, each a sum over the batch."""
        cfg = self.cfg
        T = cfg.max_t_len
        packed = "clip_video" in batch
        state = self.encode(batch, deterministic, generator)

        if packed:  # pseudo-batch: batch axis = packed clips, one step
            N, L = batch["clip_input_ids"].shape
            Lv = L - T
            B, S = N, 1
            text_ids = batch["clip_input_ids"][:, None, Lv:]
            text_mask = batch["clip_input_mask"][:, None, Lv:]
            labels = batch["clip_input_labels"][:, None, Lv:]
            head_batch = clip_view(batch)
        else:
            B, S, L = batch["input_ids"].shape
            Lv = L - T
            text_ids = batch["input_ids"][:, :, Lv:]
            text_mask = batch["input_mask"][:, :, Lv:]
            labels = batch["input_labels"][:, :, Lv:]            # extended ids
            head_batch = batch

        if cfg.model_mode == "video":
            # OOV labels fold to UNK (model.py:1013)
            labels = torch.where(labels >= cfg.vocab_size,
                                 torch.full_like(labels, tok.UNK), labels)
            ext_size = torch.full((B,), cfg.vocab_size, dtype=torch.long,
                                  device=labels.device)
        else:
            ext_size = cfg.vocab_size + head_batch["oov_count"]

        probs = self.score_text(head_batch, state, text_ids, text_mask,
                                deterministic, generator)
        # caption loss over each row's actual columns; rows of padded steps
        # carry IGNORE labels (data pipeline)
        caption_loss = label_smoothing_kl(
            probs.reshape(-1, probs.shape[-1]), labels.reshape(-1),
            ext_size.repeat_interleave(S * T), cfg.label_smoothing)

        zero = probs.new_zeros(())
        entity_loss = action_loss = re_entity_loss = re_action_loss = zero
        ent_probs = ac_probs = re_ent_probs = re_ac_probs = memory = None
        sup_mask = batch["step_mask"][..., None] * batch["entity_mask"][:, None]

        if cfg.model_mode in ("full", "reason_copy"):
            r = state.reasoner
            entity_loss = bce_sum(r.ent_probs, batch["alignment"], sup_mask)
            action_loss = self._action_loss(r.ac_probs, batch["action"],
                                            batch["action_row_mask"])
            ent_probs, ac_probs = r.ent_probs, r.ac_probs
            if return_memory:
                memory = dict(entity_probs=r.ent_probs,
                              action_probs=r.ac_probs,
                              ingr_vectors=state.ingr_vectors,
                              step_entity_vectors=r.all_entity_vectors)

        if cfg.model_mode == "full":
            re = self.reconstruct(batch, probs, text_mask, state.ingr_vectors,
                                  deterministic, head_batch["oov_count"],
                                  generator)
            re_entity_loss = bce_sum(re.ent_probs, batch["alignment"],
                                     sup_mask)
            re_action_loss = self._action_loss(re.ac_probs, batch["action"],
                                               batch["action_row_mask"])
            re_ent_probs, re_ac_probs = re.ent_probs, re.ac_probs
            if return_memory:
                memory.update(re_pred_entity_probs=re.ent_probs,
                              re_pred_action_probs=re.ac_probs,
                              re_entity_vectors=re.all_entity_vectors)

        total = (caption_loss + entity_loss + action_loss
                 + cfg.lambda_ * (re_entity_loss + re_action_loss))
        return ModelOutputs(
            total_loss=total, caption_loss=caption_loss,
            entity_loss=entity_loss, action_loss=action_loss,
            re_entity_loss=re_entity_loss, re_action_loss=re_action_loss,
            prediction_scores=probs, ent_probs=ent_probs, ac_probs=ac_probs,
            re_ent_probs=re_ent_probs, re_ac_probs=re_ac_probs, memory=memory)
