"""Transformer building blocks (post-LN, BERT-style).

The port of svpc_tpu/model/layers.py.  Module and parameter names are the
reference PyTorch names (svpc_tpu/model/import_torch.py:_encoder,
:_decoder), so reference checkpoints load with ``strict=True``.  Every
deterministic attention goes through ``ops.attention.fused_attention``:
the hand-written kernel on a CUDA tensor, ``attention_plain`` on a CPU
one.  A non-deterministic attention (training) runs ``attention_plain``
under autograd, with dropout on its probabilities, as svpc_tpu runs
``attention_core`` outside its Pallas kernel there.  The additive mask
``(1 - m) * -10000`` is kept exactly.  Every dropout draw comes from the
``generator`` passed down the call (the training step seeds one per step).

Numerics follow svpc_tpu's map in both compute dtypes: ``Linear`` is
``nn.Dense(dtype=...)`` (the Q/K/V projections compute in the config's
dtype, every other dense in its input's), LayerNorm computes in float32
and returns its input's dtype, the attention scores and softmax are
float32 (ops/attention.py), and the decode caches keep the compute dtype.

With ``cfg.remat`` the encoder and decoder stacks recompute each layer on
the backward pass (``remat_layer``), svpc_tpu's ``nn.remat``; the values
are unchanged.

Under tensor parallelism (``SVPCModel.shard``, parallel/mesh.py) a module
holds its tp shards and its ``tp_dims`` say which: a ``Linear`` whose
weight is split on dim 0 is column-parallel (Q/K/V, the FFN
intermediate, the vocab projection), on dim 1 row-parallel (the
attention output and FFN output projections, all-reduced), a
``MultiHeadAttention`` then holds ``num_heads / tp`` heads, and the
decoder gathers the heads before its LayerNorms.  Dropout draws over the
global shape (``parallel.mesh.uniform``).

On a mesh with a pp axis (``SVPCModel.shard``) the clip encoder and the
decoder hold only their stage's layers (``StageLayers``) and run them
through the GPipe schedule of parallel/pipeline.py (``_pp_trunk_call``,
svpc_tpu's ``Encoder._pp_call`` / ``Decoder._pp_call``); the decoder's
KV-cached ``step`` stays sequential, as in svpc_tpu.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from svpc_torch.config import ModelConfig
from svpc_torch.ops.attention import attention_plain, fused_attention
from svpc_torch.parallel.collectives import (copy_to_tp, gather_from_tp,
                                             reduce_from_tp, trunk_entry)
from svpc_torch.parallel.mesh import fresh_generator, module_tp_dim, uniform
from svpc_torch.parallel.pipeline import (StageDraws, auto_microbatches,
                                          gpipe, merge_microbatches,
                                          split_microbatches)
from svpc_torch.precision import check_compute_dtype


def erf_gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf-based) gelu, matching reference model.py:58-64; computed
    in float32 and rounded once to the input's dtype, as XLA fuses it."""
    x32 = x.float()
    return (x32 * 0.5 * (1.0 + torch.erf(x32 / math.sqrt(2.0)))).to(x.dtype)


class Linear(nn.Linear):
    """``flax.linen.Dense(dtype=...)``: float32 parameters, the product in
    ``compute_dtype`` when one is given, else in the input's dtype, with
    input, weight and bias cast to it (in float32 this is ``nn.Linear``).
    Under autograd the casts stay in the graph, so gradients reach the
    float32 parameters in float32, as in JAX.

    An eval-mode module outside autograd keeps its cast weight and bias:
    an eager decode step would otherwise cast every weight again.  The
    copy is keyed by the parameters' storage, dtype, device and version,
    so a device move, a load or an in-place update rebuilds it.

    Under tp (``tp_dims``) a weight split on dim 0 makes it
    column-parallel (its input enters through ``copy_to_tp``, its output
    holds this rank's features), on dim 1 row-parallel (it takes this
    rank's input features, cut from a whole input when given one, and
    all-reduces the partial products before adding the bias)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = compute_dtype
        self._cast = None

    def _params_in(self, dtype: torch.dtype):
        w, b = self.weight, self.bias
        if self.training or torch.is_grad_enabled():
            return w.to(dtype), (None if b is None else b.to(dtype))
        key = (dtype,) + tuple(None if p is None else (
            p.data_ptr(), p.dtype, p.device, p._version) for p in (w, b))
        if self._cast is None or self._cast[0] != key:
            self._cast = (key, w.detach().to(dtype),
                          None if b is None else b.detach().to(dtype))
        return self._cast[1], self._cast[2]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        split = module_tp_dim(self)
        if split == 0:
            x = copy_to_tp(x, self.mesh.tp_group)
        elif split == 1 and x.shape[-1] != self.weight.shape[1]:
            n = self.weight.shape[1]
            lo = self.mesh.tp_index * n
            x = copy_to_tp(x, self.mesh.tp_group)[..., lo:lo + n]
        dtype = self.compute_dtype or x.dtype
        if dtype == self.weight.dtype:
            w, b = self.weight, self.bias
        else:
            w, b = self._params_in(dtype)
        if split != 1:
            return F.linear(x.to(dtype), w, b)
        y = reduce_from_tp(F.linear(x.to(dtype), w), self.mesh.tp_group)
        return y if b is None else y + b


class LayerNorm(nn.Module):
    """TF-style layernorm (eps inside the sqrt), reference model.py:143-156:
    two-pass biased variance E[(x-u)^2], computed in float32 and returned
    in the input's dtype (svpc_tpu/model/layers.py:35-50).  A
    ``residual`` is added to x in float32 first: svpc_tpu's residual add
    and norm are one fused step."""

    def __init__(self, size: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size))
        self.bias = nn.Parameter(torch.zeros(size))
        self.eps = eps

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        x32 = x.float() if residual is None else x.float() + residual
        u = x32.mean(-1, keepdim=True)
        d = x32 - u
        var = (d * d).mean(-1, keepdim=True)
        out = d * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return out.to(x.dtype)


def _dropout(x: torch.Tensor, p: float, deterministic: bool,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout whose mask is drawn from ``generator`` (over the
    global shape under a mesh: ``parallel.mesh.uniform``)."""
    if deterministic or p == 0.0:
        return x
    keep = uniform(x.shape, generator, x.device) >= p
    return x * keep / (1.0 - p)


class MultiHeadAttention(nn.Module):
    """QKV projections + attention; no output projection (reference
    BertSelfAttention, model.py:159-220).  ``project_q`` / ``project_kv``
    / ``attend`` let cached decoding drive the pieces separately.  The
    projections compute in the config's dtype whatever their input's
    (svpc_tpu/model/layers.py:98-101)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.dropout_p = cfg.attention_probs_dropout_prob
        dt = check_compute_dtype(cfg)
        self.query = Linear(h, h, compute_dtype=dt)
        self.key = Linear(h, h, compute_dtype=dt)
        self.value = Linear(h, h, compute_dtype=dt)

    def project_q(self, x):
        return self.query(x)

    def project_kv(self, x):
        return self.key(x), self.value(x)

    def attend(self, q, k, v, mask):
        return fused_attention(q, k, v, mask, self.num_heads)

    def forward(self, q_states, k_states, v_states, mask,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        q = self.query(q_states)
        k = self.key(k_states)
        v = self.value(v_states)
        if deterministic:
            return fused_attention(q, k, v, mask, self.num_heads)
        # training: the differentiable plain version, dropout included
        # (svpc_tpu/model/layers.py:119-128; the kernel has no backward)
        return attention_plain(q, k, v, mask, self.num_heads,
                               dropout_p=self.dropout_p, generator=generator,
                               head_split=module_tp_dim(self.query) == 0)

    def whole(self, ctx):
        """The attention's output with every head: under tp each rank
        holds its heads' columns, gathered here."""
        if module_tp_dim(self.query) == 0:
            return gather_from_tp(ctx, self.mesh.tp_group)
        return ctx


class SelfOutput(nn.Module):
    """dense -> dropout -> LN(x + residual) (reference model.py:222-233);
    also the reference's BertOutput (model.py:278-289)."""

    def __init__(self, cfg: ModelConfig, in_features: int):
        super().__init__()
        self.dense = Linear(in_features, cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.dropout_p = cfg.hidden_dropout_prob

    def forward(self, hidden, residual, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        h = _dropout(self.dense(hidden), self.dropout_p, deterministic,
                     generator)
        return self.LayerNorm(h, residual)


class AttentionBlock(nn.Module):
    """Self-attention + SelfOutput (reference BertAttention)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.self = MultiHeadAttention(cfg)
        self.output = SelfOutput(cfg, cfg.hidden_size)

    def forward(self, x, mask, deterministic: bool = True, generator=None):
        ctx = self.self(x, x, x, mask, deterministic, generator)
        return self.output(ctx, x, deterministic, generator)


class Intermediate(nn.Module):
    """dense -> gelu (reference BertIntermediate)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        return erf_gelu(self.dense(x))


class EncoderLayer(nn.Module):
    """Untied encoder layer (reference BertLayerNoMemoryUntied)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.attention = AttentionBlock(cfg)
        self.hidden_intermediate = Intermediate(cfg)
        self.output = SelfOutput(cfg, cfg.intermediate_size)

    def forward(self, x, mask_1d, diagonal_mask: bool = False,
                deterministic: bool = True, generator=None):
        mask = mask_1d[:, None, :]  # (N, 1, L) key padding
        if diagonal_mask:
            lq = x.shape[1]
            causal = torch.tril(torch.ones(lq, lq, dtype=x.dtype,
                                           device=x.device))
            mask = mask * causal[None]
        attn_out = self.attention(x, mask, deterministic, generator)
        inter = self.hidden_intermediate(attn_out)
        return self.output(inter, attn_out, deterministic, generator)


def remat_layer(layer: nn.Module, generator: Optional[torch.Generator],
                *args):
    """``layer(*args, generator=...)`` that keeps only its inputs for the
    backward pass and recomputes the rest there (``torch.utils.checkpoint``;
    svpc_tpu's ``nn.remat``).

    Dropout draws from the explicit ``generator``, which checkpoint's
    ``preserve_rng_state`` does not save, so both the forward and the
    recomputation run from clones of its state at entry (the same masks),
    and the generator is then left where the unwrapped forward leaves it."""
    if generator is None:
        return torch.utils.checkpoint.checkpoint(
            layer, *args, use_reentrant=False)
    entry = generator.get_state()
    after = []

    def run(*inputs):
        g = fresh_generator(generator)
        g.set_state(entry)
        out = layer(*inputs, generator=g)
        if not after:  # the first forward, not the recomputation
            after.append(g.get_state())
        return out

    out = torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)
    generator.set_state(after[0])
    return out


def _run_layers(layers, remat: bool, x, *args, deterministic: bool,
                generator):
    """x through each layer; rematerialized when ``remat`` is set and
    autograd records (the incremental decode ``step`` is never wrapped)."""
    remat = remat and torch.is_grad_enabled()
    for layer in layers:
        if remat:
            x = remat_layer(layer, generator, x, *args, deterministic)
        else:
            x = layer(x, *args, deterministic, generator)
    return x


class StageLayers(nn.Module):
    """A pipeline stage's block of a trunk's layers under their global
    indices, so the state-dict names stay ``layer.<i>``; iterates them in
    order, as the ``nn.ModuleList`` it replaces."""

    def __init__(self, layers: nn.ModuleList, keep: range):
        super().__init__()
        for i in keep:
            self.add_module(str(i), layers[i])
        self.indices = list(keep)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self) -> int:
        return len(self._modules)


class _Pipelined:
    """A trunk's place on the pipeline: the mesh and the requested
    microbatch count (0: auto)."""

    def __init__(self, mesh, microbatches: int):
        self.mesh, self.microbatches = mesh, microbatches


def _pp_trunk_call(owner, x, riding, consts, deterministic: bool,
                   generator):
    """x through the owner's stage-resident layers on the GPipe schedule
    (svpc_tpu/model/layers.py ``_pp_trunk_call``): ``riding`` are the
    batch-major tensors each layer reads unchanged (masks, the encoder
    output), ``consts`` its other arguments; each layer is called
    ``layer(h, *riding, *consts, deterministic, generator)``.  The batch
    is split into microbatches (``auto_microbatches``), dropout draws
    come from a ``StageDraws`` of ``generator``, and ``--remat`` wraps
    each layer application, as svpc_tpu's ``gpipe(remat=cfg.remat)``."""
    pl = owner.pipelined
    mesh = pl.mesh
    n_micro = auto_microbatches(x.shape[0] * mesh.dp_size, pl.microbatches,
                                mesh.dp_size, mesh.pp_size)
    ins = [trunk_entry(x, mesh.pp_group)] + [
        trunk_entry(r, mesh.pp_group) if r.requires_grad else r
        for r in riding]
    mbs = [split_microbatches(a, n_micro) for a in ins]
    layers = list(zip(owner.layer.indices, owner.layer))
    remat = owner.remat and torch.is_grad_enabled()
    draws = None
    if not deterministic and (owner.dropout_p > 0):
        def probe(rec):
            layers[0][1](mbs[0][0][:1], *(m[0][:1] for m in mbs[1:]),
                         *consts, False, rec)

        draws = StageDraws(generator, len(layers) * mesh.pp_size,
                           owner.layer.indices, probe, x.shape[0], n_micro,
                           x.device)

    def stage(act, j):
        h, *rest = act
        for i, layer in layers:
            g = None if draws is None else draws.for_layer(i, j)
            if remat:
                h = remat_layer(layer, g, h, *rest, *consts, deterministic)
            else:
                h = layer(h, *rest, *consts, deterministic, g)
        return (h, *rest)

    return merge_microbatches(gpipe(stage, mbs, mesh))


class Encoder(nn.Module):
    """Stack of EncoderLayers (reference BertEncoderNoMemoryUntied);
    ``pipelined`` (set by ``SVPCModel.shard`` on a pp mesh) routes it
    through the GPipe schedule over its stage's layers."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.remat = cfg.remat
        self.dropout_p = max(cfg.hidden_dropout_prob,
                             cfg.attention_probs_dropout_prob)
        self.pipelined: Optional[_Pipelined] = None
        self.layer = nn.ModuleList(EncoderLayer(cfg)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, x, mask_1d, diagonal_mask: bool = False,
                deterministic: bool = True, generator=None):
        if self.pipelined is not None:
            return _pp_trunk_call(self, x, (mask_1d,), (diagonal_mask,),
                                  deterministic, generator)
        return _run_layers(self.layer, self.remat, x, mask_1d,
                           diagonal_mask, deterministic=deterministic,
                           generator=generator)


class DecoderLayer(nn.Module):
    """Untied decoder layer (reference BertDecoderLayerNoMemoryUntied):
    causal self-attn -> LN residual -> cross-attn -> LN residual (the
    residual is the self-attn output) -> output block."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.self_attention = MultiHeadAttention(cfg)
        self.norm1 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.dec_enc_attention = MultiHeadAttention(cfg)
        self.norm2 = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.output = SelfOutput(cfg, cfg.hidden_size)

    def forward(self, dec, dec_mask, enc_out, enc_mask,
                deterministic: bool = True, generator=None):
        lt = dec.shape[1]
        causal = torch.tril(torch.ones(lt, lt, dtype=dec.dtype,
                                       device=dec.device))
        self_mask = dec_mask[:, None, :] * causal[None]  # (N, T, T) full
        attn = self.self_attention.whole(self.self_attention(
            dec, dec, dec, self_mask, deterministic, generator))
        attn = self.norm1(attn, dec)
        cross = self.dec_enc_attention.whole(self.dec_enc_attention(
            attn, enc_out, enc_out, enc_mask[:, None, :], deterministic,
            generator))
        cross = self.norm2(attn, cross)
        return self.output(cross, cross, deterministic, generator)

    def project_enc_kv(self, enc_out):
        """Cross-attention K/V of the static encoder memory, projected once
        per decode."""
        return self.dec_enc_attention.project_kv(enc_out)

    def step(self, x_t, k_cache, v_cache, t: int, enc_k, enc_v, enc_mask):
        """Incremental decode for position ``t``.

        x_t (N, 1, H); k_cache/v_cache (N, T, H; H / tp under tp, this
        rank's heads) hold the projected
        self-attention keys/values of positions < t and are updated IN
        PLACE at row t (the JAX package returns new arrays), in their own
        dtype, and are read in x_t's; slots beyond t are masked out
        exactly.  Returns y_t (N, 1, H)."""
        n, T, _ = k_cache.shape
        k_t, v_t = self.self_attention.project_kv(x_t)
        k_cache[:, t:t + 1] = k_t
        v_cache[:, t:t + 1] = v_t
        q_t = self.self_attention.project_q(x_t)
        pos_ok = (torch.arange(T, device=x_t.device) <= t).to(x_t.dtype)
        attn = self.self_attention.whole(self.self_attention.attend(
            q_t, k_cache.to(x_t.dtype), v_cache.to(x_t.dtype),
            pos_ok.expand(n, 1, T)))
        attn = self.norm1(attn, x_t)
        cross_q = self.dec_enc_attention.project_q(attn)
        cross = self.dec_enc_attention.whole(self.dec_enc_attention.attend(
            cross_q, enc_k, enc_v, enc_mask[:, None, :]))
        cross = self.norm2(attn, cross)
        return self.output(cross, cross, True)


class Decoder(nn.Module):
    """``pipelined`` routes the teacher-forced stack through the GPipe
    schedule as Encoder's; the incremental ``step`` / ``project_enc_kv``
    decode stays sequential (svpc_tpu does not pipeline it: per-token
    KV-cached work is latency-bound), on a model holding the whole
    trunk."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.remat = cfg.remat
        self.dropout_p = max(cfg.hidden_dropout_prob,
                             cfg.attention_probs_dropout_prob)
        self.pipelined: Optional[_Pipelined] = None
        self.layer = nn.ModuleList(DecoderLayer(cfg)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, dec, dec_mask, enc_out, enc_mask,
                deterministic: bool = True, generator=None):
        if self.pipelined is not None:
            return _pp_trunk_call(self, dec, (dec_mask, enc_out, enc_mask),
                                  (), deterministic, generator)
        return _run_layers(self.layer, self.remat, dec, dec_mask, enc_out,
                           enc_mask, deterministic=deterministic,
                           generator=generator)

    def project_enc_kv(self, enc_out) -> List[Tuple[torch.Tensor,
                                                    torch.Tensor]]:
        return [layer.project_enc_kv(enc_out) for layer in self.layer]

    def step(self, x_t, caches, t: int, enc_kv, enc_mask):
        """One incremental position through all layers; ``caches`` (a list
        of per-layer (k, v)) are updated in place."""
        for layer, (k_c, v_c), (e_k, e_v) in zip(self.layer, caches, enc_kv):
            x_t = layer.step(x_t, k_c, v_c, t, e_k, e_v, enc_mask)
        return x_t


class PredictionHeadTransform(nn.Module):
    """dense -> gelu -> LN (reference model.py:697-709)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.dense = Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x):
        return self.LayerNorm(erf_gelu(self.dense(x)))


class LMPredictionHead(nn.Module):
    """transform -> vocab projection (+bias) (reference model.py:712-739).
    With ``share_wd_cls_weight`` the caller passes the tied word embedding
    (vocab, H) as ``shared_embedding``.  Under tp the projection, the
    bias (and a shared table) hold this rank's vocab rows: the logits are
    gathered over tp before the padding columns are dropped."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.vocab_size = cfg.vocab_size
        self.transform = PredictionHeadTransform(cfg)
        if not cfg.share_wd_cls_weight:
            self.decoder = Linear(cfg.hidden_size, cfg.padded_vocab_size,
                                  bias=False)
        self.bias = nn.Parameter(torch.zeros(cfg.padded_vocab_size))

    def forward(self, x, shared_embedding: Optional[torch.Tensor] = None):
        h = self.transform(x)
        vocab_split = module_tp_dim(self, "bias") == 0
        if shared_embedding is not None:
            if vocab_split:
                h = copy_to_tp(h, self.mesh.tp_group)
            logits = h @ shared_embedding.T.to(h.dtype)
        else:
            logits = self.decoder(h)
        # the bias in the logits' dtype; drop vocab-padding columns:
        # everything downstream sees V logits
        logits = logits + self.bias.to(logits.dtype)
        if vocab_split:
            logits = gather_from_tp(logits, self.mesh.tp_group)
        return logits[..., :self.vocab_size]
