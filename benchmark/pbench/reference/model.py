"""The plain reference of the state-aware captioner, in float32 PyTorch.

Frozen from svpc_torch/model/{svpc,layers,embeddings,reasoner,lstm,
pointer}.py and svpc_torch/ops/{attention,gumbel,losses}.py at commit
aeb5374 (the plain paths only: no kernel, no KV cache, no tensor or
pipeline parallelism, no bfloat16).  It imports nothing of the program.
Parameter names are the program's state-dict names, so one seeded state
dict loads into both.  Every attention is the plain masked softmax, in
float32 with TF32 off; every dropout mask and the Gumbel noise come from
the ``generator`` passed down, drawn in the program's order and shapes, so
a training step with the same seed draws the same masks.

Departures from the published model (ACM MM 2021, awkrail/svpc
src/rtransformer/model.py) are the program's own and are kept: the
additive mask ``(1 - m) * -1e4``, the one-hot straight-through Gumbel
sample over each row's extended vocabulary, the fixed-shape entity and
OOV budgets.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

PAD, CLS, SEP, VID, BOS, EOS, UNK = range(7)
IGNORE = -1
NEG_INF = -1e30


def plain_numerics() -> None:
    """float32 products in full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sinusoid_table(max_len: int, dim: int) -> torch.Tensor:
    pe = np.zeros((max_len, dim), dtype=np.float32)
    position = np.arange(0, max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                      * -(math.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return torch.from_numpy(pe)


def dropout(x, p, train, generator):
    if not train or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep / (1.0 - p)


def gelu(x):
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def attention(q, k, v, mask, num_heads, dropout_p=0.0, generator=None):
    """q (N, Lq, H), k/v (N, Lk, H), mask (N, 1|Lq, Lk) of 1/0."""
    n, lq, h = q.shape
    lk = k.shape[1]
    dh = h // num_heads
    qh = q.reshape(n, lq, num_heads, dh).transpose(1, 2)
    kh = k.reshape(n, lk, num_heads, dh).transpose(1, 2)
    vh = v.reshape(n, lk, num_heads, dh).transpose(1, 2)
    scores = qh @ kh.transpose(-1, -2) / math.sqrt(dh)
    scores = scores + (1.0 - mask[:, None]) * -10000.0
    probs = torch.softmax(scores, dim=-1)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) >= dropout_p
        probs = probs * keep / (1.0 - dropout_p)
    return (probs @ vh).transpose(1, 2).reshape(n, lq, h)


class LayerNorm(nn.Module):
    """TF-style: eps inside the square root, biased variance."""

    def __init__(self, size, eps):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size))
        self.bias = nn.Parameter(torch.zeros(size))
        self.eps = eps

    def forward(self, x):
        u = x.mean(-1, keepdim=True)
        d = x - u
        var = (d * d).mean(-1, keepdim=True)
        return d * torch.rsqrt(var + self.eps) * self.weight + self.bias


class MultiHeadAttention(nn.Module):
    def __init__(self, c):
        super().__init__()
        h = c["hidden_size"]
        self.num_heads = c["num_attention_heads"]
        self.p = c["attention_probs_dropout_prob"]
        self.query, self.key, self.value = (nn.Linear(h, h) for _ in range(3))

    def forward(self, xq, xkv, mask, train, generator):
        return attention(self.query(xq), self.key(xkv), self.value(xkv),
                         mask, self.num_heads, self.p if train else 0.0,
                         generator)


class SelfOutput(nn.Module):
    def __init__(self, c, d_in):
        super().__init__()
        self.dense = nn.Linear(d_in, c["hidden_size"])
        self.LayerNorm = LayerNorm(c["hidden_size"], c["layer_norm_eps"])
        self.p = c["hidden_dropout_prob"]

    def forward(self, x, residual, train, generator):
        h = dropout(self.dense(x), self.p, train, generator)
        return self.LayerNorm(h + residual)


class AttentionBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.self = MultiHeadAttention(c)
        self.output = SelfOutput(c, c["hidden_size"])

    def forward(self, x, mask, train, generator):
        return self.output(self.self(x, x, mask, train, generator), x,
                           train, generator)


class Intermediate(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.dense = nn.Linear(c["hidden_size"], c["intermediate_size"])

    def forward(self, x):
        return gelu(self.dense(x))


class EncoderLayer(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.attention = AttentionBlock(c)
        self.hidden_intermediate = Intermediate(c)
        self.output = SelfOutput(c, c["intermediate_size"])

    def forward(self, x, mask_1d, train, generator):
        a = self.attention(x, mask_1d[:, None, :], train, generator)
        return self.output(self.hidden_intermediate(a), a, train, generator)


class Encoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.layer = nn.ModuleList(EncoderLayer(c)
                                   for _ in range(c["num_hidden_layers"]))

    def forward(self, x, mask_1d, train, generator):
        for layer in self.layer:
            x = layer(x, mask_1d, train, generator)
        return x


class DecoderLayer(nn.Module):
    def __init__(self, c):
        super().__init__()
        h, eps = c["hidden_size"], c["layer_norm_eps"]
        self.self_attention = MultiHeadAttention(c)
        self.norm1 = LayerNorm(h, eps)
        self.dec_enc_attention = MultiHeadAttention(c)
        self.norm2 = LayerNorm(h, eps)
        self.output = SelfOutput(c, h)

    def forward(self, dec, dec_mask, enc, enc_mask, train, generator):
        t = dec.shape[1]
        causal = torch.tril(torch.ones(t, t, device=dec.device))
        a = self.self_attention(dec, dec, dec_mask[:, None, :] * causal[None],
                                train, generator)
        a = self.norm1(a + dec)
        x = self.dec_enc_attention(a, enc, enc_mask[:, None, :], train,
                                   generator)
        x = self.norm2(a + x)
        return self.output(x, x, train, generator)


class Decoder(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.layer = nn.ModuleList(DecoderLayer(c)
                                   for _ in range(c["num_hidden_layers"]))

    def forward(self, dec, dec_mask, enc, enc_mask, train, generator):
        for layer in self.layer:
            dec = layer(dec, dec_mask, enc, enc_mask, train, generator)
        return dec


class WordFC(nn.Sequential):
    """LN -> dropout -> Linear -> ReLU -> LN; indices 0/2/4 as the
    program names them."""

    def __init__(self, c, d_in):
        super().__init__(LayerNorm(d_in, c["layer_norm_eps"]), nn.Identity(),
                         nn.Linear(d_in, c["hidden_size"]), nn.Identity(),
                         LayerNorm(c["hidden_size"], c["layer_norm_eps"]))
        self.p = c["hidden_dropout_prob"]

    def forward(self, x, train, generator):
        h = dropout(self[0](x), self.p, train, generator)
        return self[4](torch.relu(self[2](h)))


class TextEmbeddings(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.word_embeddings = nn.Embedding(c["vocab_size"],
                                            c["word_vec_size"])
        self.word_fc = WordFC(c, c["word_vec_size"])
        self.register_buffer("pe", sinusoid_table(
            c["max_v_len"] + c["max_t_len"], c["hidden_size"]),
            persistent=False)

    def forward(self, ids, train, generator):
        e = self.word_fc(self.word_embeddings(ids), train, generator)
        return e + self.pe[:e.shape[-2]]


class VideoEmbeddings(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.video_embeddings = WordFC(c, c["video_feature_size"])
        self.register_buffer("pe", sinusoid_table(
            c["max_v_len"] + c["max_t_len"], c["hidden_size"]),
            persistent=False)

    def forward(self, feats, train, generator):
        e = self.video_embeddings(feats, train, generator)
        return e + self.pe[:e.shape[-2]]


class IngredientEmbeddings(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.max_entities = c["max_entities"]
        self.word_embeddings = nn.Embedding(c["vocab_size"],
                                            c["word_vec_size"])
        self.word_fc = WordFC(c, c["word_vec_size"])
        self.register_buffer("pe", sinusoid_table(
            max(c["max_v_len"] + c["max_t_len"], c["max_entities"]),
            c["hidden_size"]), persistent=False)

    def forward(self, ids, sep_mask, train, generator):
        e = self.word_fc(self.word_embeddings(ids), train, generator)
        # entity k averages the words strictly between [SEP] k-1 and k
        sep = sep_mask.float()
        seg = torch.cumsum(sep, -1) - sep
        ents = torch.arange(self.max_entities, device=ids.device,
                            dtype=seg.dtype)
        member = (seg[..., None, :] == ents[:, None]).float() \
            * (1.0 - sep)[..., None, :]
        member = member * (ents[:, None] < sep.sum(-1, keepdim=True)[
            ..., None, :]).float()
        pool = member / member.sum(-1, keepdim=True).clamp(min=1.0)
        pooled = torch.einsum("bei,bih->beh", pool, e)
        return pooled + self.pe[:pooled.shape[-2]]


class ReasonerOutputs(NamedTuple):
    ent_probs: torch.Tensor
    ac_probs: torch.Tensor
    step_entity_vectors: torch.Tensor
    all_entity_vectors: torch.Tensor
    step_action_vectors: torch.Tensor


def _safe_div(num, den):
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


class EntityReasoner(nn.Module):
    """The visual simulator (Eq. 1-6): action selector, entity selector
    and the gated entity update, step by step."""

    def __init__(self, c):
        super().__init__()
        H, L, A = (c["hidden_size"], c["lstm_hidden_size"],
                   c["action_vocab_size"])
        W = c["word_vec_size"]
        self.p = c["reasoner_dropout_prob"]
        self.action_selector = nn.Sequential(nn.Linear(H, L), nn.ReLU(),
                                             nn.Identity(), nn.Linear(L, A))
        self.action_embeddings = nn.Parameter(torch.zeros(A, W))
        self.W1 = nn.Sequential(nn.Linear(H, L), nn.ReLU())
        self.W2 = nn.Linear(L + A, L)
        self.W3 = nn.Linear(L, 3)
        self.W4 = nn.Linear(W, 1)

    def forward(self, steps, ents, emask, train, generator):
        B, S, _ = steps.shape
        E = ents.shape[1]
        h = torch.relu(self.action_selector[0](steps))
        h = dropout(h, self.p, train, generator)
        ac = torch.sigmoid(self.action_selector[3](h))
        bar_ft = _safe_div(ac, ac.sum(-1, keepdim=True)) \
            @ self.action_embeddings
        hat = self.W1(steps)
        w2 = self.W2(torch.cat([hat, ac], -1))
        choice = torch.softmax(self.W3(hat), -1)
        w4 = self.W4(bar_ft)
        entities = ents * emask[..., None]
        prev = steps.new_zeros(B, E)
        ps, bars, alls = [], [], []
        for s in range(S):
            p = torch.sigmoid(torch.einsum("beh,bh->be", entities,
                                           w2[:, s])) * emask
            c = choice[:, s]
            a = c[:, 0:1] * p + c[:, 1:2] * prev
            bar = torch.einsum("be,beh->bh",
                               _safe_div(a, a.sum(-1, keepdim=True)),
                               entities)
            k = torch.relu(w4[:, s] * bar)
            entities = a[..., None] * k[:, None] + (1.0 - a)[..., None] \
                * entities
            prev = p
            ps.append(p)
            bars.append(bar)
            alls.append(entities)
        return ReasonerOutputs(torch.stack(ps, 1), ac, torch.stack(bars, 1),
                               torch.stack(alls, 1), bar_ft)


class BiLSTM(nn.Module):
    def __init__(self, d_in, hidden):
        super().__init__()
        self.hidden_size = hidden
        for sfx in ("l0", "l0_reverse"):
            setattr(self, f"weight_ih_{sfx}",
                    nn.Parameter(torch.zeros(4 * hidden, d_in)))
            setattr(self, f"weight_hh_{sfx}",
                    nn.Parameter(torch.zeros(4 * hidden, hidden)))
            setattr(self, f"bias_ih_{sfx}",
                    nn.Parameter(torch.zeros(4 * hidden)))
            setattr(self, f"bias_hh_{sfx}",
                    nn.Parameter(torch.zeros(4 * hidden)))

    def _run(self, x, mask, sfx, reverse):
        w_ih, w_hh = (getattr(self, f"weight_{k}_{sfx}") for k in ("ih", "hh"))
        b_ih, b_hh = (getattr(self, f"bias_{k}_{sfx}") for k in ("ih", "hh"))
        b, s, _ = x.shape
        h = x.new_zeros(b, self.hidden_size)
        c = x.new_zeros(b, self.hidden_size)
        xp = x @ w_ih.T + b_ih
        outs = [None] * s
        for t in (range(s - 1, -1, -1) if reverse else range(s)):
            i, f, g, o = (xp[:, t] + h @ w_hh.T + b_hh).chunk(4, -1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            m = mask[:, t, None]
            h = torch.where(m > 0, h_new, h)
            c = torch.where(m > 0, c_new, c)
            outs[t] = h_new * m
        return torch.stack(outs, 1)

    def forward(self, x, mask):
        return torch.cat([self._run(x, mask, "l0", False),
                          self._run(x, mask, "l0_reverse", True)], -1)


class PredictionHeadTransform(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.dense = nn.Linear(c["hidden_size"], c["hidden_size"])
        self.LayerNorm = LayerNorm(c["hidden_size"], c["layer_norm_eps"])

    def forward(self, x):
        return self.LayerNorm(gelu(self.dense(x)))


class LMPredictionHead(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.transform = PredictionHeadTransform(c)
        self.decoder = nn.Linear(c["hidden_size"], c["vocab_size"],
                                 bias=False)
        self.bias = nn.Parameter(torch.zeros(c["vocab_size"]))

    def forward(self, x):
        return self.decoder(self.transform(x)) + self.bias


class Encoded(NamedTuple):
    step_vectors: torch.Tensor
    ingr_vectors: torch.Tensor
    ga_inputs: torch.Tensor
    pointer_vectors: Optional[torch.Tensor]
    reasoner: Optional[ReasonerOutputs]


def scatter_clips(batch, rows, grid_shape):
    cmask = batch["clip_mask"].reshape((-1,) + (1,) * (rows.dim() - 1))
    grid = rows.new_zeros(grid_shape + rows.shape[1:])
    return grid.index_put((batch["clip_video"], batch["clip_step"]),
                          rows * cmask, accumulate=True)


def clip_view(batch):
    cv = batch["clip_video"]
    return {k: batch[k][cv]
            for k in ("entity_mask", "copy_ids", "copy_weights", "oov_count")}


# --------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------- #

def label_smoothing_kl(probs, labels, ext_size, ls, eps=1e-12):
    n, c = probs.shape
    cols = torch.arange(c, device=probs.device)[None, :]
    ext = ext_size[:, None]
    smooth = ls / (ext_size.float() - 1.0)
    zero = probs.new_zeros(())
    target = torch.where(cols < ext, smooth[:, None], zero)
    target = torch.where(cols == ext - 1, zero, target)
    target = torch.where(cols == labels.clamp(0, c - 1)[:, None],
                         probs.new_tensor(1.0 - ls), target)
    terms = torch.where(target > 0, target * (
        torch.log(target.clamp(min=eps)) - torch.log(probs + eps)), zero)
    return (terms.sum(-1) * (labels != IGNORE).float()).sum()


def bce_sum(probs, targets, mask):
    tiny = 1e-35
    logp = torch.log(probs.clamp(min=tiny)).clamp(min=-100.0)
    log1mp = torch.log((1.0 - probs).clamp(min=tiny)).clamp(min=-100.0)
    return (-(targets * logp + (1.0 - targets) * log1mp) * mask).sum()


def asymmetric_loss_sum(probs, targets, row_mask, gamma_neg=4.0,
                        gamma_pos=1.0, clip=0.05, eps=1e-8):
    xs_neg = (1.0 - probs + clip).clamp(max=1.0)
    loss = (targets * torch.log(probs.clamp(min=eps))
            + (1.0 - targets) * torch.log(xs_neg.clamp(min=eps)))
    pt = probs * targets + xs_neg * (1.0 - targets)
    gamma = gamma_pos * targets + gamma_neg * (1.0 - targets)
    loss = loss * torch.pow((1.0 - pt).clamp(min=1e-38), gamma)
    return -(loss * row_mask[..., None]).sum()


# --------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------- #

class ReferenceModel(nn.Module):
    """``c`` is the configuration file's dict of model sizes.  Modes:
    "full" (vivt), "reason_copy" (viv), "copy" (vi), "video" (v)."""

    def __init__(self, c: Dict):
        super().__init__()
        plain_numerics()
        self.c = c
        mode = c["model_mode"]
        H = c["hidden_size"]
        if mode != "video":
            self.ingredient_embeddings = IngredientEmbeddings(c)
        self.video_embeddings = VideoEmbeddings(c)
        self.text_embeddings = TextEmbeddings(c)
        self.token_type_embeddings = nn.Embedding(c["type_vocab_size"], H)
        self.encoder = Encoder(c)
        self.step_wise_encoder = Encoder(c)
        self.register_buffer("step_pe", sinusoid_table(50, H),
                             persistent=False)
        if mode in ("full", "reason_copy"):
            self.reasoner = EntityReasoner(c)
            self.Wac = nn.Sequential(nn.Linear(c["word_vec_size"], H))
            self.Went = nn.Sequential(nn.Linear(H, H))
        self.decoder = Decoder(c)
        self.decoder_classifier = LMPredictionHead(c)
        if mode != "video":
            self.Wing = nn.Linear(H, c["intermediate_size"])
            self.pgen_linear = nn.Sequential(nn.Linear(2 * H, 1))
        if mode == "full":
            self.recipe_encoder = BiLSTM(c["word_vec_size"], H)
            self.recipe_reasoner = EntityReasoner(c)

    # -- encoding ------------------------------------------------------ #

    def _clips(self, feats, ids, mask, train, g):
        e = self.video_embeddings(feats, train, g)
        e = e + self.token_type_embeddings(ids)
        return self.encoder(e, mask, train, g)[:, 0]

    def encode(self, batch, train=False, g=None) -> Encoded:
        c = self.c
        mode = c["model_mode"]
        T = c["max_t_len"]
        packed = "clip_video" in batch
        B, S = batch["step_mask"].shape
        if packed:
            Lv = batch["clip_input_ids"].shape[1] - T
            cls = self._clips(batch["clip_video_feature"][:, :Lv],
                              batch["clip_input_ids"][:, :Lv],
                              batch["clip_input_mask"][:, :Lv], train, g)
            grid = scatter_clips(batch, cls, (B, S))
        else:
            Lv = batch["input_ids"].shape[2] - T
            flat = lambda x: x.reshape((B * S,) + x.shape[2:])
            cls = self._clips(flat(batch["video_feature"][:, :, :Lv]),
                              flat(batch["input_ids"][:, :, :Lv]),
                              flat(batch["input_mask"][:, :, :Lv]), train, g)
            grid = cls.reshape(B, S, -1)
        steps = self.step_wise_encoder(grid + self.step_pe[:S],
                                       batch["step_mask"], train, g)
        H = steps.shape[-1]
        ingr = r = pointer = None
        if mode != "video":
            ingr = self.ingredient_embeddings(
                batch["ingr_ids"], batch["ingr_sep_mask"], train, g)
            ingr = ingr * batch["entity_mask"][..., None]
        if mode in ("full", "reason_copy"):
            r = self.reasoner(steps, ingr, batch["entity_mask"], train, g)
            ga = torch.stack([steps,
                              torch.relu(self.Went(r.step_entity_vectors)),
                              torch.relu(self.Wac(r.step_action_vectors))], 2)
            pointer = r.all_entity_vectors
        elif mode == "copy":
            em = batch["entity_mask"][..., None]
            mean = (ingr * em).sum(1) / em.sum(1).clamp(min=1.0)
            ga = torch.stack([steps, mean[:, None].expand_as(steps)], 2)
            pointer = ingr[:, None].expand((B, S) + ingr.shape[1:])
        else:
            ga = steps[:, :, None]
        if packed:
            cv, cs = batch["clip_video"], batch["clip_step"]
            ga = ga[cv, cs][:, None]
            if pointer is not None:
                pointer = pointer[cv, cs][:, None]
        if ingr is None:
            ingr = steps.new_zeros(B, c["max_entities"], H)
        return Encoded(steps, ingr, ga, pointer, r)

    # -- decoding ------------------------------------------------------ #

    def head_probs(self, batch, state, dec):
        """(B, S, T, C) probabilities over each row's extended vocabulary
        (the vocabulary, then the copied out-of-vocabulary words)."""
        c = self.c
        V, n_oov = c["vocab_size"], c["max_oov"]
        vocab = torch.softmax(self.decoder_classifier(dec), -1)
        if c["model_mode"] == "video":
            return F.pad(vocab, (0, n_oov))
        ingr = state.pointer_vectors
        logits = torch.einsum("bseh,bsth->bste", self.Wing(ingr), dec)
        em = batch["entity_mask"][:, None, None, :]
        logits = torch.where(em > 0, logits, torch.full_like(logits, NEG_INF))
        attn = torch.softmax(logits, -1) * em
        attended = torch.einsum("bste,bseh->bsth", attn, ingr)
        p_gen = torch.sigmoid(self.pgen_linear(torch.cat([dec, attended], -1)))
        C = V + n_oov
        copy = torch.einsum("bekc,bek->bec",
                            F.one_hot(batch["copy_ids"].long(), C).float(),
                            batch["copy_weights"])
        probs = F.pad(vocab * p_gen, (0, n_oov)) + torch.einsum(
            "bste,bec->bstc", attn * (1.0 - p_gen), copy)
        cols = torch.arange(C, device=probs.device)
        ok = (cols[None] < (V + batch["oov_count"])[:, None]).float()
        return probs * ok[:, None, None, :]

    def score_text(self, batch, state, text_ids, text_mask, train=False,
                   g=None):
        """Teacher-forced decoder + head: text_ids (B, S, T) -> (B, S, T, C)."""
        B, S, T = text_ids.shape
        M = state.ga_inputs.shape[2]
        emb = self.text_embeddings(text_ids.reshape(B * S, T), train, g)
        dec = self.decoder(emb, text_mask.reshape(B * S, T),
                           state.ga_inputs.reshape(B * S, M, -1),
                           emb.new_ones(B * S, M), train, g)
        return self.head_probs(batch, state, dec.reshape(B, S, T, -1))

    # -- the textual re-simulator -------------------------------------- #

    def reconstruct(self, batch, probs, text_mask, ingr, oov_count, train, g):
        c = self.c
        C = probs.shape[-1]
        V = c["vocab_size"]
        logits = torch.log(probs + 1e-12)
        cols = torch.arange(C, device=logits.device)
        logits = torch.where(cols < (V + oov_count)[:, None, None, None],
                             logits, logits.new_tensor(NEG_INF))
        u = torch.rand(logits.shape, generator=g, device=logits.device)
        noise = -torch.log(-torch.log(u.clamp(
            min=torch.finfo(torch.float32).tiny)))
        soft = torch.softmax((logits + noise) / c["temperature"], -1)
        hard = torch.zeros_like(soft).scatter_(
            -1, soft.argmax(-1, keepdim=True), 1.0)
        onehot = hard + soft - soft.detach()
        bow = onehot[..., :V] @ self.text_embeddings.word_embeddings.weight
        tm = text_mask[..., None]
        step_bow = (bow * tm).sum(2) / tm.sum(2).clamp(min=1.0)
        if "clip_video" in batch:
            step_bow = scatter_clips(batch, step_bow[:, 0],
                                     tuple(batch["step_mask"].shape))
        hs = self.recipe_encoder(step_bow, batch["step_mask"])
        H = c["hidden_size"]
        return self.recipe_reasoner(hs[..., :H] + hs[..., H:], ingr,
                                    batch["entity_mask"], train, g)

    # -- the training forward ------------------------------------------ #

    def _action_loss(self, probs, targets, row_mask):
        if self.c.get("use_asl", True):
            return asymmetric_loss_sum(probs, targets, row_mask)
        return bce_sum(probs, targets, row_mask[..., None])

    def losses(self, batch, train=True, g=None):
        """The summed training loss: caption + entity + action +
        lambda * (re-simulated entity + action)."""
        c = self.c
        T, V = c["max_t_len"], c["vocab_size"]
        state = self.encode(batch, train, g)
        N, L = batch["clip_input_ids"].shape
        Lv = L - T
        text_ids = batch["clip_input_ids"][:, None, Lv:]
        text_mask = batch["clip_input_mask"][:, None, Lv:]
        labels = batch["clip_input_labels"][:, None, Lv:]
        head = clip_view(batch)
        if c["model_mode"] == "video":
            labels = torch.where(labels >= V, torch.full_like(labels, UNK),
                                 labels)
            ext = torch.full((N,), V, dtype=torch.long, device=labels.device)
        else:
            ext = V + head["oov_count"]
        probs = self.score_text(head, state, text_ids, text_mask, train, g)
        total = label_smoothing_kl(probs.reshape(-1, probs.shape[-1]),
                                   labels.reshape(-1),
                                   ext.repeat_interleave(T),
                                   c["label_smoothing"])
        sup = batch["step_mask"][..., None] * batch["entity_mask"][:, None]
        if c["model_mode"] in ("full", "reason_copy"):
            r = state.reasoner
            total = total + bce_sum(r.ent_probs, batch["alignment"], sup) \
                + self._action_loss(r.ac_probs, batch["action"],
                                    batch["action_row_mask"])
        if c["model_mode"] == "full":
            re = self.reconstruct(batch, probs, text_mask, state.ingr_vectors,
                                  head["oov_count"], train, g)
            total = total + c["lambda_"] * (
                bce_sum(re.ent_probs, batch["alignment"], sup)
                + self._action_loss(re.ac_probs, batch["action"],
                                    batch["action_row_mask"]))
        return total
