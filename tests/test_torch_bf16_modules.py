"""svpc_torch's modules at compute_dtype="bfloat16" against svpc_tpu's, on
carried weights and the same seeded inputs, on the CPU.

Every float output is held to the band of tests/torch_parity.py (twice
svpc_tpu's own bfloat16 error on the same inputs, plus 1e-5) and must have
svpc_tpu's dtype.  A census of the matrix products of ``encode`` and of one
cached decode step, by operand and result dtype, must equal the jaxpr's
``dot_general`` census."""

import collections
import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tests.torch_parity import (assert_in_band, bf16_models, jax_model,
                                jax_params, rand, to_port)

torch.set_num_threads(1)

MODE = "full"


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _key_mask(seed, n, l):
    m = (np.random.RandomState(seed).rand(n, l) > 0.3).astype(np.float32)
    m[:, 0] = 1.0
    return m


@functools.lru_cache(maxsize=None)
def _inputs():
    from svpc_tpu.data.synthetic import synthetic_batch

    m = jax_model(MODE)[0].model
    H, T, E = m.hidden_size, m.max_t_len, m.max_entities
    b = synthetic_batch(jax_model(MODE)[0], 3, seed=2)
    dmask = np.zeros((4, T), np.float32)
    dmask[:, :5] = 1.0
    kc, vc = rand(5, 4, T, H), rand(6, 4, T, H)
    kc[:, 3:] = vc[:, 3:] = 0.0                    # positions > t are empty
    emask = np.zeros((3, E), np.float32)
    emask[0, :3] = emask[1, :E] = 1.0
    logits = rand(14, 3, 2, 4, m.vocab_size)
    return dict(
        ln=rand(0, 3, 5, H) * 3.0 + 7.0, x=rand(1, 3, 7, H),
        key_mask=_key_mask(2, 3, 7), dec=rand(3, 4, T, H), dmask=dmask,
        enc=rand(4, 4, 3, H), ones=np.ones((4, 3), np.float32),
        kc=kc, vc=vc, x_t=rand(7, 4, 1, H), head=rand(8, 2, 3, 4, H),
        ids=np.random.RandomState(9).randint(0, m.vocab_size, (3, T)),
        feat=rand(10, 3, 6, m.video_feature_size),
        ingr_ids=b["ingr_ids"], ingr_sep=b["ingr_sep_mask"],
        steps=rand(11, 3, m.max_n_sen, H), emask=emask,
        ents=rand(12, 3, E, H) * emask[..., None],
        p_dec=rand(13, 3, 2, 4, H), p_ingr=rand(15, 3, 2, E, H),
        vocab_probs=np.exp(logits) / np.exp(logits).sum(-1, keepdims=True),
        copy_ids=b["copy_ids"], copy_weights=b["copy_weights"],
        entity_mask=np.where(np.arange(3)[:, None] == 2, 0.0,
                             b["entity_mask"]).astype(np.float32))


# the inputs an activation path gives in the compute dtype
ACTIVATIONS = ("ln", "x", "dec", "enc", "kc", "vc", "x_t", "head", "feat",
               "steps", "ents", "p_dec", "p_ingr")


@functools.lru_cache(maxsize=None)
def _jax_outputs():
    """{dtype: {name: output}} of svpc_tpu's modules, float32 and bfloat16,
    from one compiled program."""
    import jax
    import jax.numpy as jnp
    from svpc_tpu.model import embeddings as je
    from svpc_tpu.model import layers as jl
    from svpc_tpu.model.pointer import PointerGenerator
    from svpc_tpu.model.reasoner import EntityReasoner

    p = lambda *path: {"params": jax_params(MODE, *path)}
    params = {k: p(*k.split("/")) for k in (
        "encoder/layer_0/output/layer_norm", "encoder/layer_0", "decoder",
        "decoder/layer_1", "decoder_classifier", "text_embeddings",
        "video_embeddings", "ingredient_embeddings", "reasoner",
        "recipe_reasoner", "pointer_generator")}
    cfg32 = jax_model(MODE)[0].model
    cfgs = {"float32": cfg32, "bfloat16": bf16_models(MODE)[0].model}

    def run(ps, x):
        out = {}
        for name, c in cfgs.items():
            dt = jnp.bfloat16 if name == "bfloat16" else jnp.float32
            a = {k: (v.astype(dt) if k in ACTIVATIONS else v)
                 for k, v in x.items()}
            o = out[name] = {}
            o["layer_norm"] = jl.LayerNorm(c).apply(
                ps["encoder/layer_0/output/layer_norm"], a["ln"])
            for diag in (False, True):
                o[f"encoder_layer_{diag}"] = jl.EncoderLayer(c).apply(
                    ps["encoder/layer_0"], a["x"], a["key_mask"], diag)
            o["decoder"] = jl.Decoder(c).apply(
                ps["decoder"], a["dec"], a["dmask"], a["enc"], a["ones"])
            layer, lp = jl.DecoderLayer(c), ps["decoder/layer_1"]
            ek, ev = layer.apply(lp, a["enc"],
                                 method=jl.DecoderLayer.project_enc_kv)
            o["enc_k"] = ek
            o["step"], o["k_cache"], o["v_cache"] = layer.apply(
                lp, a["x_t"], a["kc"], a["vc"], 3, ek, ev, a["ones"],
                method=jl.DecoderLayer.step)
            o["head"] = jl.LMPredictionHead(c).apply(
                ps["decoder_classifier"], a["head"])
            text = je.TextEmbeddings(c)
            o["text"] = text.apply(ps["text_embeddings"], a["ids"])
            o["text_position"] = text.apply(
                ps["text_embeddings"], a["ids"][:, :1], 5,
                method=je.TextEmbeddings.embed_position)
            o["video"] = je.VideoEmbeddings(c).apply(
                ps["video_embeddings"], a["feat"])
            o["ingredients"] = je.IngredientEmbeddings(c).apply(
                ps["ingredient_embeddings"], a["ingr_ids"], a["ingr_sep"])
            # the visual simulator reads bfloat16 step vectors, the textual
            # re-simulator float32 ones (the BiLSTM's), both the bfloat16
            # entity vectors
            o["reasoner"] = EntityReasoner(c).apply(
                ps["reasoner"], a["steps"], a["ents"], a["emask"])
            o["recipe_reasoner"] = EntityReasoner(c).apply(
                ps["recipe_reasoner"], x["steps"], a["ents"], a["emask"])
            o["pointer"] = PointerGenerator(c).apply(
                ps["pointer_generator"], a["p_dec"], a["p_ingr"],
                a["entity_mask"], a["copy_ids"], a["copy_weights"],
                a["vocab_probs"])
        return out

    x = {k: jnp.asarray(v) for k, v in _inputs().items()}
    return jax.tree.map(np.asarray, jax.jit(run)(params, x))


def test_modules_in_band():
    """LayerNorm (float32 math, bfloat16 out), the encoder layer (key
    padding and causal), the decoder, the cached decoder step (bfloat16
    caches written in place), the LM head, the text / video / ingredient
    embeddings, both reasoners and the pointer-generator."""
    from svpc_torch.model.pointer import pointer_generator

    want = _jax_outputs()
    w16, w32 = want["bfloat16"], want["float32"]
    model = bf16_models(MODE)[4]
    a = {k: (_t(v).to(torch.bfloat16) if k in ACTIVATIONS else _t(v))
         for k, v in _inputs().items()}
    got = {}
    with torch.no_grad():
        got["layer_norm"] = model.encoder.layer[0].output.LayerNorm(a["ln"])
        for diag in (False, True):
            got[f"encoder_layer_{diag}"] = model.encoder.layer[0](
                a["x"], a["key_mask"], diag)
        got["decoder"] = model.decoder(a["dec"], a["dmask"], a["enc"],
                                       a["ones"])
        layer = model.decoder.layer[1]
        ek, ev = layer.project_enc_kv(a["enc"])
        got["enc_k"] = ek
        kc, vc = a["kc"].clone(), a["vc"].clone()
        got["step"] = layer.step(a["x_t"], kc, vc, 3, ek, ev, a["ones"])
        got["k_cache"], got["v_cache"] = kc, vc
        got["head"] = model.decoder_classifier(a["head"])
        ids = a["ids"].long()
        got["text"] = model.text_embeddings(ids)
        got["text_position"] = model.text_embeddings.embed_position(
            ids[:, :1], 5)
        got["video"] = model.video_embeddings(a["feat"])
        got["ingredients"] = model.ingredient_embeddings(
            a["ingr_ids"].long(), a["ingr_sep"])
        for which, steps in (("reasoner", a["steps"]),
                             ("recipe_reasoner", _t(_inputs()["steps"]))):
            got[which] = getattr(model, which)(steps, a["ents"], a["emask"])
        got["pointer"] = pointer_generator(
            model.Wing, model.pgen_linear[0], a["p_dec"], a["p_ingr"],
            a["entity_mask"], a["copy_ids"].long(), a["copy_weights"],
            a["vocab_probs"], model.cfg.max_oov)
    for name in w16:
        if name in ("reasoner", "recipe_reasoner"):
            for field, g, j16, j32 in zip(w16[name]._fields, got[name],
                                          w16[name], w32[name]):
                assert_in_band(g, j16, j32, f"{name}.{field}")
        else:
            assert_in_band(got[name], w16[name], w32[name], name)


def test_bilstm_takes_float32_only():
    """The re-simulator's BiLSTM reads float32 in both compute dtypes (its
    input is a product of float32 probabilities); held to 1e-5 against
    svpc_tpu's on that input.  A bfloat16 input is refused by both: the
    JAX scan's carry would change dtype, the port's product would mix
    dtypes."""
    import jax
    import jax.numpy as jnp
    from svpc_tpu.model.lstm import BiLSTM

    model = bf16_models(MODE)[4]
    m = model.cfg
    x = rand(20, 3, m.max_n_sen, m.word_vec_size)
    mask = np.ones((3, m.max_n_sen), np.float32)
    mask[1, 2:] = 0.0
    jmod = BiLSTM(m.hidden_size)
    p = {"params": jax_params(MODE, "recipe_encoder")}
    want = np.asarray(jax.jit(jmod.apply)(p, x, mask))
    with torch.no_grad():
        got = model.recipe_encoder(_t(x), _t(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError):
        jax.eval_shape(jmod.apply, p, jnp.asarray(x, jnp.bfloat16), mask)
    with pytest.raises(RuntimeError):
        model.recipe_encoder(_t(x).to(torch.bfloat16), _t(mask))


class ProductCensus(TorchDispatchMode):
    """Counts matrix products by (operand, operand, result) dtype.  A
    float32 operand that was widened from bfloat16 (attention scores, the
    pointer's logits) counts as bfloat16: the products of bfloat16 values
    are exact in float32, so this is svpc_tpu's bfloat16 product with a
    float32 result.  Products inside an embedding lookup (a one-hot
    product in the port, a gather in JAX) are counted apart."""

    PRODUCTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}
    COPIES = {torch.ops.aten.clone.default, torch.ops.aten.contiguous.default,
              torch.ops.aten._unsafe_view.default}

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()
        self.lookups = 0
        self.in_lookup = False
        # widened tensors are kept alive, so that no later tensor reuses
        # their memory (the storage address is the mark)
        self._widened, self._alive = set(), []

    @staticmethod
    def _key(t):
        return t.untyped_storage().data_ptr()

    def _mark(self, t):
        self._widened.add(self._key(t))
        self._alive.append(t)

    def _name(self, t):
        if t.dtype == torch.float32 and self._key(t) in self._widened:
            return "bfloat16"
        return str(t.dtype).split(".")[-1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if func in self.PRODUCTS:
            a, b = args[-2:] if func in (torch.ops.aten.addmm.default,
                                         torch.ops.aten.baddbmm.default) \
                else args[:2]
            if self.in_lookup:
                self.lookups += 1
            else:
                self.counts[(self._name(a), self._name(b),
                             str(out.dtype).split(".")[-1])] += 1
        elif packet is torch.ops.aten._to_copy and args[0].dtype \
                == torch.bfloat16 and out.dtype == torch.float32:
            self._mark(out)
        elif func in self.COPIES and isinstance(args[0], torch.Tensor) \
                and self._key(args[0]) in self._widened:
            self._mark(out)
        return out


def _jaxpr_census(closed) -> collections.Counter:
    """dot_general counts by (lhs, rhs, out) dtype, a scan body's counted
    once per iteration."""
    counts = collections.Counter()

    def walk(jaxpr, times):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                a, b = eqn.invars
                counts[(str(a.aval.dtype), str(b.aval.dtype),
                        str(eqn.outvars[0].aval.dtype))] += times
            inner = times * eqn.params.get("length", 1)
            for p in eqn.params.values():
                for q in (p if isinstance(p, (list, tuple)) else [p]):
                    sub = getattr(q, "jaxpr", q)
                    if hasattr(sub, "eqns"):
                        walk(sub, inner)

    walk(closed.jaxpr, 1)
    return counts


def test_product_dtype_census():
    """encode and one cached decode step (the serving path's two calls),
    packed vivt at tiny width: the port's matrix products by dtype equal
    the jaxpr's dot_generals of svpc_tpu at compute_dtype="bfloat16"; the
    port's extra products are its embedding lookups (token types and
    ingredient words in encode, the emitted word in the step)."""
    import jax
    import jax.numpy as jnp
    import svpc_torch.model.embeddings as pe
    import svpc_torch.model.svpc as psvpc
    from svpc_tpu.data.packing import pack_batch
    from svpc_tpu.data.synthetic import synthetic_batch
    from svpc_tpu.model.svpc import clip_view

    jcfg, jmodel, params, _, model = bf16_models(MODE)
    nb = pack_batch(synthetic_batch(jcfg, 2, seed=0), jcfg.model.max_t_len)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    n = nb["clip_input_ids"].shape[0]
    tok = jnp.full((n, 1), 1, jnp.int32)
    M = type(jmodel)

    def step(p):
        state = jmodel.apply(p, jb, method=M.encode)
        caches, enc_kv = jmodel.apply(p, (n, 1), state,
                                      method=M.init_decode_caches)
        return jmodel.apply(p, clip_view(jb), state, tok, 0, caches,
                            enc_kv, method=M.score_position_cached)

    want_encode = _jaxpr_census(jax.make_jaxpr(
        lambda p: jmodel.apply(p, jb, method=M.encode))(params))
    want_all = _jaxpr_census(jax.make_jaxpr(step)(params))
    want_step = want_all - want_encode
    # init_decode_caches's cross K/V projections belong to the step side
    assert sum(want_step.values()) > 0

    real_lookup = pe.lookup

    def census_lookup(mode):
        def counted(*args):
            mode.in_lookup = True
            try:
                return real_lookup(*args)
            finally:
                mode.in_lookup = False
        return counted

    b = to_port(nb)
    got = {}
    with torch.no_grad():
        for stage in ("encode", "step"):
            mode = ProductCensus()
            saved = pe.lookup, psvpc.lookup
            pe.lookup = psvpc.lookup = census_lookup(mode)
            try:
                with mode:
                    if stage == "encode":
                        state = model.encode(b)
                    else:
                        caches, enc_kv = model.init_decode_caches((n, 1),
                                                                  state)
                        model.score_position_cached(
                            psvpc.clip_view(b), state,
                            torch.ones(n, 1, dtype=torch.long), 0, caches,
                            enc_kv)
            finally:
                pe.lookup, psvpc.lookup = saved
            got[stage] = (mode.counts, mode.lookups)
    assert got["encode"] == (want_encode, 2), (got["encode"], want_encode)
    assert got["step"] == (want_step, 1), (got["step"], want_step)
    # bfloat16 products carry the model; float32 ones are the pointer's
    # copy scatter (and none in encode)
    assert want_encode[("bfloat16", "bfloat16", "bfloat16")] > 0
    assert not any(k[0] == "float32" for k in want_encode)
