"""svpc_torch's model at compute_dtype="bfloat16" against svpc_tpu's, on
carried weights and the same seeded numpy batches, on the CPU (one
encoder/decoder layer, ``torch_parity.dropout_free``, so that the JAX
programs compile quickly): the
deterministic forward (every loss and probability) in ``full`` and
``video`` x packed and dense, the encoded state, and greedy and beam (K=2)
tokens.  Float outputs are held to the band of tests/torch_parity.py; a
loss, a sum of row terms, to twice the sum of svpc_tpu's own bfloat16
error over its rows.  Greedy tokens must equal svpc_tpu's up to the first
position where svpc_tpu's top-1 / top-2 probability margin is inside that
position's band (the excluded positions are counted,
``excluded_positions`` in the junit record, and at least 60% of the real
positions must be compared); fed svpc_tpu's tokens, the port's
probabilities are in the band and its argmax is svpc_tpu's token at every
position whose margin is outside its band (``undecided_positions`` counts
the others).  Beam (K=2, n_best=2): svpc_tpu's two hypotheses, scored
teacher-forced by the port, within the band of svpc_tpu's scores and
ranked as svpc_tpu ranks them; the port's own search returns them on most
rows (``_beam_checks``).

tests/test_torch_bf16_card.py holds the bfloat16 model on the card against
the CPU."""

import copy
import functools

import numpy as np
import pytest
import torch

from tests.torch_parity import (assert_in_band, bf16_pair,
                                dropout_free, f32, jax_compile,
                                row_terms, shared_gumbel, to_port)

torch.set_num_threads(1)

CASES = [(m, p) for m in ("full", "video") for p in (False, True)]
STATE = ("step_vectors", "ingr_vectors", "ga_inputs", "pointer_vectors")
# the decoding test's LM head, sharpened: the random tiny model's word
# distributions are nearly flat (max probability 0.39 in full, 0.035 in
# video), so that most top-1 / top-2 margins fall inside the band and the
# margin rule would compare few tokens
HEAD_SCALE = 8.0
PROBS = ("prediction_scores", "ent_probs", "ac_probs", "re_ent_probs",
         "re_ac_probs")


@functools.lru_cache(maxsize=None)
def _models(mode: str, head_scale: float = 1.0):
    """(JAX params, {dtype name: JAX model}, {dtype name: (port config,
    port model)}), the same weights in float32 and bfloat16; the LM head's
    projection and bias multiplied by ``head_scale`` (the logits too)."""
    from svpc_tpu.model import SVPCModel as JaxModel

    jcfg, jmodel, params, cfg, model = dropout_free(mode)
    if head_scale != 1.0:
        params = copy.deepcopy(params)
        head = params["params"]["decoder_classifier"]
        head["bias"] = head["bias"] * head_scale
        head["decoder"]["kernel"] = head["decoder"]["kernel"] * head_scale
        model = copy.deepcopy(model)
        with torch.no_grad():
            model.decoder_classifier.bias.mul_(head_scale)
            model.decoder_classifier.decoder.weight.mul_(head_scale)
    jcfg16, cfg16, model16 = bf16_pair(jcfg, cfg, model.eval())
    return (params, {"float32": jmodel, "bfloat16": JaxModel(jcfg16.model)},
            {"float32": (cfg, model), "bfloat16": (cfg16, model16)})


def _port(mode, dtype="bfloat16", head_scale=1.0):
    return _models(mode, head_scale)[2][dtype]


@functools.lru_cache(maxsize=None)
def _batch(mode: str, packed: bool):
    from svpc_tpu.data.packing import pack_batch
    from svpc_tpu.data.synthetic import synthetic_batch

    cfg = dropout_free(mode)[0]
    b = synthetic_batch(cfg, 3, seed=5)
    return pack_batch(b, cfg.model.max_t_len) if packed else b


@functools.lru_cache(maxsize=None)
def _jax_forward():
    """{(mode, packed, dtype): ModelOutputs} of svpc_tpu, one compiled
    program."""
    import jax
    import jax.numpy as jnp

    params = {m: _models(m)[0] for m in ("full", "video")}

    def run(ps):
        out = {}
        for mode, packed in CASES:
            b = {k: jnp.asarray(v) for k, v in _batch(mode, packed).items()}
            for name, model in _models(mode)[1].items():
                with shared_gumbel(None):
                    out[f"{mode}/{packed}/{name}"] = model.apply(
                        ps[mode], b, deterministic=True,
                        rngs={"gumbel": jax.random.PRNGKey(0)})
        return out

    res = jax.tree.map(np.asarray, jax_compile(run, params)(params))
    return {tuple(k.split("/")): v for k, v in res.items()}


def _jax(mode, packed, dtype):
    return _jax_forward()[(mode, str(packed), dtype)]


def _loss_bands(mode, packed, cfg):
    """Each loss's band: twice the sum over its rows of |row(jax bf16) -
    row(jax f32)|, plus 1e-5 (the total's is its parts', weighted)."""
    t16, t32 = (row_terms(_jax(mode, packed, d), _batch(mode, packed),
                           cfg) for d in ("bfloat16", "float32"))
    bands = {k: 2.0 * float(np.abs(t16[k] - t32[k]).sum()) + 1e-5
             for k in t16}
    bands["total_loss"] = sum(
        bands.get(k, 0.0) * (cfg.lambda_ if k.startswith("re_") else 1.0)
        for k in list(bands))
    return bands


def test_forward_in_band():
    """Every probability of the deterministic forward (the teacher-forced
    scorer, the reasoners' entity and action probabilities) within the
    band, with svpc_tpu's dtypes; every loss within its band."""
    for mode, packed in CASES:
        cfg, model = _port(mode)
        o16, o32 = (_jax(mode, packed, d) for d in ("bfloat16", "float32"))
        with torch.no_grad(), shared_gumbel(None):
            got = model(to_port(_batch(mode, packed)), deterministic=True)
        what = f"{mode} packed={packed}"
        for name in PROBS:
            if getattr(o16, name) is not None:
                assert_in_band(getattr(got, name), getattr(o16, name),
                               getattr(o32, name), f"{what} {name}")
        for name, tol in _loss_bands(mode, packed, cfg.model).items():
            err = abs(float(getattr(got, name))
                      - float(getattr(o16, name)))
            assert err <= tol, f"{what} {name}: {err:.3e} > {tol:.3e}"


@functools.lru_cache(maxsize=None)
def _jax_decodes():
    """svpc_tpu at bfloat16 on the dense batches: greedy tokens (full,
    video), their teacher-forced probabilities and the encoded state at
    bfloat16 and float32 (the margins and their band), and beam K=2 ranked
    tokens and scores (full) at bfloat16 and the scores at float32; one
    program."""
    import jax
    import jax.numpy as jnp
    from svpc_tpu import tokenization as tok
    from svpc_tpu.decode.beam import beam_decode
    from svpc_tpu.decode.greedy import greedy_decode

    params = {m: _models(m, HEAD_SCALE)[0] for m in ("full", "video")}

    def run(ps):
        out = {}
        for mode in ("full", "video"):
            cfg = dropout_free(mode)[0].model
            b = {k: jnp.asarray(v) for k, v in _batch(mode, False).items()}
            models = _models(mode, HEAD_SCALE)[1]
            ids = greedy_decode(models["bfloat16"], ps[mode], b)
            fed = jnp.where(ids >= cfg.vocab_size, tok.UNK, ids)
            probs, states = {}, {}
            for name, model in models.items():
                states[name] = model.apply(ps[mode], b,
                                           method=type(model).encode)
                probs[name] = model.apply(
                    ps[mode], b, states[name], fed,
                    jnp.ones(fed.shape, jnp.float32),
                    method=type(model).score_text)
            out[mode] = (ids, probs, states)
            if mode == "full":
                out["beam"] = {name: beam_decode(model, ps[mode], b,
                                                 beam_size=2, n_best=2)
                               for name, model in models.items()}
                # the bfloat16 search's two hypotheses scored
                # teacher-forced at both dtypes, stacked along the batch
                hyp = out["beam"]["bfloat16"][0]           # (B, 2, S, T)
                h2 = jnp.concatenate([hyp[:, 0], hyp[:, 1]])
                h2 = jnp.where(h2 >= cfg.vocab_size, tok.UNK, h2)
                b2 = {k: jnp.concatenate([v, v]) for k, v in b.items()}
                out["beam_tf"] = {name: model.apply(
                    ps[mode], b2, model.apply(ps[mode], b2,
                                              method=type(model).encode),
                    h2, jnp.ones(h2.shape, jnp.float32),
                    method=type(model).score_text)
                    for name, model in models.items()}
        return out

    return jax.tree.map(np.asarray, jax_compile(run, params)(params))


def _selectable(probs, cfg, batch):
    """probs (B, S, T, C) with the columns greedy decoding never selects
    (UNK, beyond each example's extended vocabulary) at -1."""
    from svpc_tpu import tokenization as tok

    p = f32(probs)
    C, V = p.shape[-1], cfg.vocab_size
    ext = (np.full(batch["oov_count"].shape, V) if cfg.model_mode == "video"
           else V + batch["oov_count"])
    cols = np.arange(C)
    ok = (cols[None, :] < ext[:, None]) & (cols[None, :] != tok.UNK)
    return np.where(ok[:, None, None, :], p, -1.0)


def _decisive(probs16, probs32, cfg, batch):
    """(B, S, T) bool: svpc_tpu's top-1 / top-2 margin at each position is
    above that position's band (the band over its own probabilities), so
    the token after it is decided."""
    top2 = -np.sort(-_selectable(probs16, cfg, batch), axis=-1)[..., :2]
    own = 2.0 * np.abs(f32(probs16) - f32(probs32)).max(-1) + 1e-5
    return (top2[..., 0] - top2[..., 1]) > own


def test_greedy_and_beam_tokens(record_property):
    """The encoded state (dense) within the band.  Greedy (cached, dense
    and packed) in full and video: tokens equal svpc_tpu's at every
    decisive position.  Beam K=2, n_best=2 (cached, dense and packed) in
    full: ``_beam_checks``."""
    from svpc_torch import tokenization as tok
    from svpc_torch.decode.beam import beam_decode
    from svpc_torch.decode.greedy import greedy_decode

    res = _jax_decodes()
    for mode in ("full", "video"):
        cfg, model = _port(mode, head_scale=HEAD_SCALE)
        ids, probs, states = res[mode]
        dense = _batch(mode, False)
        with torch.no_grad():
            state = model.encode(to_port(dense))
        for name in STATE:
            if getattr(states["bfloat16"], name) is not None:
                assert_in_band(getattr(state, name),
                               getattr(states["bfloat16"], name),
                               getattr(states["float32"], name),
                               f"{mode} {name}")
        decisive = _decisive(probs["bfloat16"], probs["float32"], cfg.model,
                             dense)
        # free running: a token after the first undecided one is excluded
        keep = np.ones(ids.shape, bool)
        keep[..., 1:] = np.cumprod(decisive[..., :-1], -1).astype(bool)
        step = dense["step_mask"][..., None] > 0
        record_property(f"excluded_positions_{mode}",
                        int((~keep & step).sum()))
        assert (keep & step).sum() >= 0.6 * np.broadcast_to(
            step, keep.shape).sum(), f"{mode}: too few positions compared"
        # teacher forced: svpc_tpu's tokens in, every decided position
        fed = to_port(dense)
        text = torch.from_numpy(ids.copy()).long()
        text = torch.where(text >= cfg.model.vocab_size,
                           torch.full_like(text, tok.UNK), text)
        with torch.no_grad():
            tf = model.score_text(fed, model.encode(fed), text,
                                  torch.ones(text.shape))
        assert_in_band(tf, probs["bfloat16"], probs["float32"],
                       f"{mode} teacher-forced probabilities")
        pred = _selectable(tf, cfg.model, dense).argmax(-1)[..., :-1]
        real = np.broadcast_to(step, decisive.shape)[..., :-1]
        assert ((pred == ids[..., 1:]) | ~decisive[..., :-1])[real].all(), \
            mode
        record_property(f"undecided_positions_{mode}",
                        int((~decisive[..., :-1] & real).sum()))
        for packed in (False, True):
            got = greedy_decode(model, to_port(_batch(mode, packed))).numpy()
            want = ids * step if packed else ids
            rows = step if packed else np.ones_like(step)
            assert np.array_equal((got == want) | ~keep | ~rows,
                                  np.ones_like(keep)), (mode, packed)
        if mode == "full":
            _beam_checks(model, cfg.model, dense, res, record_property)


def _hypothesis_terms(probs, hyps):
    """(B, K, S, T-1): log p of each next token of ``hyps`` (B, K, S, T
    extended ids, BOS first) under ``probs`` (B, K, S, T, C), 0 after the
    first EOS; beam_decode's score is their sum."""
    from svpc_torch import tokenization as tok

    nxt = hyps[..., 1:]
    p = np.take_along_axis(f32(probs)[..., :-1, :], nxt[..., None], -1)
    eos = nxt == tok.EOS
    done = (np.cumsum(eos, -1) - eos) > 0
    return np.where(done, 0.0, np.log(p[..., 0] + np.float32(1e-12)))


def _port_hypothesis_probs(model, batch, hyps, V):
    """The port's teacher-forced probabilities (B, K, S, T, C) of each
    hypothesis of ``hyps`` (B, K, S, T)."""
    from svpc_torch import tokenization as tok

    fed = to_port(batch)
    with torch.no_grad():
        state = model.encode(fed)
        out = []
        for k in range(hyps.shape[1]):
            h = torch.from_numpy(hyps[:, k].copy()).long()
            text = torch.where(h >= V, torch.full_like(h, tok.UNK), h)
            out.append(model.score_text(fed, state, text,
                                        torch.ones(text.shape)))
    return torch.stack(out, 1)


def _beam_checks(model, cfg, dense, res, record_property):
    """Beam K=2, n_best=2 in full mode, on svpc_tpu's bfloat16 search's
    two hypotheses of each row.  Each score's band is twice the sum of
    svpc_tpu's own |bfloat16 - float32| over its terms (teacher-forced log
    probabilities), plus 1e-5, as for a loss.  Scored teacher-forced by
    the port, every hypothesis lies within its band of svpc_tpu's score,
    and the two rank as svpc_tpu ranks them wherever svpc_tpu's gap
    exceeds both bands.  The port's own search (dense and packed) returns
    the same two hypotheses, scores in band, on at least 70% of the rows
    (the others, a near-tie pruned otherwise during the search, are
    counted as ``differing_beam_rows``)."""
    from svpc_torch.decode.beam import beam_decode

    tok16 = res["beam"]["bfloat16"][0]                      # (B, 2, S, T)
    B = tok16.shape[0]
    j16, j32 = (_hypothesis_terms(np.swapaxes(f32(res["beam_tf"][d])
                                              .reshape((2, B) + res[
                                                  "beam_tf"][d].shape[1:]),
                                              0, 1), tok16)
                for d in ("bfloat16", "float32"))
    tol = 2.0 * np.abs(j16 - j32).sum(-1) + 1e-5            # (B, 2, S)
    want = j16.sum(-1)
    rows = np.broadcast_to((dense["step_mask"] > 0)[:, None], want.shape)
    got = _hypothesis_terms(_port_hypothesis_probs(
        model, dense, tok16, cfg.vocab_size), tok16).sum(-1)
    assert (np.abs(got - want) <= tol)[rows].all(), \
        ("teacher-forced", got, want, tol)
    decisive = (want[:, 0] - want[:, 1]) > tol.max(1)       # (B, S)
    real = dense["step_mask"] > 0
    record_property("undecided_beam_rows", int((real & ~decisive).sum()))
    assert (decisive & real).sum() >= 0.5 * real.sum(), "few beam rows"
    assert ((got[:, 0] > got[:, 1]) | ~decisive)[real].all(), "ranking"
    for packed in (False, True):
        ids, scores = beam_decode(model, to_port(_batch("full", packed)),
                                  beam_size=2, n_best=2)
        same = (ids.numpy() == tok16).all((1, 3)) & real    # (B, S)
        err = np.abs(f32(scores) - want)
        assert (err <= tol)[np.broadcast_to(same[:, None], err.shape)] \
            .all(), (packed, err, tol)
        assert same.sum() >= 0.7 * real.sum(), (packed, "few equal rows")
        record_property(f"differing_beam_rows_packed_{packed}",
                        int((real & ~same).sum()))
