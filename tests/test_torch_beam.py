"""svpc_torch beam search against svpc_tpu's, on carried weights and the
same seeded numpy batches, f32 on the CPU (one encoder/decoder layer,
``torch_parity.dropout_free``, so that the JAX programs compile quickly):
tokens equal and scores within 1e-5 for vivt packed and dense (the dense
case with the GNMT length penalty 0.6) and for ``video`` packed at K=3,
n_best=3; the port's own properties (K=1 against
greedy, cached against uncached, ties to the lower index); and
``CaptionService(beam_size=2, n_best=2)`` payloads against svpc_tpu's.
The LM head's EOS logit is raised on both sides (``EOS_BIAS``) so that
beams finish: 11 of the 30 ranked vivt hypotheses of a layout end in EOS,
every ``video`` one does."""

import copy
import functools

import numpy as np
import pytest
import torch

from tests.torch_parity import dropout_free, jax_compile, to_port

torch.set_num_threads(1)

K = 3
LENGTH_PENALTY = {False: 0.6, True: 0.0}     # by layout: dense, packed
EOS_BIAS = {"full": 2.0, "video": 0.75}


@functools.lru_cache(maxsize=None)
def _weights(mode: str):
    """(jax cfg, jax model, params, port cfg, port model) of
    ``dropout_free(mode)`` with EOS_BIAS added to the EOS logit's bias."""
    from svpc_torch import tokenization as tok

    jcfg, jmodel, params, cfg, model = dropout_free(mode)
    params = copy.deepcopy(params)
    params["params"]["decoder_classifier"]["bias"][tok.EOS] += EOS_BIAS[mode]
    model = copy.deepcopy(model).eval()
    with torch.no_grad():
        model.decoder_classifier.bias[tok.EOS] += EOS_BIAS[mode]
    return jcfg, jmodel, params, cfg, model


@functools.lru_cache(maxsize=None)
def _batches(mode: str):
    """(dense, packed) numpy batches of 3 videos at the model's geometry."""
    from svpc_tpu.data.packing import pack_batch
    from svpc_tpu.data.synthetic import synthetic_batch

    cfg = dropout_free(mode)[0]
    dense = synthetic_batch(cfg, 3, seed=5)
    return dense, pack_batch(dense, cfg.model.max_t_len)


@functools.lru_cache(maxsize=None)
def _jax_beam(mode: str):
    """svpc_tpu's ranked (tokens, scores) for each layout, one program."""
    import jax
    from svpc_tpu.decode.beam import beam_decode

    _, model, params, _, _ = _weights(mode)
    layouts = (False, True) if mode == "full" else (True,)
    batches = tuple(_batches(mode)[p] for p in layouts)

    def fn(p, bs):
        return [beam_decode(model, p, b, beam_size=K, n_best=K,
                            length_penalty=LENGTH_PENALTY[packed])
                for b, packed in zip(bs, layouts)]

    out = jax_compile(fn, params, batches)(params, batches)
    return dict(zip(layouts, jax.tree.map(np.asarray, out)))


def test_beam_matches_jax():
    from svpc_torch.decode.beam import beam_decode

    for mode, layouts in (("full", (False, True)), ("video", (True,))):
        model = _weights(mode)[4]
        for packed in layouts:
            want_tok, want_sc = _jax_beam(mode)[packed]
            tokens, scores = beam_decode(
                model, to_port(_batches(mode)[packed]), beam_size=K,
                n_best=K, length_penalty=LENGTH_PENALTY[packed])
            assert tokens.shape == want_tok.shape
            np.testing.assert_array_equal(
                tokens.numpy(), want_tok, err_msg=f"{mode} packed={packed}")
            np.testing.assert_allclose(
                scores.numpy(), want_sc, rtol=1e-5, atol=1e-5,
                err_msg=f"{mode} packed={packed}")


def test_beam_properties():
    """K=1 equals greedy up to each clip's first EOS and pads after it
    (a finished beam continues with PAD only); cached equals uncached,
    ranked lists included; n_best=1 is rank 0; and when every candidate
    ties, the beams take the lowest column indices in order, as
    ``lax.top_k`` does."""
    from svpc_torch import tokenization as tok
    from svpc_torch.decode.beam import beam_decode
    from svpc_torch.decode.greedy import greedy_decode

    model = _weights("full")[4]
    for packed in (False, True):
        batch = to_port(_batches("full")[packed])
        greedy = greedy_decode(model, batch)
        beam1 = beam_decode(model, batch, beam_size=1)
        after_eos = (greedy == tok.EOS).long().cumsum(-1) \
            - (greedy == tok.EOS).long() > 0
        assert after_eos.any(), packed
        assert torch.equal(beam1[~after_eos], greedy[~after_eos]), packed
        assert (beam1[after_eos] == tok.PAD).all(), packed

        cached = beam_decode(model, batch, beam_size=K, n_best=K)
        uncached = beam_decode(model, batch, beam_size=K, n_best=K,
                               use_cache=False)
        assert torch.equal(cached[0], uncached[0]), packed
        torch.testing.assert_close(cached[1], uncached[1], rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(beam_decode(model, batch, beam_size=K),
                           cached[0][:, 0]), packed

    batch = to_port(_batches("video")[True])
    vmodel = copy.deepcopy(dropout_free("video")[4]).eval()
    uniform = lambda b, s, tok_t, t, caches, enc_kv: (
        torch.full(tok_t.shape + (vmodel.cfg.extended_vocab_size,),
                   1.0 / vmodel.cfg.vocab_size), caches)
    vmodel.score_position_cached = uniform
    tokens, _ = beam_decode(vmodel, batch, beam_size=K, n_best=K)
    # every step ties: the K best candidates are beam 0's K lowest allowed
    # columns (PAD, CLS, SEP; UNK is never allowed), so every beam descends
    # from beam 0 (PAD at each earlier position) and rank r holds the r-th
    # of those columns in the last slot
    T = vmodel.cfg.max_t_len
    real = batch["step_mask"] > 0
    last = tokens[..., T - 1].permute(0, 2, 1)[real]          # (clips, K)
    assert (last == torch.tensor([tok.PAD, tok.CLS, tok.SEP])).all()
    assert (tokens[..., 1:T - 1].permute(0, 2, 1, 3)[real] == tok.PAD).all()


def test_caption_service_beam_payloads_match_jax(tmp_path):
    """Two ranked ``nbest`` entries per clip, sentences and scores equal to
    svpc_tpu's service on the same fixture and weights."""
    from svpc_tpu.serving import CaptionService as JaxCaptionService
    from svpc_torch.data.synthetic import write_serving_fixture
    from svpc_torch.serving import CaptionService

    jcfg, jmodel, params, cfg, model = _weights("full")
    fx = write_serving_fixture(str(tmp_path), cfg, n_videos=3, min_clips=1,
                               max_clips=cfg.model.max_n_sen, seed=3)
    data = {k: fx[k] for k in ("word2idx_path", "verb2idx_path",
                               "duration_file", "video_feature_dir")}
    want = JaxCaptionService(jcfg.replace_data(**data), jmodel, params,
                             batch_videos=2, beam_size=2, n_best=2,
                             warmup=False).caption(fx["specs"])
    got = CaptionService(cfg.replace_data(**data), model, batch_videos=2,
                         beam_size=2, n_best=2, warmup=False,
                         device="cpu").caption(fx["specs"])
    assert list(got) == list(want)
    for vid in want:
        assert len(got[vid]) == len(fx["specs"][vid]["timestamps"])
        for g, w in zip(got[vid], want[vid]):
            assert g["sentence"] == w["sentence"] == \
                g["nbest"][0]["sentence"]
            assert [n["sentence"] for n in g["nbest"]] == \
                [n["sentence"] for n in w["nbest"]]
            assert [n["score"] for n in g["nbest"]] == pytest.approx(
                [n["score"] for n in w["nbest"]], rel=1e-5, abs=1e-5)
    with pytest.raises(ValueError, match="requires beam search"):
        CaptionService(cfg.replace_data(**data), model, n_best=2,
                       warmup=False, device="cpu")
