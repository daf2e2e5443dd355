"""svpc_torch's train step and trainer: a 3-step trajectory against
svpc_tpu's ``make_train_step`` (carried weights, the same packed batches,
dropout 0, the same Gumbel noise), the nonfinite-update guard, gradient
accumulation, and ``python -m svpc_torch.cli.train --device cpu`` on a
tiny fixture, killed mid-epoch and resumed exactly.  f32 on the CPU."""

import copy
import json
import os

import numpy as np
import pytest
import torch

from tests.torch_parity import (dropout_free, gumbel_noise, jax_compile,
                                shared_gumbel, to_port)

torch.set_num_threads(1)

N_CLIPS = 8   # one packed shape for every batch: one JAX compile


def _packed_batches(cfg, seeds):
    from svpc_tpu.data.packing import pack_batch
    from svpc_tpu.data.synthetic import synthetic_batch

    return [pack_batch(synthetic_batch(cfg, 2, seed=s), cfg.model.max_t_len,
                       n_clips=N_CLIPS, v_len=cfg.model.max_v_len)
            for s in seeds]


def _port_state(model, cfg, steps_per_epoch):
    from svpc_torch.train.optim import make_optimizer
    from svpc_torch.train.state import TrainState

    model = copy.deepcopy(model)
    opt = make_optimizer(cfg.train, steps_per_epoch,
                         dict(model.named_parameters()))
    return TrainState.create(model, opt, use_ema=cfg.train.ema_decay > 0,
                             ema_dtype=cfg.train.optimizer_dtype)


def test_three_step_trajectory_matches_make_train_step():
    """vivt, packed, the default optimizer (global clip, BertAdam with
    warmup_linear over 3 steps, EMA): every step's loss within 1e-5
    relative and token counts exact; after 3 steps every parameter and
    the EMA shadow within 2e-6 (abs) of svpc_tpu's.  The parameters are
    O(0.1); Adam's steps are at most ~3.2 lr = 3.2e-4 and its normalised
    update is insensitive to the gradients' f32 rounding (1e-6 relative),
    so the two runs differ by the parameters' own rounding, about 1e-8,
    and 2e-6 is two orders of magnitude above that yet far below one
    step."""
    import jax
    from svpc_tpu.train.optim import make_optimizer as jax_optimizer
    from svpc_tpu.train.state import TrainState as JaxState
    from svpc_tpu.train.step import make_train_step
    from svpc_torch.model.from_jax import _flatten, build_mapping
    from svpc_torch.train.step import train_step

    jcfg, jmodel, params, cfg, model = dropout_free("full")
    batches = _packed_batches(jcfg, (1, 2, 3))
    noise = gumbel_noise((N_CLIPS, 1, jcfg.model.max_t_len,
                          jcfg.model.extended_vocab_size))
    tx = jax_optimizer(jcfg.train, 3, model_mode="full", n_layers=1)
    # the initial state from its abstract shapes (zero moments, a copy of
    # the parameters as shadow): no compile
    jstate = jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda p: JaxState.create(p, tx, use_ema=True),
                       params))
    jstate = jstate.replace(params=params, ema_shadow=params["params"])
    rng = jax.random.PRNGKey(0)
    state = _port_state(model, cfg, 3)
    with shared_gumbel(noise):
        jstep = jax_compile(make_train_step(jmodel, tx, jcfg), jstate,
                            batches[0], rng)
        for i, b in enumerate(batches):
            jstate, jm = jstep(jstate, b, rng)
            m = train_step(state, to_port(b), cfg)
            for key in ("loss", "caption_loss", "grad_norm"):
                assert float(m[key]) == pytest.approx(float(jm[key]),
                                                      rel=1e-5), (i, key)
            for key in ("n_correct", "n_word", "ent_precision",
                        "ac_precision"):
                assert int(m[key]) == int(jm[key]), (i, key)
            assert m["nonfinite_skipped"] == int(jm["nonfinite_skipped"]) \
                == 0
    assert state.step == int(jstate.step) == 3
    mapping = build_mapping("full", 1)
    for tree, port in ((jstate.params, state.params),
                       (jstate.ema_shadow, state.ema_shadow)):
        flat = _flatten(tree["params"] if "params" in tree else tree)
        for f_key, (t_key, tr) in mapping.items():
            want = np.asarray(flat[f_key])
            want = want.T if tr == "T" else want
            np.testing.assert_allclose(port[t_key].detach().numpy(), want,
                                       rtol=0, atol=2e-6, err_msg=t_key)


def test_nonfinite_guard_and_gradient_accumulation():
    """A step whose gradient norm or loss is not finite keeps parameters,
    moments and shadow (and is counted); the summed gradients of two
    microbatches equal those of the one batch holding both."""
    from svpc_tpu.data.synthetic import synthetic_batch
    from svpc_torch.train.step import apply_step, grad_step, train_step

    jcfg, _, _, cfg, model = dropout_free("full")
    state = _port_state(model, cfg, 4)
    batch = to_port(_packed_batches(jcfg, (4,))[0])
    gen = lambda: torch.Generator().manual_seed(0)
    snapshot = lambda: [t.clone() for t in (
        list(state.params.values()) + list(state.optimizer.m.values())
        + list(state.optimizer.v.values())
        + list(state.ema_shadow.values()))]
    with shared_gumbel(None):
        for loss in (None, torch.tensor(float("nan"))):
            before = snapshot()
            grad_step(state, batch, cfg, gen())
            if loss is None:
                next(iter(state.params.values())).grad[0] = float("inf")
            m = apply_step(state, cfg, loss=loss)
            assert m["nonfinite_skipped"] == 1
            assert all(torch.equal(a, b) for a, b in zip(before, snapshot()))
            assert all(p.grad is None for p in state.params.values())
        assert state.step == 2 and state.optimizer.step == 0
        m = train_step(state, batch, cfg)
        assert m["nonfinite_skipped"] == 0 and state.optimizer.step == 1
        assert not all(torch.equal(a, b)
                       for a, b in zip(before, snapshot()))

        big = synthetic_batch(jcfg, 4, seed=9)
        halves = [{k: v[sl] for k, v in big.items()}
                  for sl in (slice(0, 2), slice(2, 4))]
        grads = []
        for parts in ([big], halves):
            st = _port_state(model, cfg, 4)
            for part in parts:
                grad_step(st, to_port(part), cfg, gen())
            grads.append({n: p.grad.clone() for n, p in st.params.items()
                          if p.grad is not None})
    # sums in another order: 1e-5 of each tensor's scale, and of the
    # largest gradient where a tensor's is zero up to rounding (key biases)
    assert set(grads[0]) == set(grads[1])
    top = max(float(g.abs().max()) for g in grads[0].values())
    for name, g in grads[0].items():
        scale = float(g.abs().max())
        err = float((grads[1][name] - g).abs().max())
        assert err <= 1e-5 * max(scale, 1e-3 * top), (name, err, scale)


def _cli_argv(fx, workdir):
    return ["--data_dir", fx["data_dir"],
            "--video_feature_dir", fx["video_feature_dir"],
            "--duration_file", fx["duration_file"],
            "--word2idx_path", fx["word2idx_path"],
            "--verb2idx_path", fx["verb2idx_path"],
            "--hidden_size", "32", "--intermediate_size", "32",
            "--lstm_hidden_size", "32", "--num_attention_heads", "4",
            "--num_hidden_layers", "1", "--word_vec_size", "16",
            "--video_feature_size", "24", "--max_v_len", "10",
            "--max_t_len", "8", "--max_n_sen", "4", "--max_i_len", "20",
            "--batch_size", "2", "--val_batch_size", "2", "--n_epoch", "2",
            "--checkpoint_every_steps", "1", "--device", "cpu",
            "--workdir", workdir]


def test_cli_trains_and_resumes_mid_epoch_exactly(tmp_path):
    """cli.train --device cpu on a tiny fixture, with GloVe tables of its
    own (.npy, frozen), writes the logs, the greedy validation decodes,
    checkpoint_last (+ progress sidecar), checkpoint_best and
    history.json, and keeps the frozen tables at their GloVe values; a run
    killed after the first step of epoch 1 and resumed from its mid-epoch
    checkpoint_last ends with the uninterrupted run's history.json, logs,
    decodes and weights; resuming the finished run at its epoch boundary
    with a third epoch appends one epoch to its logs and history."""
    import svpc_torch.train.loop as loop
    from svpc_torch.cli.train import main
    from svpc_torch.config import tiny_test_config
    from svpc_torch.data.synthetic import write_training_fixture

    m = tiny_test_config("full").model
    fx = write_training_fixture(str(tmp_path / "data"),
                                tiny_test_config("full"), n_train=6,
                                n_val=3, seed=0, max_clips=4)
    rng = np.random.RandomState(1)
    glove = {"glove": rng.randn(m.vocab_size, m.word_vec_size),
             "verb_glove": rng.randn(m.action_vocab_size, m.word_vec_size)}
    for name, table in glove.items():
        np.save(str(tmp_path / f"{name}.npy"), table.astype(np.float32))
    argv = lambda workdir: _cli_argv(fx, workdir) + [
        "--glove_path", str(tmp_path / "glove.npy"),
        "--verb_glove_path", str(tmp_path / "verb_glove.npy"),
        "--freeze_glove"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    res_a = main(argv(a))
    params = res_a["state"].params
    for name, key in (("text_embeddings.word_embeddings.weight", "glove"),
                      ("ingredient_embeddings.word_embeddings.weight",
                       "glove"),
                      ("reasoner.action_embeddings", "verb_glove"),
                      ("recipe_reasoner.action_embeddings", "verb_glove")):
        np.testing.assert_array_equal(params[name].detach().numpy(),
                                      glove[key].astype(np.float32), name)
    names = set(os.listdir(a))
    for f in ("train.log.csv", "valid.log.csv", "history.json",
              "checkpoint_last", "checkpoint_last.cfg.json",
              "checkpoint_last.progress.json", "checkpoint_best",
              "greedy_pred_val_epoch0.json", "greedy_pred_val_epoch1.json"):
        assert f in names, f
    assert [s["step"] for s in res_a["steps"]] == list(range(6))
    assert all(np.isfinite(s["loss"]) for s in res_a["steps"])

    class Boom(Exception):
        pass

    real_step, calls = loop.train_step, []

    def bomb(*args, **kwargs):
        if len(calls) == 4:   # 3 steps of epoch 0, 1 step of epoch 1
            raise Boom()
        calls.append(1)
        return real_step(*args, **kwargs)

    loop.train_step = bomb
    try:
        with pytest.raises(Boom):
            main(argv(b))
    finally:
        loop.train_step = real_step
    with open(os.path.join(b, "checkpoint_last.progress.json")) as f:
        prog = json.load(f)
    assert (prog["epoch"], prog["batches_done"], prog["step"]) == (1, 1, 4)

    res_b = main(argv(b) + ["--resume_from",
                            os.path.join(b, "checkpoint_last")])
    assert [s["step"] for s in res_b["steps"]] == [4, 5]
    assert [s["loss"] for s in res_b["steps"]] == \
        [s["loss"] for s in res_a["steps"][4:]]
    for f in ("history.json", "train.log.csv", "valid.log.csv",
              "greedy_pred_val_epoch1.json"):
        with open(os.path.join(a, f)) as fa, open(os.path.join(b, f)) as fb:
            assert fa.read() == fb.read(), f
    for name, p in res_a["state"].params.items():
        assert torch.equal(p, res_b["state"].params[name]), name

    res_c = main(argv(a) + ["--n_epoch", "3", "--resume_from",
                            os.path.join(a, "checkpoint_last")])
    assert [s["step"] for s in res_c["steps"]] == [6, 7, 8]
    assert [h["epoch"] for h in res_c["history"]] == [0, 1, 2]
    with open(os.path.join(a, "valid.log.csv")) as f:
        assert [ln.split(",")[0] for ln in f.read().split()[1:]] == \
            ["0", "1", "2"]
