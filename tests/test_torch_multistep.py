"""K optimizer steps per call (``--steps_per_dispatch``), composed with
gradient accumulation: svpc_torch's ``stack_batches`` / ``repad_packed`` /
``group_stack_batches`` and ``multi_train_step`` against svpc_tpu's
(``data/packing.py``, ``train/loop.py::group_stack_batches``,
``train/step.py::make_multi_train_step``) on the same numpy batches, the
port's K-step call against its own sequential steps with dropout on, and
``cli.train --steps_per_dispatch 2 --grad_accum_steps 2`` resumed mid-epoch
exactly.  f32 on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_train import N_CLIPS, _cli_argv, _packed_batches, \
    _port_state
from tests.torch_parity import (dropout_free, gumbel_noise, jax_compile,
                                shared_gumbel, to_port)

torch.set_num_threads(1)


def _mixed_buckets(dp_shards):
    """Five packed batches of three (n_clips, v_len) buckets, each with its
    own metas."""
    from svpc_tpu.config import tiny_test_config
    from svpc_tpu.data.packing import pack_batch
    from svpc_tpu.data.synthetic import synthetic_batch

    cfg = tiny_test_config("full")
    out = []
    for s in range(5):
        b = synthetic_batch(cfg, 4, seed=s)
        out.append((pack_batch(b, cfg.model.max_t_len, clip_multiple=2 + s,
                               v_multiple=2 + 3 * (s % 2),
                               dp_shards=dp_shards),
                    [{"vid": f"v{s}_{i}"} for i in range(4)]))
    return cfg.model.max_t_len, out


def test_stacking_helpers_equal_svpc_tpu():
    """Mixed packed buckets, dp_shards 1 and 2: ``repad_packed`` (and its
    no-copy fast path), ``stack_batches`` and ``group_stack_batches``
    (K=2 with accumulation 1 and 2: the (2, 2) group, then the tail's
    (1, 1) partial group; K=3 without accumulation: 3 then 2) give
    byte-equal arrays and the same metas per group as svpc_tpu's."""
    import svpc_tpu.data.packing as jp
    import svpc_tpu.train.loop as jl
    import svpc_torch.data.packing as pp
    import svpc_torch.train.loop as pl

    for dp in (1, 2):
        T, batches = _mixed_buckets(dp)
        b = batches[0][0]
        n = b["clip_mask"].shape[0] // dp
        v = b["clip_input_ids"].shape[-1] - T
        assert pp.repad_packed(b, T, n, v, dp) is b
        assert pp.is_packed(b) and not pp.is_packed({"input_ids": 0})
        got = pp.repad_packed(b, T, n + 3, v + 4, dp)
        want = jp.repad_packed(b, T, n + 3, v + 4, dp)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], key)
        with pytest.raises(ValueError):
            pp.repad_packed(b, T, n - 1, v, dp)
        only = [bt for bt, _ in batches]
        for a, w in ((pp.stack_batches(only, T, dp),
                      jp.stack_batches(only, T, dp)),
                     (pp.stack_batches(only[:1], T, dp),
                      jp.stack_batches(only[:1], T, dp))):
            assert a.keys() == w.keys()
            for key in w:
                assert a[key].dtype == w[key].dtype, key
                np.testing.assert_array_equal(a[key], w[key], key)
        for k, accum in ((2, 1), (2, 2), (3, 1)):
            got = list(pl.group_stack_batches(iter(batches), k, T, dp,
                                              accum=accum))
            want = list(jl.group_stack_batches(iter(batches), k, T, dp,
                                               accum=accum))
            assert len(got) == len(want) > 1
            for (ga, gm), (wa, wm) in zip(got, want):
                assert gm == wm
                assert ga.keys() == wa.keys()
                for key in wa:
                    assert ga[key].shape == wa[key].shape, key
                    np.testing.assert_array_equal(ga[key], wa[key], key)
            if accum == 2:
                assert [g["clip_mask"].shape[:2] for g, _ in got] == \
                    [(2, 2), (1, 1)]


def _jax_multi(jcfg, jmodel, params, tx, calls, noise):
    """svpc_tpu's state after ``make_multi_train_step`` over each stacked
    batch of ``calls`` in turn, and each call's stacked metrics."""
    import jax
    from svpc_tpu.train.state import TrainState as JaxState
    from svpc_tpu.train.step import make_multi_train_step

    jstate = jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda p: JaxState.create(p, tx, use_ema=True),
                       params))
    jstate = jstate.replace(params=params, ema_shadow=params["params"])
    rng = jax.random.PRNGKey(0)
    metrics = []
    with shared_gumbel(noise):
        for stacked in calls:
            step = jax_compile(make_multi_train_step(jmodel, tx, jcfg),
                               jstate, stacked, rng)
            jstate, m = step(jstate, stacked, rng)
            metrics.append(jax.tree.map(np.asarray, m))
    return jstate, metrics


def test_multi_train_step_matches_make_multi_train_step():
    """vivt packed, dropout 0, the same Gumbel noise: one call over 3
    stacked batches, and (grad_accum_steps 2) a (2, 2) call then the epoch
    tail's (1, 1) call; each optimizer step's loss and gradient norm
    within 1e-5 relative and token counts exact, and afterwards every
    parameter, Adam moment and EMA tensor within 2e-6 of svpc_tpu's (the
    bar of tests/test_torch_train.py)."""
    from svpc_tpu.data.packing import stack_batches
    from svpc_tpu.train.optim import make_optimizer as jax_optimizer
    from svpc_torch.model.from_jax import _flatten, build_mapping
    from svpc_torch.train.step import multi_train_step
    from tools.torch_bf16_train_settle import _bert_adam_state

    jcfg0, jmodel, params, cfg0, model = dropout_free("full")
    T = jcfg0.model.max_t_len
    noise = gumbel_noise((N_CLIPS, 1, T, jcfg0.model.extended_vocab_size))
    batches = _packed_batches(jcfg0, (1, 2, 3, 4, 5))
    for accum, calls in (
            (1, [stack_batches(batches[:3], T)]),
            (2, [{k: v.reshape((2, 2) + v.shape[1:]) for k, v in
                  stack_batches(batches[:4], T).items()},
                 {k: v[None] for k, v in
                  stack_batches(batches[4:], T).items()}])):
        jcfg = jcfg0.replace_train(grad_accum_steps=accum)
        cfg = cfg0.replace_train(grad_accum_steps=accum)
        tx = jax_optimizer(jcfg.train, 3, model_mode="full", n_layers=1)
        jstate, jms = _jax_multi(jcfg, jmodel, params, tx, calls, noise)
        state = _port_state(model, cfg, 3)
        with shared_gumbel(noise):
            ms = [multi_train_step(state, to_port(c), cfg) for c in calls]
        for m, jm in zip(ms, jms):
            assert m["loss"].shape == jm["loss"].shape
            for key in ("loss", "caption_loss", "grad_norm"):
                np.testing.assert_allclose(m[key].numpy(), jm[key],
                                           rtol=1e-5, err_msg=key)
            for key in ("n_correct", "n_word", "nonfinite_skipped"):
                np.testing.assert_array_equal(m[key].numpy(), jm[key])
        assert state.step == int(jstate.step) == 3
        adam = _bert_adam_state(jstate.opt_state)
        assert state.optimizer.step == int(adam.step)
        mapping = build_mapping("full", 1)
        for tree, port in ((jstate.params["params"], state.params),
                           (adam.m, state.optimizer.m),
                           (adam.v, state.optimizer.v),
                           (jstate.ema_shadow, state.ema_shadow)):
            flat = _flatten(tree)
            for f_key, (t_key, tr) in mapping.items():
                want = np.asarray(flat[f_key])
                want = want.T if tr == "T" else want
                np.testing.assert_allclose(port[t_key].detach().numpy(),
                                           want, rtol=0, atol=2e-6,
                                           err_msg=(accum, t_key))


def test_multi_train_step_equals_sequential_steps_with_dropout():
    """Dropout on (the config's rates) and the port's own Gumbel noise:
    ``multi_train_step`` over a (2, 2) stacked batch and the tail's (1, 1)
    equals the loop's unfused ``grad_step``s (generator of (seed, step,
    microbatch)) and ``apply_step``s over the same slices, bit for bit:
    losses, gradient norms, parameters, moments and EMA."""
    from svpc_tpu.config import tiny_test_config as jax_tiny_config
    from svpc_torch.config import tiny_test_config
    from svpc_torch.data.packing import stack_batches
    from svpc_torch.model import SVPCModel
    from svpc_torch.train.step import (apply_step, grad_step,
                                       multi_train_step, step_generator)

    cfg = tiny_test_config("full").replace_model(num_hidden_layers=1) \
        .replace_train(grad_accum_steps=2)
    assert cfg.model.hidden_dropout_prob > 0
    model = SVPCModel(cfg.model, torch.Generator().manual_seed(3))
    batches = _packed_batches(jax_tiny_config("full"), (1, 2, 3, 4, 5))
    T = cfg.model.max_t_len
    calls = [{k: v.reshape((2, 2) + v.shape[1:]) for k, v in
              stack_batches(batches[:4], T).items()},
             {k: v[None] for k, v in stack_batches(batches[4:], T).items()}]
    fused, seq = _port_state(model, cfg, 3), _port_state(model, cfg, 3)
    got = [multi_train_step(fused, to_port(c), cfg) for c in calls]
    want = []
    for c in calls:
        c = to_port(c)
        for k in range(c["clip_mask"].shape[0]):
            step, losses = seq.step, []
            for i in range(c["clip_mask"].shape[1]):
                m = grad_step(seq, {key: v[k, i] for key, v in c.items()},
                              cfg, step_generator("cpu", cfg.train.seed,
                                                  step, i))
                losses.append(m["loss"])
            want.append((torch.stack(losses).sum(),
                         apply_step(seq, cfg)["grad_norm"]))
    assert [(m["loss"][k], m["grad_norm"][k]) for m in got
            for k in range(m["loss"].shape[0])] == want
    assert fused.step == seq.step == 3
    for a, b in ((fused.params, seq.params),
                 (fused.optimizer.m, seq.optimizer.m),
                 (fused.optimizer.v, seq.optimizer.v),
                 (fused.ema_shadow, seq.ema_shadow)):
        for name, t in a.items():
            assert torch.equal(t, b[name]), name


def test_cli_groups_steps_and_resumes_mid_epoch_exactly(tmp_path):
    """``cli.train --steps_per_dispatch 2 --grad_accum_steps 2
    --checkpoint_every_steps 1 --max_steps_per_epoch 5`` on 6 host batches
    an epoch: each epoch runs a (2, 2) group and the capped tail's (1, 1)
    (5 host batches, not 6: the cap is not overshot), 3 optimizer steps;
    a run killed in the tail call of epoch 1 resumes from its mid-epoch
    checkpoint (4 host batches done) to the uninterrupted run's history,
    logs, weights and per-step losses."""
    import svpc_torch.train.loop as loop
    from svpc_torch.cli.train import main
    from svpc_torch.config import tiny_test_config
    from svpc_torch.data.synthetic import write_training_fixture

    fx = write_training_fixture(str(tmp_path / "data"),
                                tiny_test_config("full"), n_train=12,
                                n_val=2, seed=0, max_clips=4)
    argv = lambda w: _cli_argv(fx, w) + [
        "--steps_per_dispatch", "2", "--grad_accum_steps", "2",
        "--max_steps_per_epoch", "5", "--no_tensorboard"]
    real, shapes = loop.multi_train_step, []

    class Boom(Exception):
        pass

    def spy(state, batch, cfg):
        shapes.append(tuple(batch["clip_mask"].shape[:2]))
        if len(shapes) == 4 and kill:
            raise Boom()
        return real(state, batch, cfg)

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    loop.multi_train_step = spy
    try:
        kill = False
        res_a = main(argv(a))
        assert shapes == [(2, 2), (1, 1)] * 2
        assert [s["step"] for s in res_a["steps"]] == list(range(6))
        kill, shapes[:] = True, []
        with pytest.raises(Boom):
            main(argv(b))
    finally:
        loop.multi_train_step = real
    with open(os.path.join(b, "checkpoint_last.progress.json")) as f:
        prog = json.load(f)
    assert (prog["epoch"], prog["batches_done"], prog["step"]) == (1, 4, 5)
    res_b = main(argv(b) + ["--resume_from",
                            os.path.join(b, "checkpoint_last")])
    assert [s["step"] for s in res_b["steps"]] == [5]
    assert res_b["steps"][0]["loss"] == res_a["steps"][5]["loss"]
    for f in ("history.json", "train.log.csv", "valid.log.csv"):
        with open(os.path.join(a, f)) as fa, open(os.path.join(b, f)) as fb:
            assert fa.read() == fb.read(), f
    for name, p in res_a["state"].params.items():
        assert torch.equal(p, res_b["state"].params[name]), name
