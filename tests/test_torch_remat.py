"""Rematerialization (``--remat``), the profiler (``--profile_steps``) and
TensorBoard in svpc_torch's trainer, on the CPU: remat changes no value
(with dropout on, the masks drawn from the step's generator), it matches
svpc_tpu's ``remat=True`` gradients, ``cli.train --remat
--steps_per_dispatch 2 --profile_steps 1`` writes a trace and svpc_tpu's
TensorBoard tags, and the inference CLIs read a checkpoint whose sidecar
carries those training knobs."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_eval_cli import GEOMETRY, _data_argv
from tests.test_torch_train import N_CLIPS, _packed_batches
from tests.torch_parity import (dropout_free, gumbel_noise, jax_compile,
                                shared_gumbel, to_port)

torch.set_num_threads(1)

TB_TAGS = {"Train/Loss", "Train/Acc", "Val/METEOR", "Val/Bleu_4",
           "Val/CIDEr", "Val/Re4", "Val/Loss", "Val/Acc"}


def test_remat_changes_no_value_with_dropout():
    """Two layers, the config's dropout rates, one generator seed: the
    remat model's loss and every gradient equal the plain model's exactly
    (the same operations on the same masks), the generator ends where the
    plain forward leaves it, each wrapped layer runs twice (forward and
    recomputation) where the plain one runs once, and the greedy decode
    (remat off outside autograd) is token-equal."""
    from svpc_torch.config import tiny_test_config
    from svpc_torch.decode.greedy import greedy_decode
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.layers import DecoderLayer, EncoderLayer
    from svpc_tpu.config import tiny_test_config as jax_tiny_config

    cfg = tiny_test_config("full")
    assert cfg.model.hidden_dropout_prob > 0 and \
        cfg.model.attention_probs_dropout_prob > 0
    batch = to_port(_packed_batches(jax_tiny_config("full"), (1,))[0])
    calls = {"layers": 0}
    real = EncoderLayer.forward, DecoderLayer.forward

    def counted(fn):
        def run(*args, **kwargs):
            calls["layers"] += 1
            return fn(*args, **kwargs)
        return run

    got = {}
    for remat in (False, True):
        model = SVPCModel(dataclasses.replace(cfg.model, remat=remat),
                          torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(5)
        calls["layers"] = 0
        EncoderLayer.forward, DecoderLayer.forward = map(counted, real)
        try:
            out = model(batch, deterministic=False, generator=gen)
            out.total_loss.backward()
        finally:
            EncoderLayer.forward, DecoderLayer.forward = real
        with torch.no_grad():
            tokens = greedy_decode(model.eval(), batch)
        got[remat] = (out.total_loss, {n: p.grad for n, p in
                                       model.named_parameters()},
                      gen.get_state(), calls["layers"], tokens)
    (l0, g0, s0, c0, t0), (l1, g1, s1, c1, t1) = got[False], got[True]
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for name, g in g0.items():
        assert (g is None) == (g1[name] is None), name
        if g is not None:
            assert torch.equal(g, g1[name]), name
    assert torch.equal(s0, s1)
    n_layers = 3 * cfg.model.num_hidden_layers  # clip, step encoders, decoder
    assert c0 == n_layers and c1 == 2 * n_layers, (c0, c1)
    assert torch.equal(t0, t1)


def test_remat_gradients_match_svpc_tpu():
    """Packed vivt with ``remat=True`` in both packages, dropout 0, the same
    Gumbel noise: the total loss within 1e-5 relative and every
    parameter's gradient within 2e-6 of its own largest element (and of
    1e-6 absolute where a gradient is zero up to rounding)."""
    import jax
    from svpc_tpu.model import SVPCModel as JaxModel
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.from_jax import _flatten, build_mapping

    jcfg, _, params, cfg, model = dropout_free("full")
    jcfg = jcfg.replace_model(remat=True)
    rmodel = SVPCModel(dataclasses.replace(cfg.model, remat=True))
    rmodel.load_state_dict(model.state_dict(), strict=True)
    jmodel = JaxModel(jcfg.model)
    batch = _packed_batches(jcfg, (2,))[0]
    noise = gumbel_noise((N_CLIPS, 1, jcfg.model.max_t_len,
                          jcfg.model.extended_vocab_size))

    def loss(p, b):
        return jmodel.apply(p, b, False, rngs={
            "dropout": jax.random.PRNGKey(0),
            "gumbel": jax.random.PRNGKey(0)}).total_loss

    with shared_gumbel(noise):
        grad = jax_compile(jax.value_and_grad(loss), params, batch)
        jloss, jgrad = grad(params, batch)
        out = rmodel(to_port(batch), deterministic=False)
        out.total_loss.backward()
    assert float(out.total_loss.detach()) == pytest.approx(float(jloss),
                                                           rel=1e-5)
    flat = _flatten(jgrad["params"])
    grads = dict(rmodel.named_parameters())
    for f_key, (t_key, tr) in build_mapping("full", 1).items():
        want = np.asarray(flat[f_key])
        want = want.T if tr == "T" else want
        got = grads[t_key].grad.numpy()
        tol = max(2e-6 * float(np.abs(want).max()), 1e-6)
        assert float(np.abs(got - want).max()) <= tol, t_key


@pytest.fixture(scope="module")
def knob_run(tmp_path_factory):
    """(fixture, workdir, result) of ``cli.train --remat
    --steps_per_dispatch 2 --profile_steps 1`` (TensorBoard on) for 2
    epochs of 3 host batches."""
    from svpc_torch.cli.train import main
    from svpc_torch.config import tiny_test_config
    from svpc_torch.data.synthetic import write_training_fixture

    root = tmp_path_factory.mktemp("knobs")
    fx = write_training_fixture(str(root / "data"), tiny_test_config("full"),
                                n_train=6, n_val=3, seed=0, max_clips=4)
    workdir = str(root / "run")
    res = main(_data_argv(fx) + GEOMETRY + [
        "--batch_size", "2", "--val_batch_size", "2", "--n_epoch", "2",
        "--remat", "--steps_per_dispatch", "2", "--profile_steps", "1",
        "--workdir", workdir])
    return fx, workdir, res


def test_cli_profile_trace_and_tensorboard_tags(knob_run):
    """The run trains (3 optimizer steps an epoch: a K=2 group and the
    tail's one), writes a Chrome trace of its first steady-state call
    under ``<workdir>/profile/`` and one TensorBoard events file holding
    svpc_tpu's tags, two values each; its sidecar keeps ``remat`` and
    ``steps_per_dispatch``."""
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    _, workdir, res = knob_run
    assert [s["step"] for s in res["steps"]] == list(range(6))
    with open(os.path.join(workdir, "profile", "trace.json")) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("addmm" in n or "mm" == n.split("::")[-1] for n in names)
    events = [f for f in os.listdir(workdir) if f.startswith("events.")]
    assert len(events) == 1, events
    acc = EventAccumulator(os.path.join(workdir, events[0]))
    acc.Reload()
    assert set(acc.Tags()["scalars"]) == TB_TAGS
    assert all(len(acc.Scalars(t)) == 2 for t in TB_TAGS)
    assert [e.step for e in acc.Scalars("Train/Loss")] == [3, 6]
    with open(os.path.join(workdir, "checkpoint_best.cfg.json")) as f:
        saved = json.load(f)
    assert saved["model"]["remat"] is True
    assert saved["train"]["steps_per_dispatch"] == 2


def test_inference_clis_read_a_knobbed_checkpoint(knob_run, tmp_path):
    """``cli.evaluate``, ``cli.caption``, ``cli.serve``'s service and
    ``cli.dump_memories`` load the checkpoint of a ``--remat
    --steps_per_dispatch 2`` run (training-only settings of its sidecar)
    and decode with it."""
    from svpc_torch.cli import caption, dump_memories, evaluate
    from svpc_torch.cli.serve import build_service

    fx, workdir, _ = knob_run
    argv = _data_argv(fx) + ["--checkpoint",
                             os.path.join(workdir, "checkpoint_best")]
    res = evaluate.main(argv + ["--split", "val", "--output_dir",
                                str(tmp_path / "eval"),
                                "--val_batch_size", "2"])
    with open(res["submission_path"]) as f:
        assert len(json.load(f)["results"]) == 3
    with open(os.path.join(fx["data_dir"],
                           "bosselut_split_yc2_test_anet_format.json")) as f:
        spec = {k: {"timestamps": a["timestamps"],
                    "ingredients": a["ingredients"]}
                for k, a in json.load(f).items()}
    spec_path = str(tmp_path / "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    out = caption.main(argv + ["--input_json", spec_path, "--output",
                               str(tmp_path / "captions.json")])
    assert set(out) == set(spec)
    service, _ = build_service(argv + ["--batch_videos", "2"])
    assert set(service.caption(spec)) == set(spec)
    path = dump_memories.main(argv + ["--split", "val", "--output_dir",
                                      str(tmp_path / "dump")])
    assert os.path.getsize(path) > 0
