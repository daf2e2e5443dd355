"""svpc_torch's training and scoring at compute_dtype="bfloat16" on the CPU:
three train steps with bfloat16 compute and bfloat16 optimizer state
against svpc_tpu's ``make_train_step`` in the band of tests/torch_parity.py
(one layer, dropout 0, the same Gumbel noise), and a checkpoint trained by
``cli.train --compute_dtype bfloat16 --optimizer_dtype bfloat16`` read by
``cli.evaluate``, ``cli.caption`` and ``cli.serve`` at either compute
dtype."""

import json
import os

import numpy as np
import pytest
import torch

from tests.torch_parity import (band, bf16_pair, dropout_free, f32,
                                gumbel_noise, jax_compile, shared_gumbel,
                                to_port)
from tests.test_torch_eval_cli import GEOMETRY, _data_argv
from tests.test_torch_train import N_CLIPS, _packed_batches, _port_state

torch.set_num_threads(1)


def _jax_trajectory(jcfg, jmodel, params, batches, noise):
    """svpc_tpu's three steps from ``params``: (metrics per step, final
    state), the moments and the EMA shadow in the optimizer dtype."""
    import jax
    import jax.numpy as jnp
    from svpc_tpu.train.optim import make_optimizer
    from svpc_tpu.train.state import TrainState
    from svpc_tpu.train.step import make_train_step

    dt = jcfg.train.optimizer_dtype
    tx = make_optimizer(jcfg.train, 3, model_mode="full", n_layers=1)
    state = jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda p: TrainState.create(
            p, tx, use_ema=True, ema_dtype=dt), params))
    shadow = jax.tree.map(lambda p: np.asarray(jnp.asarray(p, dt)),
                          params["params"])
    state = state.replace(params=params, ema_shadow=shadow)
    rng = jax.random.PRNGKey(0)
    metrics = []
    with shared_gumbel(noise):
        step = jax_compile(make_train_step(jmodel, tx, jcfg), state,
                           batches[0], rng)
        for b in batches:
            state, m = step(state, b, rng)
            metrics.append(jax.tree.map(np.asarray, m))
    return metrics, state


def test_three_bf16_steps_match_make_train_step():
    """vivt packed, bfloat16 compute, bfloat16 moments and EMA shadow: each
    step's loss, caption loss and gradient norm within the band over the
    three steps, and after them every parameter (float32) and shadow
    tensor (bfloat16) within its own band; the parameters stay float32,
    the moments and shadow bfloat16.

    The band's float32 side is the port's float32-compute run of the same
    steps, which tests/test_torch_train.py holds to svpc_tpu's within
    1e-5 (a second JAX train-step compile would double this test's time).
    A shadow element, stored in bfloat16, may also differ by its own
    rounding step (one bfloat16 ulp): its exact value differs a little
    between the runs, and a value near a rounding boundary rounds either
    way."""
    from svpc_tpu.model import SVPCModel as JaxModel
    from svpc_torch.model.from_jax import _flatten, build_mapping
    from svpc_torch.train.step import train_step

    jcfg, _, params, cfg, model = dropout_free("full")
    jcfg = jcfg.replace_train(optimizer_dtype="bfloat16")
    cfg = cfg.replace_train(optimizer_dtype="bfloat16")
    jcfg16, cfg16, model16 = bf16_pair(jcfg, cfg, model)
    batches = _packed_batches(jcfg, (1, 2, 3))
    noise = gumbel_noise((N_CLIPS, 1, jcfg.model.max_t_len,
                          jcfg.model.extended_vocab_size))
    jax_metrics, jstate = _jax_trajectory(jcfg16, JaxModel(jcfg16.model),
                                          params, batches, noise)
    states, got = {}, {}
    for name, c, m in (("bfloat16", cfg16, model16), ("float32", cfg, model)):
        states[name] = _port_state(m, c, 3)
        with shared_gumbel(noise):
            got[name] = [train_step(states[name], to_port(b), c)
                         for b in batches]
    for key in ("loss", "caption_loss", "grad_norm"):
        j16 = np.array([float(m[key]) for m in jax_metrics])
        p16, p32 = (np.array([float(m[key]) for m in got[d]])
                    for d in ("bfloat16", "float32"))
        err = np.abs(p16 - j16).max()
        assert err <= band(j16, p32), (key, err, band(j16, p32))
    assert [int(m["n_word"]) for m in got["bfloat16"]] == \
        [int(m["n_word"]) for m in jax_metrics]

    mapping = build_mapping("full", 1)
    state, ref = states["bfloat16"], states["float32"]
    for port, p32, tree, dtype in (
            (state.params, ref.params, jstate.params["params"],
             torch.float32),
            (state.ema_shadow, ref.ema_shadow, jstate.ema_shadow,
             torch.bfloat16)):
        flat = _flatten(tree)
        for f_key, (t_key, tr) in mapping.items():
            w16 = flat[f_key].T if tr == "T" else flat[f_key]
            assert port[t_key].dtype == dtype, t_key
            tol = band(w16, p32[t_key])
            if dtype == torch.bfloat16:
                tol = tol + _ulp(f32(w16))
            err = np.abs(f32(port[t_key]) - f32(w16))
            assert (err <= tol).all(), (t_key, float(err.max()))
    assert {t.dtype for t in state.optimizer.m.values()} == {torch.bfloat16}


def _ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 unit in the last place at each |x| (8 significant
    bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


@pytest.fixture(scope="module")
def trained_bf16(tmp_path_factory):
    """(fixture, workdir, result) of cli.train at bfloat16 compute with
    bfloat16 optimizer state, 2 epochs with language eval."""
    from svpc_torch.cli.train import main
    from svpc_torch.config import tiny_test_config
    from svpc_torch.data.synthetic import write_training_fixture

    root = tmp_path_factory.mktemp("bf16_cli")
    fx = write_training_fixture(str(root / "data"), tiny_test_config("full"),
                                n_train=6, n_val=3, seed=0, max_clips=4)
    workdir = str(root / "run")
    res = main(_data_argv(fx) + GEOMETRY + [
        "--batch_size", "2", "--val_batch_size", "2", "--n_epoch", "2",
        "--lr", "1e-3", "--compute_dtype", "bfloat16",
        "--optimizer_dtype", "bfloat16", "--workdir", workdir])
    return fx, workdir, res


def test_bf16_checkpoint_evaluates_captions_and_serves(trained_bf16,
                                                       tmp_path):
    """The bfloat16 run trains (finite losses, CIDEr logged, the sidecar
    says bfloat16) and writes float32 parameters with bfloat16 moments and
    shadow; cli.evaluate reads its checkpoint_best at either compute dtype
    (the flag, not the sidecar, decides; every metric present and
    finite); cli.caption at bfloat16 equals CaptionService's sentences;
    cli.serve's service loads it at bfloat16 and reports the dtype."""
    from svpc_torch.cli import caption
    from svpc_torch.cli.evaluate import main as evaluate
    from svpc_torch.cli.serve import build_service

    fx, workdir, res = trained_bf16
    assert all(np.isfinite(s["loss"]) for s in res["steps"])
    assert len(res["history"]) == 2 and "CIDEr" in res["history"][0]["lang"]
    ckpt = os.path.join(workdir, "checkpoint_best")
    with open(ckpt + ".cfg.json") as f:
        sidecar = json.load(f)
    assert sidecar["model"]["compute_dtype"] == "bfloat16"
    assert sidecar["train"]["optimizer_dtype"] == "bfloat16"
    payload = torch.load(ckpt, weights_only=True)
    assert {t.dtype for t in payload["model"].values()} == {torch.float32}
    assert {t.dtype for t in payload["ema_shadow"].values()} \
        == {torch.bfloat16}
    assert {t.dtype for t in payload["optimizer"]["m"].values()} \
        == {torch.bfloat16}

    argv = _data_argv(fx) + ["--checkpoint", ckpt]
    subs = {}
    for dtype in ("bfloat16", "float32"):
        out = str(tmp_path / dtype)
        r = evaluate(argv + ["--split", "val", "--output_dir", out,
                             "--val_batch_size", "2", "--compute_dtype",
                             dtype])
        assert r["cfg"].model.compute_dtype == dtype
        for key in ("Bleu_4", "METEOR", "ROUGE_L", "CIDEr", "re4"):
            assert np.isfinite(r["metrics"][key]), (dtype, key)
        subs[dtype] = r["submission"]
        assert len(subs[dtype]["results"]) == 3

    with open(os.path.join(fx["data_dir"],
                           "bosselut_split_yc2_test_anet_format.json")) as f:
        spec = {k: {"timestamps": a["timestamps"],
                    "ingredients": a["ingredients"]}
                for k, a in json.load(f).items()}
    spec_path = str(tmp_path / "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    bf16 = ["--compute_dtype", "bfloat16"]
    out = caption.main(argv + bf16 + ["--input_json", spec_path, "--output",
                                      str(tmp_path / "captions.json")])
    service, _ = build_service(argv + bf16 + ["--batch_videos", "2"])
    assert service.cfg.model.compute_dtype == "bfloat16"
    assert service.feature_dtype == torch.bfloat16
    assert service.model.compute_dtype == torch.bfloat16
    want = service.caption(spec)
    assert {v: [c["sentence"] for c in clips] for v, clips in out.items()} \
        == {v: [c["sentence"] for c in clips] for v, clips in want.items()}
