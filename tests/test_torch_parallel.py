"""svpc_torch's train step on the dp x tp mesh (parallel/mesh.py), each
case on gloo ranks in their own processes (svpc_torch.parallel.worker,
which imports no JAX), held against svpc_tpu's single-device
``make_train_step``: two steps from the same weights (carried by
``from_jax``) on svpc_tpu's ``synthetic_batch`` (4 videos, dense), every
dropout rate 0 and the same Gumbel noise on both sides.  The tolerances
are svpc_tpu's own for its mesh runs (tests/test_zero1.py): losses 1e-5
relative, parameters rtol 2e-4 / atol 1e-5, a bfloat16-held EMA shadow
rtol 1e-2 / atol 1e-3.  A dp2 case with dropout on holds the mesh run to
the port's own one-process run (svpc_tpu draws other numbers)."""

import functools
import os
import pickle

import numpy as np
import pytest
import torch

from tests.torch_parity import dropout_free, gumbel_noise, shared_gumbel

torch.set_num_threads(1)

B = 4          # videos a global batch: 2 a dp rank at dp2
SEEDS = (5, 6)  # one synthetic batch a step
RANK_TIMEOUT = 60


@functools.lru_cache(maxsize=None)
def _svpc_tpu_run(opt_dtype: str):
    """svpc_tpu's two single-device steps: (batches, noise, initial
    weights in the port's names, per-step metrics, final parameters and
    EMA shadow in the port's names)."""
    import jax
    from svpc_tpu.data.synthetic import synthetic_batch
    from svpc_tpu.train.optim import make_optimizer as jax_optimizer
    from svpc_tpu.train.state import TrainState as JaxState
    from svpc_tpu.train.step import make_train_step
    from svpc_torch.model.from_jax import state_dict_from_jax
    from tests.torch_parity import jax_compile

    jcfg, jmodel, params, cfg, _ = dropout_free("full")
    jcfg = jcfg.replace_train(optimizer_dtype=opt_dtype)
    batches = [synthetic_batch(jcfg, B, seed=s) for s in SEEDS]
    m = jcfg.model
    noise = gumbel_noise((B, m.max_n_sen, m.max_t_len,
                          m.extended_vocab_size))
    tx = jax_optimizer(jcfg.train, len(SEEDS), model_mode="full",
                       n_layers=1)
    jstate = jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda p: JaxState.create(
            p, tx, use_ema=True, ema_dtype=opt_dtype), params))
    shadow = jax.tree.map(lambda x, s: np.asarray(x).astype(s.dtype),
                          params["params"], jstate.ema_shadow)
    jstate = jstate.replace(params=params, ema_shadow=shadow)
    rng = jax.random.PRNGKey(0)
    metrics = []
    with shared_gumbel(noise):
        jstep = jax_compile(make_train_step(jmodel, tx, jcfg), jstate,
                            batches[0], rng)
        for b in batches:
            jstate, jm = jstep(jstate, b, rng)
            metrics.append({k: float(jm[k]) for k in
                            ("loss", "caption_loss", "grad_norm")})
    to_port = lambda tree: state_dict_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), tree), cfg.model)
    return (batches, noise, state_dict_from_jax(params, cfg.model), metrics,
            to_port(jstate.params), to_port(jstate.ema_shadow))


def _mesh_run(tmp_path, cfg, weights, batches, noise, dp, tp):
    """The port's two steps on a dp x tp gloo mesh -> result.pt, and the
    ranks' rows."""
    import json

    from svpc_torch.parallel.worker import run_job

    files = {"weights": tmp_path / "weights.pt",
             "batches": tmp_path / "batches.pkl"}
    torch.save(weights, files["weights"])
    with open(files["batches"], "wb") as f:
        pickle.dump(batches, f)
    spec = dict(cfg=cfg.to_dict(), weights=str(files["weights"]),
                batches=str(files["batches"]), steps_per_epoch=len(batches),
                device="cpu", dp=dp, tp=tp, out=str(tmp_path / "run"))
    if noise is not None:
        files["noise"] = tmp_path / "noise.pkl"
        with open(files["noise"], "wb") as f:
            pickle.dump([noise] * len(batches), f)
        spec["noise"] = str(files["noise"])
    run_job("steps", spec, dp * tp, RANK_TIMEOUT)
    rows = []
    for r in range(dp * tp):
        with open(os.path.join(spec["out"], f"rank{r}.json")) as f:
            rows.append(json.load(f))
    return torch.load(os.path.join(spec["out"], "result.pt"),
                      weights_only=False), rows


def _close(got, want, rtol, atol, what):
    for name, w in want.items():
        np.testing.assert_allclose(got[name].float().numpy(),
                                   w.float().numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("dp,tp,opt_dtype", [(2, 1, "float32"),
                                             (1, 2, "float32"),
                                             (2, 2, "bfloat16")],
                         ids=["dp2_zero1", "tp2", "dp2xtp2_zero1_bf16"])
def test_mesh_steps_match_svpc_tpu(tmp_path, dp, tp, opt_dtype):
    """Two steps on the mesh (ZeRO-1 wherever dp > 1) against svpc_tpu's
    single-device steps; the moments really are sliced (each dp rank
    holds about 1/dp of the bytes it would without ZeRO-1), and the
    tp-split tensors' norms enter the clips whole (the gradient norm
    matches)."""
    _, _, _, cfg, _ = dropout_free("full")
    cfg = cfg.replace_train(zero1=dp > 1, optimizer_dtype=opt_dtype)
    batches, noise, weights, want, params, shadow = _svpc_tpu_run(opt_dtype)
    res, rows = _mesh_run(tmp_path, cfg, weights, batches, noise, dp, tp)
    for i, (got, w) in enumerate(zip(res["losses"], want)):
        for key in ("loss", "caption_loss", "grad_norm"):
            assert got[key] == pytest.approx(w[key], rel=1e-5), (i, key)
    _close(res["state"]["model"], params, 2e-4, 1e-5, "parameter")
    ema_tol = (1e-2, 1e-3) if opt_dtype == "bfloat16" else (2e-4, 1e-5)
    _close(res["state"]["ema_shadow"], shadow, *ema_tol, "EMA")
    for row in rows:
        held, whole = row["bytes"], row["bytes_without_zero1"]
        for key in ("m", "v", "ema"):
            if dp > 1:
                assert held[key] < 0.52 * whole[key], (key, row)
            else:
                assert held[key] == whole[key], (key, row)


def test_dp2_with_dropout_repeats_one_process_run(tmp_path):
    """Dropout on (every rate the config's default) and the sampler's own
    Gumbel draws: the dp2 ZeRO-1 run draws over the global shape, so its
    two steps repeat the one-process run on the same global batches."""
    from svpc_tpu.data.synthetic import synthetic_batch
    from svpc_torch.config import tiny_test_config
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.svpc import to_tensors
    from svpc_torch.parallel.worker import train_state
    from svpc_torch.train.step import train_step

    cfg = tiny_test_config("full").replace_model(num_hidden_layers=1) \
        .replace_train(zero1=True)
    assert cfg.model.hidden_dropout_prob > 0
    batches = [synthetic_batch(cfg, B, seed=s) for s in SEEDS]
    model = SVPCModel(cfg.model, torch.Generator().manual_seed(3))
    weights = {n: t.clone() for n, t in model.state_dict().items()}
    res, _ = _mesh_run(tmp_path, cfg, weights, batches, None, 2, 1)
    state = train_state(cfg, model, len(batches))
    for i, b in enumerate(batches):
        m = train_step(state, to_tensors(b, torch.device("cpu")), cfg)
        for key in ("loss", "caption_loss", "grad_norm"):
            assert res["losses"][i][key] == pytest.approx(float(m[key]),
                                                          rel=1e-5), (i, key)
    _close(res["state"]["model"], {n: p.detach() for n, p in
                                   state.params.items()}, 2e-4, 1e-5,
           "parameter")
    _close(res["state"]["ema_shadow"], state.ema_shadow, 2e-4, 1e-5, "EMA")
