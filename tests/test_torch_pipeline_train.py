"""svpc_torch's GPipe training (parallel/pipeline.py) on gloo CPU ranks,
each in its own process (svpc_torch.parallel.worker, which imports no
JAX).

The pipelined steps are held against svpc_tpu's single-device
``make_train_step``, not against svpc_tpu's own 8-device gpipe:
svpc_tpu's tests/test_pipeline.py already proves its pipeline equal to
its pp=1 step at dropout 0, and compiling its gpipe here would repeat the
suite's slowest test.  Two steps from the same weights (carried by
``from_jax``) on svpc_tpu's ``synthetic_batch`` (4 videos, dense, two
layers a trunk), every dropout rate 0 and the same Gumbel noise on both
sides; the tolerances are svpc_tpu's own for its mesh runs
(tests/test_zero1.py): losses 1e-5 relative, parameters and EMA rtol
2e-4 / atol 1e-5.  With dropout on, a pp run draws every trunk layer's
masks over the whole batch (``StageDraws``), so it repeats the port's
own one-process run.  The stage-resident parameter count and the bytes
of a rank's Adam moments and EMA are held to the reckoning at the paper's
full-width vivt."""

import functools
import json
import os
import pickle

import numpy as np
import pytest
import torch

from tests.torch_parity import dropout_free, gumbel_noise, shared_gumbel

torch.set_num_threads(1)

B = 4          # videos a global batch: 2 a dp rank at dp2
SEEDS = (5, 6)  # one synthetic batch a step
LAYERS = 2     # one layer a stage at pp2
RANK_TIMEOUT = 60
ENV = {"OMP_NUM_THREADS": "1"}


@functools.lru_cache(maxsize=None)
def _svpc_tpu_run():
    """svpc_tpu's two single-device steps at two layers a trunk:
    (batches, noise, initial weights in the port's names, per-step
    metrics, final parameters and EMA shadow in the port's names)."""
    import jax
    from svpc_tpu.data.synthetic import synthetic_batch
    from svpc_tpu.train.optim import make_optimizer as jax_optimizer
    from svpc_tpu.train.state import TrainState as JaxState
    from svpc_tpu.train.step import make_train_step
    from svpc_torch.model.from_jax import state_dict_from_jax
    from tests.torch_parity import jax_compile

    jcfg, jmodel, params, cfg, _ = dropout_free("full", layers=LAYERS)
    batches = [synthetic_batch(jcfg, B, seed=s) for s in SEEDS]
    m = jcfg.model
    noise = gumbel_noise((B, m.max_n_sen, m.max_t_len,
                          m.extended_vocab_size))
    tx = jax_optimizer(jcfg.train, len(SEEDS), model_mode="full",
                       n_layers=LAYERS)
    jstate = jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda p: JaxState.create(p, tx, use_ema=True),
                       params))
    jstate = jstate.replace(params=params, ema_shadow=jax.tree.map(
        np.asarray, params["params"]))
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


def _mesh_run(tmp_path, cfg, weights, batches, noise, dp, pp, tp):
    """The port's two steps on a dp x pp x tp gloo mesh -> result.pt, and
    the ranks' rows."""
    from svpc_torch.parallel.worker import run_job

    base = tmp_path / f"dp{dp}pp{pp}tp{tp}"
    base.mkdir()
    files = {"weights": base / "weights.pt", "batches": base / "batches.pkl"}
    torch.save(weights, files["weights"])
    with open(files["batches"], "wb") as f:
        pickle.dump(batches, f)
    spec = dict(cfg=cfg.to_dict(), weights=str(files["weights"]),
                batches=str(files["batches"]), steps_per_epoch=len(batches),
                device="cpu", dp=dp, pp=pp, tp=tp, out=str(base / "run"))
    if noise is not None:
        files["noise"] = base / "noise.pkl"
        with open(files["noise"], "wb") as f:
            pickle.dump([noise] * len(batches), f)
        spec["noise"] = str(files["noise"])
    world = dp * pp * tp
    run_job("steps", spec, world, RANK_TIMEOUT, ENV)
    rows = []
    for r in range(world):
        with open(os.path.join(spec["out"], f"rank{r}.json")) as f:
            rows.append(json.load(f))
    return torch.load(os.path.join(spec["out"], "result.pt"),
                      weights_only=False), rows


def _close(got, want, rtol, atol, what):
    assert set(got) >= set(want), what
    for name, w in want.items():
        np.testing.assert_allclose(got[name].float().numpy(),
                                   w.float().numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {name}")


def test_pp_steps_match_svpc_tpu(tmp_path):
    """pp2, dp2 x pp2 with ZeRO-1 and pp2 x tp2: two steps against
    svpc_tpu's single-device steps (the whole checkpoint gathered over
    pp, tp and dp matches), and each rank holds only its stage's trunk
    layer: the parameters it holds are the whole model's less the other
    stage's layers, and its moments and EMA are those tensors' (sliced
    over dp with ZeRO-1)."""
    _, _, _, cfg, model = dropout_free("full", layers=LAYERS)
    batches, noise, weights, want, params, shadow = _svpc_tpu_run()
    n_all = sum(p.numel() for p in model.parameters())
    n_trunk = sum(p.numel() for n, p in model.named_parameters()
                  if n.split(".")[0] in ("encoder", "decoder")
                  and ".layer." in n)
    for dp, pp, tp in ((1, 2, 1), (2, 2, 1), (1, 2, 2)):
        c = cfg.replace_train(zero1=dp > 1, pp_size=pp)
        if tp > 1:
            c = c.replace_model(vocab_pad_multiple=tp)
        res, rows = _mesh_run(tmp_path, c, weights, batches, noise, dp, pp,
                              tp)
        case = f"dp{dp} pp{pp} tp{tp}"
        for i, (got, w) in enumerate(zip(res["losses"], want)):
            for key in ("loss", "caption_loss", "grad_norm"):
                assert got[key] == pytest.approx(w[key], rel=1e-5), \
                    (case, i, key)
        _close(res["state"]["model"], params, 2e-4, 1e-5,
               f"{case} parameter")
        _close(res["state"]["ema_shadow"], shadow, 2e-4, 1e-5, f"{case} EMA")
        assert set(res["state"]["optimizer"]["m"]) == set(params)
        if tp == 1:
            for row in rows:
                assert row["n_params"] == n_all - n_trunk // pp, (case, row)
                whole = row["n_params"] * 4
                assert row["bytes_without_zero1"] == {
                    "m": whole, "v": whole, "ema": whole}, (case, row)
                for key in ("m", "v", "ema"):
                    held = row["bytes"][key]
                    assert (held < 0.52 * whole if dp > 1
                            else held == whole), (case, key, row)


def test_pp2_with_dropout_repeats_one_process_run(tmp_path):
    """Dropout on (every rate the config's default), --remat, and the
    sampler's own Gumbel draws: the pp2 run's two steps repeat the
    one-process run on the same batches from the same weights."""
    from svpc_torch.config import tiny_test_config
    from svpc_torch.data.synthetic import synthetic_batch
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.svpc import to_tensors
    from svpc_torch.parallel.worker import train_state
    from svpc_torch.train.step import train_step

    cfg = tiny_test_config("full").replace_model(num_hidden_layers=LAYERS,
                                                 remat=True)
    assert cfg.model.hidden_dropout_prob > 0
    batches = [synthetic_batch(cfg, B, seed=s) for s in SEEDS]
    model = SVPCModel(cfg.model, torch.Generator().manual_seed(3))
    weights = {n: t.clone() for n, t in model.state_dict().items()}
    res, _ = _mesh_run(tmp_path, cfg.replace_train(pp_size=2), weights,
                       batches, None, 1, 2, 1)
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


def test_cli_train_pp2_matches_one_rank_and_resumes_across_layouts(
        tmp_path):
    """cli.train --pp_size 2 --steps_per_dispatch 2 on 2 ranks (dropout
    on, both optimizer steps of the epoch from one call, the pipelined
    validation eval step, the greedy decode on the gathered trunk) gives
    the one-rank epoch; the pp2 checkpoint resumes on 1 rank and the
    one-rank checkpoint on pp2, and their second epochs agree, the final
    parameters within rtol 2e-4 / atol 1e-5."""
    from svpc_torch.cli.train import main as train_main
    from svpc_torch.parallel.worker import run_ranks
    from tests.test_torch_parallel_loop import (GEOMETRY, _assert_same_epoch,
                                                _fixture)

    argv = _fixture(tmp_path) + GEOMETRY + [
        "--num_hidden_layers", str(LAYERS), "--batch_size", "2",
        "--val_batch_size", "2", "--lr", "1e-3", "--no_tensorboard",
        "--max_steps_per_epoch", "2"]
    wd = {k: str(tmp_path / k) for k in "ab"}

    def pp2(extra, name):
        run_ranks(["svpc_torch.cli.train", *argv, "--pp_size", "2", *extra],
                  2, RANK_TIMEOUT, str(tmp_path / f"logs_{name}"), ENV)

    def history(w):
        with open(os.path.join(w, "history.json")) as f:
            return json.load(f)

    train_main(argv + ["--n_epoch", "1", "--workdir", wd["a"]])
    pp2(["--n_epoch", "1", "--workdir", wd["b"], "--steps_per_dispatch",
         "2"], "b")
    _assert_same_epoch(history(wd["b"])[0], history(wd["a"])[0])
    with open(os.path.join(wd["b"], "greedy_pred_val_epoch0.json")) as f:
        assert json.load(f)["results"]

    # the pp2 checkpoint on 1 rank, the one-rank checkpoint on pp2
    train_main(argv + ["--n_epoch", "2", "--workdir", wd["b"],
                       "--resume_from", wd["b"] + "/checkpoint_last"])
    pp2(["--n_epoch", "2", "--workdir", wd["a"], "--resume_from",
         wd["a"] + "/checkpoint_last"], "a")
    one, piped = history(wd["b"]), history(wd["a"])
    assert [h["epoch"] for h in one] == [h["epoch"] for h in piped] == [0, 1]
    _assert_same_epoch(piped[1], one[1])
    ckpt = {k: torch.load(os.path.join(w, "checkpoint_last"),
                          weights_only=True) for k, w in wd.items()}
    assert ckpt["a"]["step"] == ckpt["b"]["step"] == 4
    for group in ("model", "ema_shadow"):
        assert list(ckpt["a"][group]) == list(ckpt["b"][group])
        for n, want in ckpt["b"][group].items():
            torch.testing.assert_close(ckpt["a"][group][n], want,
                                       rtol=2e-4, atol=1e-5, msg=n)


def test_stage_residency_at_full_width():
    """The paper's full-width vivt (173 tensors, 40,143,024 parameters):
    a pp2 rank holds 32,457,648 of them (the clip encoder's and the
    decoder's trunks, 15,370,752, halved), and its float32 m, v and EMA
    come to 389,491,776 B against 481,716,288 B whole; ZeRO-1 at dp2
    slices them over dp as well.  Built on this process's CPU, the
    optimizer over a stage's tensors (no process group is needed)."""
    from svpc_torch.config import ModelConfig, TrainConfig
    from svpc_torch.model import SVPCModel
    from svpc_torch.parallel.mesh import Mesh, zero1_dims
    from svpc_torch.train.optim import make_optimizer
    from svpc_torch.train.state import TrainState

    whole = SVPCModel(ModelConfig())
    assert len(whole.full_shapes) == 173
    assert sum(p.numel() for p in whole.parameters()) == 40_143_024
    trunk = {k: sum(p.numel() for n, p in whole.named_parameters()
                    if n.startswith(f"{k}.layer."))
             for k in ("encoder", "decoder")}
    assert trunk == {"encoder": 7_093_248, "decoder": 8_277_504}
    for dp, stage in ((1, 0), (1, 1), (2, 1)):
        mesh = Mesh(dp, 1, 0, 0, pp_size=2, pp_index=stage)
        model = SVPCModel(ModelConfig()).shard(mesh)
        params = dict(model.named_parameters())
        assert sum(p.numel() for p in params.values()) == 32_457_648
        layers = {n.split(".")[2] for n in params
                  if n.startswith(("encoder.layer.", "decoder.layer."))}
        assert layers == {str(stage)}
        opt = make_optimizer(
            TrainConfig(zero1=dp > 1), 1, params, mesh=mesh,
            tp_split=model.param_tp_dims,
            zero1_split=(zero1_dims(model.full_shapes, mesh) if dp > 1
                         else None))
        state = TrainState.create(model, opt, use_ema=True)
        held = sum(t.numel() * t.element_size() for d in
                   (opt.m, opt.v, state.ema_shadow) for t in d.values())
        if dp == 1:
            assert held == 389_491_776
        else:
            assert 0.5 * 389_491_776 <= held < 0.52 * 389_491_776
