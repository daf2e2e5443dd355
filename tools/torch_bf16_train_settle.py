#!/usr/bin/env python3
"""Does svpc_tpu's bfloat16 training also end every caption at once?
svpc_torch and svpc_tpu trained side by side at compute_dtype="bfloat16"
with bfloat16 optimizer state, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/torch_bf16_train_settle.py \
        [--width full|tiny] [--init svpc_tpu|port] [--steps_per_epoch 6] \
        [--epochs 2] [--seed 0]

Writes the training fixture of chip_smoke.py's train phase
(``write_training_fixture``: 96 train, 16 val videos; ``--width tiny``
at ``tiny_test_config("full")``), initialises svpc_tpu's model as its
trainer does (``train.loop.init_model``, seed 2019; ``--init port``: as
the port's trainer does) and carries the same weights into the port
(``state_dict_from_jax``).  Both then train on the
same packed batches (the port's ``CaptionDataset.batches`` with the
trainer's shuffle and packing, batch 16) with dropout 0 and the same
Gumbel noise (one numpy draw per logits shape), svpc_tpu through
``make_train_step``, the port through ``train_step``.  Finally both decode
the val split greedily on their EMA weights.

Prints one JSON line per step: each package's losses (the six of the
forward from the step's weights; the port's both at its own weights and
at svpc_tpu's weights of that step, the check of each step that
trajectories drifting apart do not blur) and each loss's band, twice the
sum over its rows of svpc_tpu's own |bf16 - f32| at those weights plus
1e-5 (the rule of tests/test_torch_bf16_model.py) plus the float32
parity bar of a loss, 1e-5 of it (tests/test_torch_train.py), and whether
the port is inside it.  Each step line also holds one update of the port
from svpc_tpu's whole state of that step (parameters, bfloat16 moments,
optimizer step, bfloat16 EMA shadow) against svpc_tpu's update from the
same state: the gradients, their norm and every updated tensor, in the
band of svpc_tpu's own bfloat16 - float32 gap (``update_check``), and
each tensor outside its own band.  Then one line with each package's count of empty val sentences (and the port's
count decoding svpc_tpu's trained weights), each gradient tensor that
left its own band at some step (``grads_above_band``) and the first step
that left its band: the losses at svpc_tpu's weights ("synced"), the losses on the
port's own trajectory ("own") and the update ("update"); null: none did.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LOSSES = ("total_loss", "caption_loss", "entity_loss", "action_loss",
          "re_entity_loss", "re_action_loss")
DROPOUT_OFF = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                   reasoner_dropout_prob=0.0)


def empty_sentences(submission: dict) -> dict:
    sents = [e["sentence"] for v in submission["results"].values()
             for e in v]
    return {"empty": sum(not s.strip() for s in sents), "of": len(sents)}


def jax_tree_from_port(model) -> dict:
    """The JAX parameter tree holding ``model``'s weights (the inverse of
    ``state_dict_from_jax``, by the same name mapping)."""
    from svpc_torch.model.from_jax import build_mapping

    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    tree: dict = {}
    for f_key, (t_key, transform) in build_mapping(
            model.cfg.model_mode, model.cfg.num_hidden_layers).items():
        *path, leaf = f_key.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(
            sd[t_key].T if transform == "T" else sd[t_key])
    return {"params": tree}


def _bert_adam_state(opt_state):
    """svpc_tpu's BertAdamState (step, m, v) inside its optax chain's
    state."""
    from svpc_tpu.train.optim import BertAdamState

    if isinstance(opt_state, BertAdamState):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _bert_adam_state(s)
            if found is not None:
                return found
    return None


def keeping_gradients(tx):
    """svpc_tpu's optimizer ``tx`` whose state also keeps the last
    gradients it was given, so that ``make_train_step`` hands them out
    (``state.opt_state[1]``) beside its own update."""
    import jax
    import jax.numpy as jnp
    import optax

    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def port_state_from_jax(jstate, cfg, steps_per_epoch: int):
    """A port TrainState holding svpc_tpu's ``jstate``: the parameters, the
    bfloat16 moments and optimizer step, the bfloat16 EMA shadow and the
    global step, each carried by ``state_dict_from_jax``'s name mapping
    (bfloat16 values pass through float32 exactly)."""
    import jax
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.from_jax import state_dict_from_jax
    from svpc_torch.train.optim import make_optimizer
    from svpc_torch.train.state import TrainState

    def port(tree):
        return state_dict_from_jax(jax.tree.map(np.asarray, tree),
                                   cfg.model)

    model = SVPCModel(cfg.model)
    model.load_state_dict(port(jstate.params), strict=True)
    opt = make_optimizer(cfg.train, steps_per_epoch,
                         dict(model.named_parameters()))
    adam = _bert_adam_state(jstate.opt_state)
    for key in ("m", "v"):
        for n, t in port(getattr(adam, key)).items():
            getattr(opt, key)[n].copy_(t)
    opt.step = int(adam.step)
    state = TrainState.create(model, opt, use_ema=True,
                              ema_dtype="bfloat16")
    for n, t in port(jstate.ema_shadow).items():
        state.ema_shadow[n].copy_(t)
    state.step = int(jstate.step)
    return state


def update_check(pstate, pgrads, pm, jnext16, jm16, jnext32, cfg) -> dict:
    """One optimizer step of the port from svpc_tpu's state against
    svpc_tpu's bfloat16 step from the same state, in the band of
    svpc_tpu's own bfloat16 - float32 gap (its float32-compute step from
    that state).  Each group (the gradients, the updated parameters, both
    moments, the EMA shadow) by its L2 norm over all its tensors:
    |port - svpc_tpu| <= 2 |gap| + 1e-5 |ones| (the float32 floor of
    tests/torch_parity.py's ``band``, per element).  The port's bfloat16
    rounding and svpc_tpu's are two draws of the same noise (in a group
    stored in bfloat16 the gap carries its rounding too), and Adam's
    division by sqrt(v) gives single elements a heavy tail, so a norm over
    many elements is the statistic; the worst tensor's ratio against its
    own band is reported, not held (a tensor of a few elements is a single
    draw).  The
    gradient norm by the same rule: | |g_port| - |g| | <= 2 |g32 - g|
    + 1e-5 + 1e-5 |g| (a difference of norms is bounded by the norm of the
    difference; the difference of svpc_tpu's two norms alone can vanish
    by chance)."""
    import jax
    from svpc_torch.model.from_jax import state_dict_from_jax

    def port(tree):
        return {n: t.numpy() for n, t in state_dict_from_jax(
            jax.tree.map(np.asarray, tree), cfg.model).items()}

    def norm(arrays):
        return math.sqrt(sum(float(np.square(a).sum()) for a in arrays))

    g16, g32 = (port(j.opt_state[1]) for j in (jnext16, jnext32))
    gap = norm(g32[n] - g16[n] for n in g16)
    gn16 = float(jm16["grad_norm"])
    gp = float(pm["grad_norm"])
    tol = 2.0 * gap + 1e-5 + 1e-5 * abs(gn16)
    res = {"grad_norm": {"svpc_tpu": gn16, "svpc_tpu_f32": norm(
        g32.values()), "port": gp, "band": tol,
        "in_band": abs(gp - gn16) <= tol}}
    inside = res["grad_norm"]["in_band"]
    a16, a32 = (_bert_adam_state(s.opt_state) for s in (jnext16, jnext32))
    for key, got, w16, w32 in (
            ("grads", pgrads, g16, g32),
            ("params", pstate.params, port(jnext16.params),
             port(jnext32.params)),
            ("m", pstate.optimizer.m, port(a16.m), port(a32.m)),
            ("v", pstate.optimizer.v, port(a16.v), port(a32.v)),
            ("ema", pstate.ema_shadow, port(jnext16.ema_shadow),
             port(jnext32.ema_shadow))):
        errs, gaps, size, worst = [], [], 0, (-1.0, "", 0.0, 0.0, 0.0)
        above = {}
        for n, t in got.items():
            errs.append(t.detach().float().numpy() - w16[n])
            gaps.append(w32[n] - w16[n])
            size += errs[-1].size
            e, g, w = norm(errs[-1:]), norm(gaps[-1:]), norm([w16[n]])
            r = e / (2.0 * g + 1e-5 * math.sqrt(errs[-1].size))
            worst = max(worst, (r, n, e, g, w))
            if r > 1.0:
                above[n] = r
        ratio = norm(errs) / (2.0 * norm(gaps) + 1e-5 * math.sqrt(size))
        # the worst tensor: its ratio, and |port - svpc_tpu|, |gap| and
        # svpc_tpu's |tensor| itself
        res[key] = {"ratio": ratio, "in_band": ratio <= 1.0,
                    "worst_tensor": worst[1], "worst_tensor_ratio": worst[0],
                    # every tensor outside its own band, by its ratio
                    "tensors_above_band": above,
                    "worst_tensor_norms": {"port_err": worst[2],
                                           "gap": worst[3],
                                           "svpc_tpu": worst[4]}}
        inside &= ratio <= 1.0
    res["in_band"] = bool(inside)
    return res


def settle(width: str = "full", epochs: int = 2, steps_per_epoch: int = 6,
           seed: int = 0, root: str = None, log=print, batch: int = 16,
           init: str = "svpc_tpu", layers: int = None,
           pin_shape: bool = False, n_val: int = 16) -> dict:
    """Train both packages side by side (see the module's docstring);
    returns the summary line's dict plus the step lines under "rows".

    ``init``: "svpc_tpu" draws the weights as svpc_tpu's trainer does,
    "port" as the port's trainer does (``SVPCModel`` from the train seed,
    chip_smoke.py's train phases).  ``layers`` cuts the encoder/decoder
    depth, ``pin_shape`` gives every train batch the packed shape of the
    largest (one JAX compile each, at XLA's lowest optimization level) and
    ``n_val`` sets the val split's videos: the test's cheaper settings."""
    import jax
    import jax.numpy as jnp
    import torch
    from svpc_tpu.config import Config as JaxConfig
    from svpc_tpu.config import tiny_test_config as jax_tiny
    from svpc_tpu.data.pipeline import CaptionDataset as JaxDataset
    from svpc_tpu.model import SVPCModel as JaxModel
    from svpc_tpu.train.loop import init_model
    from svpc_tpu.train.loop import run_greedy_eval as jax_greedy_eval
    from svpc_tpu.train.optim import make_optimizer as jax_optimizer
    from svpc_tpu.train.state import TrainState as JaxState
    from svpc_tpu.train.step import make_train_step
    from svpc_torch.config import Config, tiny_test_config
    from svpc_torch.data.pipeline import CaptionDataset
    from svpc_torch.data.synthetic import write_training_fixture
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.from_jax import state_dict_from_jax
    from svpc_torch.model.svpc import to_tensors
    from svpc_torch.data.packing import fixed_clip_budget
    from svpc_torch.train.loop import packing_builder, run_greedy_eval
    from svpc_torch.train.optim import make_optimizer
    from svpc_torch.train.state import TrainState
    from svpc_torch.train.step import (apply_step, grad_step,
                                       step_generator, train_step)
    from tests.torch_parity import row_terms, shared_gumbel_by_shape

    torch.manual_seed(seed)
    base, jbase = ((Config(), JaxConfig()) if width == "full" else
                   (tiny_test_config("full"), jax_tiny("full")))
    tmp = None
    if root is None:
        tmp = tempfile.TemporaryDirectory()
        root = tmp.name
    if layers:
        base = base.replace_model(num_hidden_layers=layers)
        jbase = jbase.replace_model(num_hidden_layers=layers)
    fx = write_training_fixture(os.path.join(root, "data"), base,
                                n_train=batch * steps_per_epoch, n_val=n_val,
                                seed=seed)
    paths = {k: fx[k] for k in ("data_dir", "word2idx_path", "verb2idx_path",
                                "duration_file", "video_feature_dir")}
    train_kw = dict(batch_size=batch, val_batch_size=batch, n_epoch=epochs,
                    optimizer_dtype="bfloat16")
    model_kw = dict(DROPOUT_OFF, compute_dtype="bfloat16")
    cfg = base.replace_data(**paths).replace_train(**train_kw) \
        .replace_model(**model_kw)
    jcfg = jbase.replace_data(**paths).replace_train(**train_kw) \
        .replace_model(**model_kw)
    jcfg32 = jcfg.replace_model(compute_dtype="float32")

    train_ds = CaptionDataset(cfg, "train", lazy_features=True)
    builder = packing_builder(cfg)
    if pin_shape:
        builder = packing_builder(
            cfg, n_clips=fixed_clip_budget(train_ds, batch,
                                           cfg.train.pack_clip_multiple),
            v_len=cfg.model.max_v_len)
    sample, _ = next(train_ds.batches(batch, builder=builder))
    if init == "svpc_tpu":
        params = jax.tree.map(np.asarray, init_model(jcfg32, sample)[1])
    else:
        params = jax_tree_from_port(SVPCModel(
            cfg.model, torch.Generator().manual_seed(cfg.train.seed)))
    jmodel16, jmodel32 = JaxModel(jcfg.model), JaxModel(jcfg32.model)

    model = SVPCModel(cfg.model)
    model.load_state_dict(state_dict_from_jax(params, cfg.model),
                          strict=True)
    total = math.ceil(len(train_ds) / batch)
    opt = make_optimizer(cfg.train, total, dict(model.named_parameters()))
    state = TrainState.create(model, opt, use_ema=True,
                              ema_dtype="bfloat16")
    tx = keeping_gradients(jax_optimizer(
        jcfg.train, total, model_mode=jcfg.model.model_mode,
        n_layers=jcfg.model.num_hidden_layers))
    jstate = JaxState.create(params, tx, use_ema=True, ema_dtype="bfloat16")
    rng = jax.random.PRNGKey(0)

    def jbatch(b, dtype):
        return {k: jnp.asarray(v, dtype) if k in ("clip_video_feature",
                                                   "video_feature")
                else jnp.asarray(v) for k, v in b.items()}

    def compiled(fn, *args):
        if not pin_shape:
            return jax.jit(fn)
        return jax.jit(fn).lower(*args).compile(
            {"xla_backend_optimization_level": 0})

    # the noise is shared from the first trace on: a step compiled
    # outside would draw its own
    with shared_gumbel_by_shape(seed + 7):
        jb16 = jbatch(sample, jnp.bfloat16)
        jstep = compiled(make_train_step(jmodel16, tx, jcfg), jstate, jb16,
                         rng)
        jstep32 = compiled(make_train_step(jmodel32, tx, jcfg32), jstate,
                           jbatch(sample, jnp.float32), rng)
        forwards = {d: compiled(lambda p, b, m=m: m.apply(
            p, b, False, rngs={"dropout": jax.random.PRNGKey(0),
                               "gumbel": jax.random.PRNGKey(0)}),
            jstate.params, jbatch(sample, dt))
            for d, m, dt in (("bfloat16", jmodel16, jnp.bfloat16),
                             ("float32", jmodel32, jnp.float32))}

        # ``synced``: the port at svpc_tpu's weights of each step (its
        # forward against svpc_tpu's at the same weights); ``state``: the
        # port's own trajectory from the same start
        synced = SVPCModel(cfg.model)
        steps = []
        first_out = {"synced": None, "own": None, "update": None}
        for epoch in range(epochs):
            for b, _ in train_ds.batches(batch, shuffle=True,
                                         seed=cfg.train.seed + epoch,
                                         builder=builder):
                t0 = time.perf_counter()
                out = {d: forwards[d](jstate.params, jbatch(b, dt))
                       for d, dt in (("bfloat16", jnp.bfloat16),
                                     ("float32", jnp.float32))}
                terms = {d: row_terms(o, b, cfg.model)
                         for d, o in out.items()}
                bands = {k: 2.0 * float(np.abs(terms["bfloat16"][k]
                                               - terms["float32"][k]).sum())
                         + 1e-5 for k in terms["bfloat16"]}
                bands["total_loss"] = sum(
                    v * (cfg.model.lambda_ if k.startswith("re_") else 1.0)
                    for k, v in list(bands.items()))
                tb = to_tensors(b, torch.device("cpu"), torch.bfloat16)
                synced.load_state_dict(state_dict_from_jax(
                    jax.tree.map(np.asarray, jstate.params), cfg.model),
                    strict=True)
                with torch.no_grad():
                    pout = state.model(tb, deterministic=False)
                    sout = synced(tb, deterministic=False)
                row = {"epoch": epoch, "step": len(steps),
                       "clips": int(b["clip_mask"].sum()), "losses": {}}
                inside = {"synced": True, "own": True}
                for k in LOSSES:
                    j = float(getattr(out["bfloat16"], k))
                    # the band of tests/test_torch_bf16_model.py, plus the
                    # float32 parity bar of a loss (1e-5 relative,
                    # tests/test_torch_train.py): a loss that bfloat16
                    # leaves exact in svpc_tpu (the re-simulator's action
                    # loss) has a band of 1e-5 and differs by float32
                    # rounding alone
                    tol = bands[k] + 1e-5 * abs(j)
                    row["losses"][k] = {
                        "svpc_tpu": j, "band": tol,
                        "svpc_tpu_f32": float(getattr(out["float32"], k))}
                    for name, o in (("synced", sout), ("own", pout)):
                        got = float(getattr(o, k))
                        ok = abs(got - j) <= tol
                        inside[name] &= ok
                        row["losses"][k][f"port_{name}"] = got
                        row["losses"][k][f"port_{name}_in_band"] = ok
                # one update of the port from svpc_tpu's state of this
                # step, against svpc_tpu's update from it
                ustate = port_state_from_jax(jstate, cfg, total)
                # (train_step split in its two halves, to read the
                # gradients between them)
                um = grad_step(ustate, tb, cfg, step_generator(
                    "cpu", cfg.train.seed, ustate.step))
                ugrads = {n: p.grad.clone()
                          for n, p in ustate.params.items()}
                um.update(apply_step(ustate, cfg, loss=um["loss"]))
                jnext32, _ = jstep32(jstate, jbatch(b, jnp.float32), rng)
                jstate, jm = jstep(jstate, jbatch(b, jnp.bfloat16), rng)
                row["update"] = update_check(ustate, ugrads, um, jstate, jm,
                                             jnext32, cfg)
                inside["update"] = row["update"]["in_band"]
                pm = train_step(state, tb, cfg)
                row["grad_norm"] = {"svpc_tpu": float(jm["grad_norm"]),
                                    "port": float(pm["grad_norm"])}
                row["step_loss"] = {"svpc_tpu": float(jm["loss"]),
                                    "port": float(pm["loss"])}
                row["seconds"] = time.perf_counter() - t0
                for name, ok in inside.items():
                    if not ok and first_out[name] is None:
                        first_out[name] = row["step"]
                steps.append(row)
                log(json.dumps(row))
                if len(steps) == (epoch + 1) * steps_per_epoch:
                    break

        eval_cfg = cfg.replace_train(val_batch_size=batch)
        eval_model = SVPCModel(cfg.model).eval()
        eval_model.load_state_dict(state.eval_params(), strict=True)
        with torch.no_grad():
            port_sub = run_greedy_eval(
                eval_model, CaptionDataset(eval_cfg, "val",
                                           lazy_features=True), eval_cfg)
        jeval = jcfg.replace_train(val_batch_size=batch)
        jax_ema = jax.tree.map(np.asarray, jstate.eval_params())
        jax_sub = jax_greedy_eval(
            jmodel16, jax_ema, JaxDataset(jeval, "val", lazy_features=True),
            jeval)
        # the port decoding svpc_tpu's trained weights: the same empty
        # count says the port's decode is faithful and the weights decide
        eval_model.load_state_dict(state_dict_from_jax(jax_ema, cfg.model),
                                   strict=True)
        with torch.no_grad():
            cross_sub = run_greedy_eval(
                eval_model, CaptionDataset(eval_cfg, "val",
                                           lazy_features=True), eval_cfg)
    result = {"width": width, "steps": len(steps),
              "empty": {"svpc_tpu": empty_sentences(jax_sub),
                        "port": empty_sentences(port_sub),
                        "port_on_svpc_tpu_weights":
                            empty_sentences(cross_sub)},
              "first_out_of_band": first_out,
              # the worst step of each update group, and the first
              # step's gradient norms from equal weights
              "update_worst": {k: max(r["update"][k]["ratio"]
                                      for r in steps)
                               for k in ("grads", "params", "m", "v",
                                         "ema")},
              "grad_norm_first_step": steps[0]["update"]["grad_norm"],
              # each gradient tensor that left its own band at some step,
              # by its worst ratio (the gate is the group's norm)
              "grads_above_band": {
                  n: max(r["update"]["grads"]["tensors_above_band"].get(
                      n, 0.0) for r in steps)
                  for r0 in steps
                  for n in r0["update"]["grads"]["tensors_above_band"]},
              "sentences_equal": sum(
                  a["sentence"] == b["sentence"]
                  for v in jax_sub["results"]
                  for a, b in zip(jax_sub["results"][v],
                                  port_sub["results"].get(v, []))),
              "sentences_equal_on_svpc_tpu_weights": sum(
                  a["sentence"] == b["sentence"]
                  for v in jax_sub["results"]
                  for a, b in zip(jax_sub["results"][v],
                                  cross_sub["results"].get(v, [])))}
    if tmp is not None:
        tmp.cleanup()
    return dict(result, rows=steps)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--width", choices=("full", "tiny"), default="full")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--steps_per_epoch", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init", choices=("svpc_tpu", "port"), default="svpc_tpu",
                   help="whose trainer's initialization draws the weights")
    args = p.parse_args(argv)
    res = settle(args.width, args.epochs, args.steps_per_epoch, args.seed,
                 init=args.init)
    res.pop("rows")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
