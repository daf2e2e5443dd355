"""svpc_torch.train.optim against svpc_tpu.train.optim on the tiny vivt
model's parameter tree (carried by name): the LR schedules, BertAdam with
the global clip (float32 and bfloat16 moments, freeze_glove), the
reference decay grouping, and the EMA update, f32 on the CPU."""

import numpy as np
import pytest
import torch

from tests.torch_parity import dropout_free, jax_compile

torch.set_num_threads(1)


def test_schedules_match_jax():
    """Each schedule, several warmup proportions, every step of a short
    run and past its end; warmup >= 1 raises on both sides."""
    from svpc_tpu.train.optim import lr_schedule_fn as jax_fn
    from svpc_torch.train.optim import lr_schedule_fn

    for schedule in (None, "none", "constant", "warmup_constant",
                     "warmup_linear", "warmup_cosine"):
        for warmup, t_total in ((0.0, 7), (0.1, 13), (0.5, 6), (0.1, -1)):
            want, got = jax_fn(schedule, warmup, t_total), \
                lr_schedule_fn(schedule, warmup, t_total)
            for step in range(max(t_total, 3) + 2):
                w = float(np.asarray(want(np.float32(step))))
                g = float(got(step))
                assert g == pytest.approx(w, rel=1e-6, abs=1e-7), \
                    (schedule, warmup, t_total, step)
    for fn in (jax_fn, lr_schedule_fn):
        with pytest.raises(ValueError, match="warmup"):
            fn("warmup_linear", 1.0, 10)


def _trees(seed: int, scale: float):
    """(JAX grads tree, port grads by name) of random gradients on the tiny
    vivt tree; ``scale`` sets how often the clips fire."""
    import jax

    _, _, params = dropout_free("full")[:3]
    rng = np.random.RandomState(seed)
    tree = jax.tree.map(lambda p: (scale * rng.randn(*p.shape)).astype(
        np.float32), params)
    return tree, _to_port(tree)


def _to_port(tree):
    from svpc_torch.model.from_jax import build_mapping, _flatten

    flat = _flatten(tree["params"] if "params" in tree else tree)
    return {t: torch.tensor(flat[f].T if tr == "T" else flat[f])
            for f, (t, tr) in build_mapping("full", 1).items()}


def test_bert_adam_clip_decay_freeze_and_ema_match_jax():
    """make_optimizer's chain (global clip, BertAdam with per-parameter
    clip, decoupled decay, schedule) for 3 steps on the same gradients:
    parameters after each step within 1e-6 of each tensor's scale and the
    final moments within 1e-5 in float32; with bfloat16 moments (+
    freeze_glove) a moment may round to the neighbouring bfloat16 value
    (2**-8 relative), so parameters hold 1e-2 of one step (lr) and moments
    one bfloat16 unit.  The decay grouping equals reference_decay_mask_fn's,
    its quirks included; the global clip and the EMA (float32 and bfloat16
    shadow) match."""
    import jax
    from svpc_tpu.config import TrainConfig as JaxTrainConfig
    from svpc_tpu.train import optim as jo
    from svpc_torch.config import TrainConfig
    from svpc_torch.model.from_jax import build_mapping, _flatten
    from svpc_torch.train import optim as po

    _, _, params = dropout_free("full")[:3]
    mapping = build_mapping("full", 1)
    # the decay grouping, resolved through the reference names
    jmask = _flatten(jo.reference_decay_mask_fn("full", 1)(params)["params"])
    for f_key, (t_key, _) in mapping.items():
        assert po.decays(t_key) == bool(jmask[f_key]), t_key
    assert po.decays("text_embeddings.word_fc.0.weight")
    assert po.decays("decoder.layer.0.norm1.weight")
    assert po.decays("decoder.layer.0.norm2.weight")
    assert not po.decays("recipe_encoder.bias_ih_l0")
    assert not po.decays("encoder.layer.0.output.LayerNorm.weight")

    # the global clip alone (fires at this scale)
    jg, pg = _trees(11, 1.0)
    clip = lambda g: jo.clip_by_global_norm_torch(1.0).update(g, None)[0]
    want = jax_compile(clip, jg["params"])(jg["params"])
    got = po.clip_by_global_norm_torch(list(pg.values()), 1.0)
    for (name, w), g in zip(_to_port(want).items(), got):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-9, err_msg=name)

    for dtype, freeze in (("float32", False), ("bfloat16", True)):
        lr = 1e-3
        kw = dict(optimizer_dtype=dtype, freeze_glove=freeze, n_epoch=2,
                  lr=lr)
        tx = jo.make_optimizer(JaxTrainConfig(**kw), 2, model_mode="full",
                               n_layers=1)
        jp = jax.tree.map(np.asarray, params)["params"]
        # compiled: eager jnp calls compile one program per leaf shape
        opt_state = jax_compile(tx.init, jp)(jp)
        update = jax_compile(tx.update, jp, opt_state, jp)  # grads ~ params
        port_params = {n: t.clone() for n, t in _to_port(params).items()}
        opt = po.make_optimizer(TrainConfig(**kw), 2, port_params)
        for step, scale in enumerate((0.01, 1.0, 0.3)):
            jg, pg = _trees(20 + step, scale)
            updates, opt_state = update(jg["params"], opt_state, jp)
            jp = jax.tree.map(lambda p, u: p + np.asarray(u), jp, updates)
            opt.update(pg)
            for name, w in _to_port(jp).items():
                tol = (1e-6 * max(float(w.abs().max()), 1e-3)
                       if dtype == "float32" else 1e-2 * lr)
                np.testing.assert_allclose(
                    port_params[name].numpy(), w.numpy(), rtol=0, atol=tol,
                    err_msg=f"{dtype} step {step} {name}")
        assert opt.step == int(opt_state[1].step) == 3
        for key in ("m", "v"):
            want = _to_port(jax.tree.map(
                lambda x: np.asarray(x, np.float32),
                getattr(opt_state[1], key)))
            for name, w in want.items():
                got = getattr(opt, key)[name]
                assert got.dtype == (torch.bfloat16 if dtype == "bfloat16"
                                     else torch.float32)
                np.testing.assert_allclose(
                    got.float().numpy(), w.numpy(),
                    rtol=1e-5 if dtype == "float32" else 2 ** -7,
                    atol=1e-6 * float(w.abs().max()) + 1e-30,
                    err_msg=f"{dtype} {key} {name}")
        if freeze:
            start = _to_port(params)
            for name in po.GLOVE_TABLES:
                assert torch.equal(port_params[name], start[name]), name

    # EMA: warmup-aware decay, float32 and bfloat16 shadows
    p_tree = jax.tree.map(lambda x: np.asarray(x) + 0.5, params["params"])
    ema = lambda s, p, step: jo.ema_update(s, p, step, 0.9999)
    compiled = {}
    for dtype, step in (("float32", 0), ("bfloat16", 5), ("float32", 9000)):
        shadow = jax.tree.map(
            lambda x: np.asarray(x).astype(jax.numpy.bfloat16)
            if dtype == "bfloat16" else np.asarray(x), params["params"])
        args = (shadow, p_tree, np.float32(step))
        if dtype not in compiled:
            compiled[dtype] = jax_compile(ema, *args)
        want = compiled[dtype](*args)
        port_shadow = {n: t.to(getattr(torch, dtype))
                       for n, t in _to_port(params).items()}
        po.ema_update(port_shadow, _to_port(p_tree), step, 0.9999)
        # XLA may fuse the blend into one rounding: an f32 ulp, which may
        # move a bfloat16 shadow to its neighbour
        ulp = 2 ** -8 if dtype == "bfloat16" else 2.4e-7
        for name, w in _to_port(jax.tree.map(
                lambda x: np.asarray(x, np.float32), want)).items():
            np.testing.assert_allclose(
                port_shadow[name].float().numpy(), w.numpy(), rtol=ulp,
                atol=ulp * float(w.abs().max()),
                err_msg=f"ema {dtype} {step} {name}")
