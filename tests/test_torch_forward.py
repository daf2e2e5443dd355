"""svpc_torch's training forward (every loss, the textual re-simulator)
against svpc_tpu's ``model.apply(..., deterministic=False)`` on carried
weights and the same seeded numpy batch, f32 on the CPU, with every
dropout rate 0 and the same Gumbel noise on both sides; the routing of
attention by ``deterministic``; dropout drawn from the caller's generator.
"""

import functools

import numpy as np
import pytest
import torch

from tests.torch_parity import (dropout_free, gumbel_noise, jax_compile,
                                shared_gumbel, to_port)

torch.set_num_threads(1)

MODES = ["full", "reason_copy", "copy", "video"]
# gradients: "full" reaches every loss (the re-simulator included); the
# other modes differ from it only in what the value check covers
GRAD_CASES = {("full", False), ("full", True), ("video", False)}
# "full" packed runs two encoder/decoder layers, so the gradient through a
# stacked layer is held against jax.grad too; the other cases take one
# (each layer adds to the one JAX compile)
TWO_LAYERS = ("full", True)
# tensors whose gradient is zero in exact arithmetic (a softmax is blind to
# a shift of all its scores): key biases, and Wing's bias (one term per
# decoder row, the same for every entity).  Both packages give rounding
# noise there, held to an absolute bound instead.
SHIFT_INVARIANT = ("key.bias", "Wing.bias")


def _setup(mode: str, packed: bool):
    return dropout_free(mode, layers=2 if (mode, packed) == TWO_LAYERS
                        else 1)


@functools.lru_cache(maxsize=None)
def _batch(mode: str, packed: bool):
    from svpc_tpu.data.packing import pack_batch
    from svpc_tpu.data.synthetic import synthetic_batch

    cfg = dropout_free(mode)[0]
    b = synthetic_batch(cfg, 3, seed=5)
    return pack_batch(b, cfg.model.max_t_len) if packed else b


def _noise(mode: str, packed: bool):
    if mode != "full":
        return None
    cfg = dropout_free(mode)[0].model
    b = _batch(mode, packed)
    rows = ((b["clip_input_ids"].shape[0], 1) if packed
            else b["step_mask"].shape)
    return gumbel_noise(rows + (cfg.max_t_len, cfg.extended_vocab_size))


@functools.lru_cache(maxsize=None)
def _jax_all():
    """{(mode, packed): (ModelOutputs, grads or None)} of svpc_tpu, every
    case traced into ONE compiled program (the fixed cost of a compile is
    paid once)."""
    import jax
    import jax.numpy as jnp

    cases = [(m, p) for m in MODES for p in (False, True)]
    params = {f"{m}/{p}": _setup(m, p)[2] for m, p in cases}

    def run(ps):
        out = {}
        for mode, packed in cases:
            _, model, _, _, _ = _setup(mode, packed)
            batch = {k: jnp.asarray(v)
                     for k, v in _batch(mode, packed).items()}

            def loss(p):
                o = model.apply(p, batch, deterministic=False,
                                return_memory=mode in ("full", "reason_copy"),
                                rngs={"gumbel": jax.random.PRNGKey(0)})
                return o.total_loss, o

            with shared_gumbel(_noise(mode, packed)):
                if (mode, packed) in GRAD_CASES:
                    (_, o), g = jax.value_and_grad(loss, has_aux=True)(
                        ps[f"{mode}/{packed}"])
                else:
                    o, g = loss(ps[f"{mode}/{packed}"])[1], None
            out[f"{mode}/{packed}"] = (o, g)
        return out

    res = jax.tree.map(np.asarray, jax_compile(run, params)(params))
    return {(m, p): res[f"{m}/{p}"] for m, p in cases}


def _jax(mode: str, packed: bool):
    return _jax_all()[(mode, packed)]


def _port(mode: str, packed: bool, backward: bool):
    _, _, _, _, model = _setup(mode, packed)
    model.zero_grad(set_to_none=True)
    with shared_gumbel(_noise(mode, packed)):
        out = model(to_port(_batch(mode, packed)), deterministic=False,
                    return_memory=mode in ("full", "reason_copy"),
                    generator=torch.Generator().manual_seed(0))
    if backward:
        out.total_loss.backward()
    return model, out


def test_forward_matches_jax_in_every_mode_and_layout():
    """Every ModelOutputs field (losses, probabilities, the memory dict)
    within 1e-5, in all 4 modes x packed/dense."""
    for mode in MODES:
        for packed in (False, True):
            want = _jax(mode, packed)[0]
            got = _port(mode, packed, backward=False)[1]
            for name in want._fields:
                w, g = getattr(want, name), getattr(got, name)
                assert (w is None) == (g is None), (mode, packed, name)
                if w is None:
                    continue
                pairs = ([(k, w[k], g[k]) for k in w] if name == "memory"
                         else [(name, w, g)])
                assert name != "memory" or set(w) == set(g)
                for key, wv, gv in pairs:
                    np.testing.assert_allclose(
                        gv.detach().numpy(), wv, rtol=1e-5, atol=1e-5,
                        err_msg=f"{mode} packed={packed} {key}")


def test_gradients_match_jax():
    """d total_loss / d parameter for every parameter within 1e-4 of each
    tensor's max |grad| against jax.grad: "full" dense and packed (two
    layers), "video" dense.  Tensors whose gradient is zero (the shift-invariant ones; the
    cross-attention query over video mode's one memory slot) are zero on
    both sides to 1e-7 of the largest gradient."""
    from svpc_torch.model.from_jax import _flatten, build_mapping

    for mode, packed in sorted(GRAD_CASES):
        flat = _flatten(_jax(mode, packed)[1]["params"])
        model, _ = _port(mode, packed, backward=True)
        named = dict(model.named_parameters())
        top = max(float(np.abs(g).max()) for g in flat.values())
        mapping = build_mapping(mode, model.cfg.num_hidden_layers)
        assert model.cfg.num_hidden_layers == (
            2 if (mode, packed) == TWO_LAYERS else 1)
        assert set(t for t, _ in mapping.values()) == set(named)
        for f_key, (t_key, transform) in mapping.items():
            want = flat[f_key].T if transform == "T" else flat[f_key]
            got = named[t_key].grad
            got = np.zeros_like(want) if got is None else got.numpy()
            what = f"{mode} packed={packed} {t_key}"
            scale = float(np.abs(want).max())
            if t_key.endswith(SHIFT_INVARIANT) or scale == 0.0:
                assert scale <= 1e-7 * top, what
                assert np.abs(got).max() <= 1e-7 * top, what
                continue
            err = float(np.abs(got - want).max())
            assert err <= 1e-4 * scale, (what, err, scale)


def test_attention_routes_on_deterministic_alone():
    """A non-deterministic forward never reaches fused_attention, also
    with attention dropout 0 (before, such a forward took the kernel, whose
    CUDA output carries no gradient); a deterministic one does."""
    import svpc_torch.model.layers as layers

    _, _, _, _, model = dropout_free("full")
    assert model.decoder.layer[0].self_attention.dropout_p == 0.0
    batch = to_port(_batch("full", True))

    def refuse(*args, **kwargs):
        raise AssertionError("fused_attention reached")

    saved = layers.fused_attention
    layers.fused_attention = refuse
    try:
        out = model(batch, deterministic=False,
                    generator=torch.Generator().manual_seed(0))
        assert torch.isfinite(out.total_loss)
        with pytest.raises(AssertionError, match="reached"):
            model(batch, deterministic=True,
                  generator=torch.Generator().manual_seed(0))
    finally:
        layers.fused_attention = saved


def test_dropout_comes_from_the_generator():
    """With the default dropout rates, one generator seed gives the same
    masks (the same outputs, Gumbel noise included); another seed gives
    other masks; deterministic=True draws nothing."""
    from svpc_torch.config import tiny_test_config
    from svpc_torch.model import SVPCModel

    cfg = tiny_test_config("full")
    model = SVPCModel(cfg.model, torch.Generator().manual_seed(1))
    batch = to_port(_batch("full", False))
    run = lambda seed, det=False: model(
        batch, deterministic=det, generator=torch.Generator().manual_seed(
            seed)).prediction_scores
    with torch.no_grad():
        a, b, c = run(3), run(3), run(4)
        assert torch.equal(a, b)
        assert not torch.allclose(a, c)
        d, e = run(3, True), run(4, True)
    assert torch.equal(d, e)
    assert not torch.allclose(a, d)
