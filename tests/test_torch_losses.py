"""svpc_torch's losses, straight-through Gumbel sampler and masked BiLSTM
against svpc_tpu's, on the same seeded numpy inputs, f32 on the CPU:
values and gradients."""

import numpy as np
import torch

from tests.torch_parity import jax_compile, rand

torch.set_num_threads(1)


def _torch_value_and_grad(fn, *arrays):
    """fn(tensors) -> scalar; returns (value, grads of every array)."""
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    out.backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _close(got, want, rtol, what):
    """|got - want| <= rtol * max|want| (gradient entries near zero are
    held to the tensor's scale)."""
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert np.all(np.isfinite(got)), what
    assert err <= rtol * scale, (what, err, scale)


def test_losses_match_jax_values_and_gradients():
    """label_smoothing_kl (per-row ext_size, a gold label in the last actual
    column, IGNORE rows), bce_sum and asymmetric_loss_sum (with and without
    row_mask, BCE with a mask), including probabilities at exactly 0 and 1:
    values and gradients within 1e-6 relative, all finite."""
    import jax
    from svpc_tpu.ops import losses as jl
    from svpc_torch.ops import losses as pl

    rng = np.random.RandomState(0)
    n, c = 12, 20
    ext = rng.randint(10, c + 1, size=n).astype(np.int32)
    logits = rng.randn(n, c).astype(np.float32)
    probs = np.exp(logits) * (np.arange(c)[None] < ext[:, None])
    probs = (probs / probs.sum(-1, keepdims=True)).astype(np.float32)
    labels = rng.randint(0, 10, size=n).astype(np.int32)
    labels[0] = ext[0] - 1           # gold in the last actual column
    labels[1] = labels[5] = -1       # IGNORE rows
    p = (1.0 / (1.0 + np.exp(-3 * rand(1, 3, 5, 16)))).astype(np.float32)
    p.reshape(-1)[:6] = [0.0, 1.0, 0.0, 1.0, 0.05, 0.95]
    t = (rng.rand(3, 5, 16) < 0.3).astype(np.float32)
    t.reshape(-1)[:4] = [0.0, 1.0, 1.0, 0.0]
    row = (rng.rand(3, 5) < 0.7).astype(np.float32)
    mask = (rng.rand(3, 5, 16) < 0.8).astype(np.float32)
    tt = lambda a: torch.from_numpy(a)
    cases = {  # name: (input, JAX loss, port loss)
        "ls 0.1": (probs, lambda x: jl.label_smoothing_kl(x, labels, ext,
                                                          0.1),
                   lambda x: pl.label_smoothing_kl(x, tt(labels).long(),
                                                   tt(ext).long(), 0.1)),
        "ls 0.4": (probs, lambda x: jl.label_smoothing_kl(x, labels, ext,
                                                          0.4),
                   lambda x: pl.label_smoothing_kl(x, tt(labels).long(),
                                                   tt(ext).long(), 0.4)),
        # a scalar ext_size, as video mode passes it
        "ls scalar ext": (probs,
                          lambda x: jl.label_smoothing_kl(x, labels, c, 0.1),
                          lambda x: pl.label_smoothing_kl(
                              x, tt(labels).long(), c, 0.1)),
        "bce": (p, lambda x: jl.bce_sum(x, t),
                lambda x: pl.bce_sum(x, tt(t))),
        "bce masked": (p, lambda x: jl.bce_sum(x, t, mask),
                       lambda x: pl.bce_sum(x, tt(t), tt(mask))),
        "asl": (p, lambda x: jl.asymmetric_loss_sum(x, t),
                lambda x: pl.asymmetric_loss_sum(x, tt(t))),
        "asl rows": (p, lambda x: jl.asymmetric_loss_sum(x, t, row),
                     lambda x: pl.asymmetric_loss_sum(x, tt(t), tt(row))),
    }
    # every JAX value and gradient from one compiled program
    wants = jax.jit(lambda xs: {k: jax.value_and_grad(f)(xs[k])
                                for k, (_, f, _) in cases.items()})(
        {k: v[0] for k, v in cases.items()})
    for name, (x, _, pf) in cases.items():
        want, wg = wants[name]
        got, (gg,) = _torch_value_and_grad(pf, x)
        _close(got, want, 1e-6, name)
        _close(gg, wg, 1e-6, name + " grad")


def test_gumbel_straight_through_matches_jax():
    """The same noise (JAX's own draw for the key) gives the same one-hot,
    and the straight-through gradient of a weighted sum of the sample
    equals JAX's; the port's own sampler gives one-hots."""
    import jax
    import jax.numpy as jnp
    from svpc_tpu.ops.gumbel import gumbel_softmax_st as jax_st
    from svpc_torch.ops.gumbel import gumbel_softmax_st, straight_through

    key = jax.random.PRNGKey(3)
    logits = rand(1, 4, 6, 30)
    logits[0, 0, 5:] = -1e30          # masked columns, as reconstruct sets
    w = rand(2, 4, 6, 30)
    noise = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
    def weighted(y, tau):
        sample = jax_st(key, y, tau)
        return jnp.sum(sample * w), sample

    wants = jax.jit(lambda x: {tau: jax.value_and_grad(
        weighted, has_aux=True)(x, tau) for tau in (0.5, 1.0)})(logits)
    for tau in (0.5, 1.0):
        (_, want), wg = wants[tau]
        x = torch.tensor(logits, requires_grad=True)
        got = straight_through(x, torch.from_numpy(noise), tau)
        (got * torch.from_numpy(w)).sum().backward()
        np.testing.assert_array_equal(got.detach().numpy().argmax(-1),
                                      np.asarray(want).argmax(-1))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        _close(x.grad.numpy(), wg, 1e-5, f"gumbel grad tau={tau}")
    sample = gumbel_softmax_st(torch.from_numpy(logits), 0.5,
                               torch.Generator().manual_seed(0))
    onehot = torch.nn.functional.one_hot(sample.argmax(-1), 30).float()
    assert torch.allclose(sample, onehot, atol=1e-6)
    assert sample[0, 0, 5:].abs().sum() == 0


def test_bilstm_matches_jax_with_padded_steps():
    """The masked carry-hold BiLSTM on carried weights: padded steps (at
    the end, and interior gaps) leave the carry untouched in both
    directions; outputs and gradients (input and every weight) within
    1e-5."""
    import jax
    import jax.numpy as jnp
    from svpc_tpu.model.lstm import BiLSTM as JaxBiLSTM
    from svpc_torch.model.from_jax import _lstm
    from svpc_torch.model.lstm import BiLSTM

    b, s, d, h = 3, 7, 10, 12
    x = rand(0, b, s, d)
    mask = np.ones((b, s), np.float32)
    mask[0, 4:] = 0.0
    mask[1, 2] = 0.0
    mask[2, :] = 0.0
    w = rand(1, b, s, 2 * h)
    jmod = JaxBiLSTM(h)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              x, mask))["params"]
    rng = np.random.RandomState(2)
    params = {k: (0.3 * rng.randn(*v.shape)).astype(np.float32)
              for k, v in shapes.items()}

    def jloss(p, xx):
        out = jmod.apply({"params": p}, xx, mask)
        return jnp.sum(out * w), out

    (_, out), (jg_p, jg_x) = jax_compile(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True), params, x)(params, x)
    out = np.asarray(out)

    mod = BiLSTM(d, h)
    mapping = _lstm("m", "m")
    mod.load_state_dict({t[2:]: torch.from_numpy(params[f[2:]])
                         for f, (t, _) in mapping.items()}, strict=True)
    xt = torch.tensor(x, requires_grad=True)
    got = mod(xt, torch.from_numpy(mask))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), out, rtol=1e-5,
                               atol=1e-5)
    assert np.all(got.detach().numpy()[2] == 0.0)
    _close(xt.grad.numpy(), jg_x, 1e-5, "d/dx")
    named = dict(mod.named_parameters())
    for f, (t, _) in mapping.items():
        _close(named[t[2:]].grad.numpy(), jg_p[f[2:]], 1e-5, t)
