"""Shared set-up for the port's parity tests (tests/test_torch_*.py): the
same seeded numpy inputs and the same weights go through the JAX package
and through svpc_torch, on the CPU in float32."""

import contextlib
import functools

import numpy as np
import torch

# the training parity runs: every dropout rate 0, deterministic=False
DROPOUT_OFF = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                   reasoner_dropout_prob=0.0)


@functools.lru_cache(maxsize=None)
def jax_model(mode: str, seed: int = 0):
    """(cfg, model, params) of the JAX SVPCModel at tiny_test_config.

    The parameter tree's shapes come from ``jax.eval_shape`` of
    ``model.init`` (no compile); the values are numpy draws from ``seed``
    (LN scales 1 + N(0, 0.1), everything else N(0, 0.05)), so every
    parameter, biases included, is exercised by the parity tests."""
    import jax
    import jax.numpy as jnp
    from svpc_tpu.config import tiny_test_config
    from svpc_tpu.data.synthetic import synthetic_batch
    from svpc_tpu.model import SVPCModel

    cfg = tiny_test_config(mode)
    model = SVPCModel(cfg.model)
    batch = {k: jnp.asarray(v)
             for k, v in synthetic_batch(cfg, 2, seed=0).items()}
    rngs = {"params": jax.random.PRNGKey(0),
            "dropout": jax.random.PRNGKey(1),
            "gumbel": jax.random.PRNGKey(2)}
    shapes = jax.eval_shape(
        lambda: model.init(rngs, batch, deterministic=True))
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: (1.0 + 0.1 * rng.randn(*s.shape)
                         if path[-1].key == "scale"
                         else 0.05 * rng.randn(*s.shape)).astype(np.float32),
        shapes)
    return cfg, model, params


@functools.lru_cache(maxsize=None)
def port_model(mode: str, seed: int = 0):
    """(cfg, model) of svpc_torch's SVPCModel carrying the weights of
    ``jax_model(mode, seed)``, loaded with strict=True."""
    from svpc_torch.config import tiny_test_config
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.from_jax import state_dict_from_jax

    _, _, params = jax_model(mode, seed)
    cfg = tiny_test_config(mode)
    model = SVPCModel(cfg.model).eval()
    model.load_state_dict(
        state_dict_from_jax(params, cfg.model), strict=True)
    return cfg, model


def to_port(batch):
    from svpc_torch.model.svpc import to_tensors
    return to_tensors(batch, torch.device("cpu"))


def jax_params(mode: str, *path):
    """The JAX parameter subtree at ``path`` of ``jax_model(mode)``."""
    tree = jax_model(mode)[2]["params"]
    for p in path:
        tree = tree[p]
    return tree


def jax_apply(module, params, *args, method=None):
    """Apply a flax submodule with the given parameter subtree, compiled as
    one program (array arguments traced, the rest static) -> numpy."""
    import jax
    is_array = [isinstance(a, np.ndarray) for a in args]

    def run(p, *arrays):
        it = iter(arrays)
        full = [next(it) if arr else a for a, arr in zip(args, is_array)]
        return module.apply({"params": p}, *full, method=method)

    out = jax.jit(run)(params, *[a for a, arr in zip(args, is_array) if arr])
    return jax.tree.map(np.asarray, out)


def rand(seed: int, *shape) -> np.ndarray:
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def dropout_free(mode: str, seed: int = 0, layers: int = 1):
    """(jax cfg, jax model, params, port cfg, port model) at
    tiny_test_config(mode) with ``layers`` encoder/decoder layers (one by
    default) and every dropout rate 0 on both sides (the training parity
    tests compile JAX gradients, whose trace and compile time grow with
    depth, so all but one case take one layer; the inference parity tests
    hold the two-layer stack).

    The JAX tree is built from the name mapping and the port's parameter
    shapes (no flax init trace), with numpy draws from ``seed`` as in
    ``jax_model``: LN scales 1 + N(0, 0.1), everything else N(0, 0.05)."""
    from svpc_tpu.config import tiny_test_config as jax_tiny_config
    from svpc_tpu.model import SVPCModel as JaxModel
    from svpc_torch.config import tiny_test_config
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.from_jax import build_mapping, state_dict_from_jax

    kw = dict(num_hidden_layers=layers, **DROPOUT_OFF)
    jcfg = jax_tiny_config(mode).replace_model(**kw)
    cfg = tiny_test_config(mode).replace_model(**kw)
    model = SVPCModel(cfg.model)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    rng = np.random.RandomState(seed)
    params = {}
    for f_key, (t_key, transform) in sorted(build_mapping(mode, layers).items()):
        shape = shapes[t_key][::-1] if transform == "T" else shapes[t_key]
        value = (1.0 + 0.1 * rng.randn(*shape) if f_key.endswith("/scale")
                 else 0.05 * rng.randn(*shape)).astype(np.float32)
        *path, leaf = f_key.split("/")
        node = params
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    params = {"params": params}
    model.load_state_dict(state_dict_from_jax(params, cfg.model),
                          strict=True)
    return jcfg, JaxModel(jcfg.model), params, cfg, model


def gumbel_noise(shape, seed: int = 7) -> np.ndarray:
    return np.random.RandomState(seed).gumbel(size=shape).astype(np.float32)


@contextlib.contextmanager
def shared_gumbel(noise=None):
    """Patch both packages' re-simulator samplers to add the same numpy
    ``noise`` (None: no noise) to the logits; the port keeps its own
    straight-through code, the JAX side is svpc_tpu/ops/gumbel.py with the
    draw replaced."""
    import jax
    import jax.numpy as jnp
    import svpc_tpu.model.svpc as jsvpc
    import svpc_torch.model.svpc as psvpc
    from svpc_torch.ops.gumbel import straight_through

    def jax_st(key, logits, tau, axis=-1):
        g = 0.0 if noise is None else jnp.asarray(noise)
        y_soft = jax.nn.softmax((logits.astype(jnp.float32) + g) / tau,
                                axis=axis).astype(logits.dtype)
        index = jnp.argmax(y_soft, axis=axis)
        y_hard = jax.nn.one_hot(index, logits.shape[axis],
                                dtype=logits.dtype, axis=axis)
        return y_hard + y_soft - jax.lax.stop_gradient(y_soft)

    def port_st(logits, tau, generator=None):
        g = (torch.zeros_like(logits) if noise is None
             else torch.from_numpy(noise).to(logits.device))
        return straight_through(logits, g, tau)

    saved = jsvpc.gumbel_softmax_st, psvpc.gumbel_softmax_st
    jsvpc.gumbel_softmax_st, psvpc.gumbel_softmax_st = jax_st, port_st
    try:
        yield
    finally:
        jsvpc.gumbel_softmax_st, psvpc.gumbel_softmax_st = saved


def jax_compile(fn, *args):
    """jax.jit(fn) compiled for arguments shaped like ``args``, with the XLA
    backend at its lowest optimization level (a quarter less compile time
    for these small programs; values agree with the default level to f32
    rounding)."""
    import jax
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0})


# ---------------------------------------------------------------------- #
# bfloat16 compute
# ---------------------------------------------------------------------- #

def bf16_pair(jcfg, cfg, model):
    """(JAX config, port config, port model) at compute_dtype="bfloat16":
    the same architecture and the port model's weights (float32)."""
    from svpc_torch.model import SVPCModel

    jcfg16 = jcfg.replace_model(compute_dtype="bfloat16")
    cfg16 = cfg.replace_model(compute_dtype="bfloat16")
    model16 = SVPCModel(cfg16.model).train(model.training)
    model16.load_state_dict(model.state_dict(), strict=True)
    return jcfg16, cfg16, model16


@functools.lru_cache(maxsize=None)
def bf16_models(mode: str, seed: int = 0):
    """(JAX config, JAX model, params, port config, port model) of
    ``jax_model`` / ``port_model`` at compute_dtype="bfloat16"."""
    from svpc_tpu.model import SVPCModel as JaxModel

    jcfg, _, params = jax_model(mode, seed)
    cfg, model = port_model(mode, seed)
    jcfg16, cfg16, model16 = bf16_pair(jcfg, cfg, model)
    return jcfg16, JaxModel(jcfg16.model), params, cfg16, model16


def f32(x) -> np.ndarray:
    """A port tensor or a JAX / numpy array (bfloat16 included) as a
    float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


def band(jax16, jax32) -> float:
    """The tolerance of every bfloat16 comparison: twice the JAX package's
    own bfloat16 error on the same inputs, max |jax16 - jax32|, plus 1e-5.
    Exact equality is out of reach: XLA keeps float32 between the
    bfloat16 elementwise operations it fuses, torch rounds after each."""
    return 2.0 * float(np.abs(f32(jax16) - f32(jax32)).max()) + 1e-5


def assert_in_band(got16, jax16, jax32, what: str = "") -> float:
    """max |got16 - jax16| <= band(jax16, jax32), the dtypes equal
    (bfloat16 or float32); returns the error."""
    want = np.asarray(jax16)
    assert str(got16.dtype).split(".")[-1] == str(want.dtype), \
        (what, got16.dtype, want.dtype)
    err = float(np.abs(f32(got16) - f32(want)).max())
    tol = band(jax16, jax32)
    assert err <= tol, f"{what}: |port - jax| {err:.3e} > band {tol:.3e}"
    return err
