#!/usr/bin/env python3
"""Where does the visual simulator's gate gradient (``reasoner.W4``) leave
its band at bfloat16?  One backward of svpc_torch and svpc_tpu from the
same weights and batch, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/torch_bf16_w4_probe.py [--seed 0]

The state of ``tools/torch_bf16_train_settle.py``'s step 0 at full width
(its fixture, svpc_tpu's trainer init, the first shuffled batch of 16,
dropout 0, the same Gumbel noise).  svpc_tpu's cotangent of W4's output
(the gate, (B, S, 1)) is read by adding a zero perturbation to that output
(``flax.linen.intercept_methods``), the port's by a tensor hook.  Prints
one JSON line: for the gate's cotangent and for W4's weight and bias
gradients, |port - svpc_tpu| against svpc_tpu's own |bf16 - f32| by L2
norm, and their ratio to the band 2 |bf16 - f32| + 1e-5 sqrt(n) (the rule
of ``update_check``).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def probe(seed: int = 0, batch: int = 16) -> dict:
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    import torch
    from svpc_tpu.config import Config as JaxConfig
    from svpc_tpu.model import SVPCModel as JaxModel
    from svpc_tpu.train.loop import init_model
    from svpc_torch.config import Config
    from svpc_torch.data.pipeline import CaptionDataset
    from svpc_torch.data.synthetic import write_training_fixture
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.from_jax import state_dict_from_jax
    from svpc_torch.model.svpc import to_tensors
    from svpc_torch.train.loop import packing_builder
    from tests.torch_parity import DROPOUT_OFF, shared_gumbel_by_shape

    with tempfile.TemporaryDirectory() as root:
        fx = write_training_fixture(os.path.join(root, "data"), Config(),
                                    n_train=batch * 6, n_val=16, seed=seed)
        paths = {k: fx[k] for k in ("data_dir", "word2idx_path",
                                    "verb2idx_path", "duration_file",
                                    "video_feature_dir")}
        train_kw = dict(batch_size=batch, val_batch_size=batch, n_epoch=2,
                        optimizer_dtype="bfloat16")
        model_kw = dict(DROPOUT_OFF, compute_dtype="bfloat16")
        cfg = Config().replace_data(**paths).replace_train(**train_kw) \
            .replace_model(**model_kw)
        jcfg = JaxConfig().replace_data(**paths).replace_train(**train_kw) \
            .replace_model(**model_kw)
        jcfg32 = jcfg.replace_model(compute_dtype="float32")
        ds = CaptionDataset(cfg, "train", lazy_features=True)
        builder = packing_builder(cfg)
        sample, _ = next(ds.batches(batch, builder=builder))
        params = jax.tree.map(np.asarray, init_model(jcfg32, sample)[1])
        b0, _ = next(ds.batches(batch, shuffle=True, seed=cfg.train.seed,
                                builder=builder))
        B, S = b0["step_mask"].shape

        def jbatch(dt):
            return {k: jnp.asarray(v, dt) if k == "clip_video_feature"
                    else jnp.asarray(v) for k, v in b0.items()}

        got = {}
        with shared_gumbel_by_shape(seed + 7):
            for name, c, dt in (("j16", jcfg, jnp.bfloat16),
                                ("j32", jcfg32, jnp.float32)):
                model = JaxModel(c.model)

                def loss(p, pert, b, model=model):
                    def add_pert(next_fun, args, kwargs, context):
                        y = next_fun(*args, **kwargs)
                        mod = context.module
                        if mod.name == "W4" and context.method_name == \
                                "__call__" and "recipe" not in str(
                                    mod.scope.path):
                            return y + pert.astype(y.dtype)
                        return y

                    with fnn.intercept_methods(add_pert):
                        return model.apply(p, b, False, rngs={
                            "dropout": jax.random.PRNGKey(0),
                            "gumbel": jax.random.PRNGKey(0)}).total_loss

                g = jax.jit(jax.grad(loss, argnums=(0, 1)))(
                    params, jnp.zeros((B, S, 1), jnp.float32), jbatch(dt))
                w4 = g[0]["params"]["reasoner"]["W4"]
                got[name] = {
                    "gate_cotangent": np.asarray(g[1], np.float32),
                    "W4.weight": np.asarray(w4["kernel"], np.float32).T,
                    "W4.bias": np.asarray(w4["bias"], np.float32)}
            port = SVPCModel(cfg.model)
            port.load_state_dict(state_dict_from_jax(params, cfg.model),
                                 strict=True)
            seen = {}

            def keep_cotangent(module, inputs, out):
                out.register_hook(lambda g: seen.__setitem__(
                    "ct", g.float().numpy()))

            port.reasoner.W4.register_forward_hook(keep_cotangent)
            port(to_tensors(b0, torch.device("cpu"), torch.bfloat16),
                 deterministic=False).total_loss.backward()
            w4 = port.reasoner.W4
            got["p16"] = {"gate_cotangent": seen["ct"],
                          "W4.weight": w4.weight.grad.numpy(),
                          "W4.bias": w4.bias.grad.numpy()}
    out = {}
    for key in got["j16"]:
        j16, j32, p16 = (got[k][key] for k in ("j16", "j32", "p16"))
        err, gap = (float(np.linalg.norm(x - j16)) for x in (p16, j32))
        ref = float(np.linalg.norm(j16))
        out[key] = {"port_err_rel": err / ref, "svpc_tpu_gap_rel": gap / ref,
                    "ratio": err / (2.0 * gap + 1e-5 * math.sqrt(j16.size))}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    print(json.dumps(probe(args.seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
