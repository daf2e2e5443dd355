#!/usr/bin/env python3
"""svpc_torch against svpc_tpu at compute_dtype="bfloat16", at the full
width of vivt (ModelConfig defaults), on the CPU.

    JAX_PLATFORMS=cpu python3 tools/torch_bf16_full_width.py [--seed 0]

Draws one set of weights (numpy, from --seed: LayerNorm scales 1, the rest
N(0, 0.02)), loads them into both packages, and runs the deterministic
forward of one packed batch of 2 synthetic videos (svpc_tpu's
``synthetic_batch``) in svpc_tpu at float32 and bfloat16 and in the port
at bfloat16.  Prints one JSON line: every loss of the three runs; for each
probability output, the port's max |bf16 - svpc_tpu bf16| beside the band
(2 max |svpc_tpu bf16 - svpc_tpu f32| + 1e-5); and how many entity
probabilities bfloat16 rounds to exactly 1.0 in each package (a sigmoid
above 1 - 2**-9 does, and the entity loss's binary cross-entropy then
charges its clamp of 100 where the target is 0).

The tests hold the same at tiny width (tests/test_torch_bf16_*.py); this
script shows the full width, where one compile takes seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LOSSES = ("total_loss", "caption_loss", "entity_loss", "action_loss",
          "re_entity_loss", "re_action_loss")
PROBS = ("prediction_scores", "ent_probs", "ac_probs", "re_ent_probs",
         "re_ac_probs")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch
    from svpc_tpu.config import Config as JaxConfig
    from svpc_tpu.data.packing import pack_batch
    from svpc_tpu.data.synthetic import synthetic_batch
    from svpc_tpu.model import SVPCModel as JaxModel
    from svpc_torch.config import Config
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.from_jax import state_dict_from_jax
    from svpc_torch.model.svpc import to_tensors
    from tests.torch_parity import band, f32, shared_gumbel

    jcfg = JaxConfig()
    nb = pack_batch(synthetic_batch(jcfg, 2, seed=1), jcfg.model.max_t_len)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "gumbel": jax.random.PRNGKey(2)}
    shapes = jax.eval_shape(lambda: JaxModel(jcfg.model).init(
        rngs, jb, deterministic=True))
    rng = np.random.RandomState(args.seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, s: (np.ones(s.shape) if path[-1].key == "scale"
                         else 0.02 * rng.randn(*s.shape)).astype(np.float32),
        shapes)

    out = {}
    with shared_gumbel(None):
        for dtype in ("float32", "bfloat16"):
            model = JaxModel(jcfg.replace_model(compute_dtype=dtype).model)
            out[dtype] = jax.jit(lambda p, b: model.apply(
                p, b, True, rngs={"gumbel": jax.random.PRNGKey(0)}))(
                    params, jb)
        cfg = Config().replace_model(compute_dtype="bfloat16")
        port = SVPCModel(cfg.model).eval()
        port.load_state_dict(state_dict_from_jax(params, cfg.model),
                             strict=True)
        with torch.no_grad():
            out["port"] = port(to_tensors(nb, torch.device("cpu"),
                                          torch.bfloat16), deterministic=True)
    print(json.dumps({
        "width": "vivt ModelConfig() defaults", "clips": int(
            nb["clip_mask"].sum()),
        "losses": {run: {k: float(getattr(o, k)) for k in LOSSES}
                   for run, o in (("svpc_tpu_f32", out["float32"]),
                                  ("svpc_tpu_bf16", out["bfloat16"]),
                                  ("port_bf16", out["port"]))},
        "probs": {k: {"port_err": float(np.abs(
            f32(getattr(out["port"], k))
            - f32(getattr(out["bfloat16"], k))).max()),
            "band": band(getattr(out["bfloat16"], k),
                         getattr(out["float32"], k))} for k in PROBS},
        "ent_probs_rounded_to_1": {
            run: int((f32(o.ent_probs) == 1.0).sum())
            for run, o in (("svpc_tpu_f32", out["float32"]),
                           ("svpc_tpu_bf16", out["bfloat16"]),
                           ("port_bf16", out["port"]))},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
