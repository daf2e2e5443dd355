"""SVPC (awkrail/svpc, ACM MM 2021), the port's ``SVPCModel`` in any of its
four modes: the architecture of every configuration file that names none.

Serving builds ``svpc_torch.serving.CaptionService`` over an ``SVPCModel``
made on the device from the seed's weights (pbench/weights.py); its
wrappers record the served tokens where they meet the requests
(``batch_to_sentences``, which turns each decoded batch into the
replies), plant the token fault, and in traced runs add host spans around
the batch build, the host-to-device copy and the decode and record each
``fused_attention`` call's shapes for the kernel's roofline.  A served
video's operations are ``flops.serve_video_flops``; the check is
``check.check_serving`` against the plain reference (pbench/reference).
Training is pbench/train.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from pbench import flops, train
from pbench.serve import Hooks


def model_config(c: Dict, control: Optional[str]):
    from svpc_torch.config import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{k: v for k, v in c.items() if k in names})
    if control == "bf16":
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    cfg.validate()  # the program's own check (model_mode among its modes)
    return cfg


def tiny(c: Dict) -> Dict:
    """``c`` at ``tiny_test_config``'s widths in its own mode."""
    from svpc_torch.config import tiny_test_config
    return dict(c, **dataclasses.asdict(tiny_test_config(c["model_mode"])
                                        .model))


def build(ctx, fx):
    import torch
    import svpc_torch.serving as serving
    from svpc_torch.config import Config, DataConfig
    from svpc_torch.model import SVPCModel
    from pbench.weights import make_weights

    c, traffic, seed, device = ctx.config, ctx.traffic, ctx.seed, ctx.device
    cfg = Config(model=ctx.model_cfg, data=DataConfig(
        video_feature_dir=fx["video_feature_dir"],
        duration_file=fx["duration_file"],
        word2idx_path=fx["word2idx_path"],
        verb2idx_path=fx["verb2idx_path"]))
    with torch.device(device):  # parameters made on the device
        model = SVPCModel(cfg.model).to(device)
    model.load_state_dict(make_weights(c, seed, device), strict=True)
    return serving.CaptionService(cfg, model, device=device,
                                  batch_videos=traffic["batch_videos"],
                                  max_clips=traffic["max_clips"])


def install(ctx, svc, served, rec, spans, calls):
    """The benchmark's wrappers around the program's calls; returns a
    function that takes them out again."""
    import torch
    import svpc_torch.model.layers as layers
    import svpc_torch.serving as serving
    saved = [(serving, "batch_to_sentences", serving.batch_to_sentences),
             (serving, "greedy_decode", serving.greedy_decode),
             (serving, "to_tensors", serving.to_tensors),
             (layers, "fused_attention", layers.fused_attention)]
    b2s, greedy = serving.batch_to_sentences, serving.greedy_decode

    def batch_to_sentences(out, metas, vocab):
        if rec["on"]:
            served.extend((m["name"], np.array(out[i, :m["n_steps"]]))
                          for i, m in enumerate(metas))
        return b2s(out, metas, vocab)

    serving.batch_to_sentences = batch_to_sentences
    if ctx.fault == "token":  # a planted fault: one token of each request
        def altered(model, batch):
            out = greedy(model, batch)
            out[:, 0, 1] = torch.where(out[:, 0, 1] == 7, 8, 7)
            return out
        serving.greedy_decode = altered
    if ctx.trace:
        sync = torch.cuda.synchronize
        svc.build_batch = spans.wrap("build", svc.build_batch)
        serving.to_tensors = spans.wrap("copy", serving.to_tensors, sync)
        serving.greedy_decode = spans.wrap("decode", serving.greedy_decode,
                                           sync)
        fused = layers.fused_attention

        def fused_attention(q, k, v, mask, num_heads):
            if calls["on"]:
                calls["shapes"].append(
                    (q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                     mask.numel(), q.element_size(), mask.element_size(),
                     "bfloat16" if q.dtype == torch.bfloat16
                     else "float32"))
            return fused(q, k, v, mask, num_heads)

        layers.fused_attention = fused_attention

    def remove():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return remove


def slice_readings(calls) -> Dict:
    return {"attention_bound_s": sum(flops.attention_bound_s(*s)
                                     for s in calls["shapes"])}


def check(ctx, fx, served) -> Dict[str, float]:
    from pbench.check import check_serving
    return check_serving(ctx.config, ctx.seed, fx, served,
                         ctx.traffic["check_requests"], ctx.device)


KINDS = {"serve": Hooks(build=build, install=install,
                       video_flops=flops.serve_video_flops,
                       slice_readings=slice_readings, check=check),
         "train": train.run}
