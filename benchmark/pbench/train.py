"""A training cell: ``train/step.train_step`` on packed batches of the
training fixture, fed as ``train/loop.py::_train_epoch`` feeds it
(``CaptionDataset.batches`` with ``loop.packing_builder(cfg)`` through
``data/prefetch.prefetch_to_device``), epoch after epoch.

Set-up builds the model from the seeded weights and warms every kernel
and the allocator up with a throwaway TrainState (``warmup_steps`` steps
of another shuffle), then puts the weights back and builds the one
TrainState (BertAdam, the EMA shadow) that the window drives from step 0.
The window's first three steps are the ones the reference repeats after
the window: their losses, the optimizer's step-one gradient norms and the
changes of the parameters and the shadow after step three are read on the
device as the window runs, and the videos of each of the three batches
are kept; the reference builds those batches again from the raw files.
Traced runs time ``grad_step`` and ``apply_step`` with CUDA events, the
wait for each batch with the host clock, and profile the window's last
``profile_s`` seconds (the profiler's trace is read after the window).
"""

from __future__ import annotations

import math
import sys
import time
from typing import Dict

import numpy as np

from pbench import flops, peaks
from pbench.fixture import pool_sizes, write_pool
from pbench.host import probe
from pbench.trace import ProfilerSlice, Spans
from pbench.weights import make_weights


def _train_config(ctx, fx):
    from svpc_torch.config import Config, DataConfig, TrainConfig
    t = ctx.traffic
    return Config(
        model=ctx.model_cfg,
        data=DataConfig(data_dir=fx["data_dir"],
                        video_feature_dir=fx["video_feature_dir"],
                        duration_file=fx["duration_file"],
                        word2idx_path=fx["word2idx_path"],
                        verb2idx_path=fx["verb2idx_path"]),
        train=TrainConfig(batch_size=t["batch_videos"],
                          n_epoch=t["n_epoch"],
                          pack_clip_multiple=t["pack_clip_multiple"],
                          pack_v_multiple=t["pack_v_multiple"],
                          seed=int(np.random.SeedSequence(
                              [ctx.seed, 6]).generate_state(1)[0])))


def _install(ctx, spans, events):
    """CUDA events around grad_step and apply_step (traced runs), and the
    planted faults; returns a function that takes them out again."""
    import torch
    import svpc_torch.train.step as step
    saved = [(step, "grad_step", step.grad_step),
             (step, "apply_step", step.apply_step)]
    grad_step, apply_step = step.grad_step, step.apply_step
    if ctx.fault == "half_batch":
        from svpc_torch import tokenization as tok

        def half(state, batch, cfg, generator):
            # the second half of the real clips' labels dropped and the
            # loss doubled: the mean over the rest of the batch
            batch = dict(batch)
            labels = batch["clip_input_labels"].clone()
            real = torch.nonzero(batch["clip_mask"] > 0)[:, 0]
            labels[real[len(real) // 2:]] = tok.IGNORE
            batch["clip_input_labels"] = labels
            out = state.model(batch, deterministic=False,
                              generator=generator)
            out = out._replace(total_loss=2.0 * out.total_loss)
            out.total_loss.backward()
            return step.sum_over_dp(step.batch_metrics(out, batch, cfg),
                                    state.mesh)
        grad_step = half
        step.grad_step = half
    if ctx.fault == "unchanged":
        def unchanged(state, cfg, loss=None):
            for p in state.params.values():
                p.grad = None
            state.step += 1
            return {"grad_norm": torch.zeros(())}
        apply_step = unchanged
        step.apply_step = unchanged
    if ctx.trace:
        def timed(name, fn):
            def wrapped(*args, **kwargs):
                if not spans.on:
                    return fn(*args, **kwargs)
                t0 = time.monotonic()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*args, **kwargs)
                e1.record()
                events[name].append((e0, e1))
                spans.add(name, t0, time.monotonic())
                return out
            return wrapped
        step.grad_step = timed("fwd_bwd", grad_step)
        step.apply_step = timed("optimizer", apply_step)

    def remove():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return remove


def _norms(tensors: Dict, base: Dict, names) -> "torch.Tensor":
    """The norm of each tensor's change from ``base``, stacked on the
    device (no synchronize)."""
    import torch
    return torch.stack([(tensors[n].detach().float() - base[n]).norm()
                        for n in names])


def run(ctx) -> Dict:
    import torch
    from svpc_torch.data.pipeline import CaptionDataset
    from svpc_torch.data.prefetch import prefetch_to_device
    from svpc_torch.model import SVPCModel
    from svpc_torch.train import loop
    from svpc_torch.train.optim import make_optimizer
    from svpc_torch.train.state import TrainState
    import svpc_torch.train.step as step

    c, device, W = ctx.config, ctx.device, ctx.seconds
    fx = write_pool(ctx.workdir, c, ctx.traffic, ctx.seed, annotated=True)
    cfg = _train_config(ctx, fx)
    ctx.mark("pool written")
    ds = CaptionDataset(cfg, "train", lazy_features=True)
    with torch.device(device):  # parameters made on the device
        model = SVPCModel(cfg.model).to(device)
    model.load_state_dict(make_weights(c, ctx.seed, device), strict=True)
    model.train()
    ctx.mark("model made")
    steps_per_epoch = math.ceil(len(ds) / cfg.train.batch_size)
    params = dict(model.named_parameters())
    names = list(params)
    p0 = {n: p.detach().clone() for n, p in params.items()}
    spans, events = Spans(), {"fwd_bwd": [], "optimizer": []}
    remove = _install(ctx, spans, events)

    def new_state():
        return TrainState.create(model, make_optimizer(
            cfg.train, steps_per_epoch, params), use_ema=True)

    def epoch_batches(epoch):
        host = ds.batches(cfg.train.batch_size, shuffle=True,
                          seed=(cfg.train.seed + epoch) % 2 ** 32,
                          builder=loop.packing_builder(cfg))
        return prefetch_to_device(host, device, size=2,
                                  feature_dtype=model.compute_dtype)

    def clips_of(metas):
        return sum(m["n_steps"] for m in metas)

    try:
        # set-up: a throwaway state warms up on another shuffle, then the
        # weights go back and the window's state starts at step 0
        warm = new_state()
        it = epoch_batches(ctx.traffic["n_epoch"])
        for _, (batch, _) in zip(range(ctx.traffic["warmup_steps"]), it):
            step.train_step(warm, batch, cfg)
        it.close()
        del warm, it
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(p0[n])
                p.grad = None
        state = new_state()
        video_flops = {n: flops.train_video_flops(c, *v)
                       for n, v in pool_sizes(c, fx).items()}
        if device.type == "cuda":
            torch.cuda.synchronize()
        ctx.mark("warmed up, the window's train state built")
        probe("before the window")
        # the window; its first three steps read for the check
        first, readings = [], {"losses": []}
        b1 = cfg.train.adam_b1
        t0 = time.monotonic()
        setup_s = t0 - ctx.t_start
        spans.on = ctx.trace
        end = t0 + W
        prof_at = end - min(ctx.traffic["profile_s"], 0.5 * W)
        sl = None
        clips, n_steps, epoch, model_flops = 0, 0, 0, 0
        waits = []
        going = lambda: time.monotonic() < end or n_steps < 3
        while going():
            it = epoch_batches(epoch)
            while going():
                tw = time.monotonic()
                nxt = next(it, None)
                if nxt is None:
                    break
                if spans.on:
                    spans.add("input_wait", tw, time.monotonic())
                waits.append(time.monotonic() - tw)
                batch, metas = nxt
                if ctx.trace and sl is None and time.monotonic() >= prof_at:
                    sl = ProfilerSlice(ctx.workdir)
                    sl.start()
                m = step.train_step(state, batch, cfg)
                if n_steps < 3:
                    first.append([x["name"] for x in metas])
                    readings["losses"].append(
                        torch.as_tensor(m["loss"]).detach().clone())
                if n_steps == 0:
                    readings["grad"] = torch.stack(
                        [state.optimizer.m[n].norm() for n in names]
                    ) / (1 - b1)
                if n_steps == 2:
                    readings["change"] = _norms(params, p0, names)
                    readings["ema"] = _norms(state.ema_shadow, p0, names)
                    p0 = None
                clips += clips_of(metas)
                n_steps += 1
                model_flops += sum(video_flops[x["name"]] for x in metas)
            it.close()
            epoch += 1
        if device.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.monotonic()
        spans.on = False
        if sl is not None:  # the slice ends with the window
            sl.stop()
        probe("after the window")
    finally:
        remove()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    trace = sl.read(spans) if sl is not None else None
    ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in events.items()}
    prog = {"losses": [float(x) for x in readings["losses"]]}
    for k in ("grad", "change", "ema"):
        prog[k] = dict(zip(names, readings[k].tolist()))
    del state, model, params, it, readings, m, batch
    if device.type == "cuda":
        torch.cuda.empty_cache()
    print(f"training window: {n_steps} steps, {clips} clips, "
          f"{epoch} epochs begun", file=sys.stderr)
    record = dict(
        kind="train", window_s=t1 - t0, setup_s=setup_s, attempted=n_steps,
        failed=0, clips_in_window=clips, steps=n_steps,
        model_flops=model_flops,
        matmul_peak=peaks.MATMUL_FLOPS_PER_S[ctx.model_cfg.compute_dtype],
        memory_peak_bytes=peak, fwd_bwd_ms=ms["fwd_bwd"],
        optimizer_ms=ms["optimizer"], input_wait_s=waits, trace=trace)
    from pbench.check import check_training
    t = cfg.train
    record["checks"] = check_training(c, dict(
        seed=t.seed, lr=t.lr, lr_warmup_proportion=t.lr_warmup_proportion,
        t_total=steps_per_epoch * t.n_epoch, adam_b1=t.adam_b1,
        adam_b2=t.adam_b2, adam_eps=t.adam_eps, weight_decay=t.weight_decay,
        grad_clip=t.grad_clip, ema_decay=t.ema_decay,
        batch_size=t.batch_size, clip_multiple=t.pack_clip_multiple,
        v_multiple=t.pack_v_multiple), ctx.seed, fx, first, prog, device)
    return record
