#!/usr/bin/env python3
"""Drive svpc_torch's serving and training paths on one NVIDIA card and
check them.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line; any failure exits non-zero:

  build    compile the CUDA kernels from svpc_torch/csrc with nvcc (one
           process per source, all started together); nvcc seconds and
           the ptxas register report.
  kernels  each kernel against its plain PyTorch version on the card, at
           the shapes the serving path gives it (f32 max abs error <= 1e-5,
           bf16 <= 2e-2), plus a sequence whose keys are all masked, a long
           key axis (Lq=Lk=300), the widest head the kernel takes (dh=128,
           with a key-padding, a full and a cache mask) and a row on each
           side of the threshold between the kernel's decode and tile
           paths; the path each row took, the kernel's device time
           (CUDA-graph replay) and eager per-call time, the same for the
           plain version and for one library call
           (scaled_dot_product_attention, a yardstick the port never
           calls), and the bound: the larger of bytes / 3.35 TB/s and
           operations / the fastest rate of their type that keeps the
           type's accuracy.
  serve    a full-width vivt model (random weights from --seed) saved as a
           reference .chkpt, served by svpc_torch.cli.serve with
           batch_videos=8, max_clips=12; ~12 concurrent POST /v1/captions,
           then GET /v1/stats.  Every request must get one sentence per
           clip, some batch must hold several videos, and the attention
           kernel must launch >= 88 times per decoded batch, through both
           of its paths.
  parity   one served batch decoded again on the CPU (the plain path):
           first-position probabilities within 1e-4, token agreement.
  train    svpc_torch.train.loop.train on the card at full vivt width
           (random init from --seed) on a training fixture (96 train, 16
           val videos): batch 16, 2 epochs x 6 steps, checkpoint_every_steps
           3.  Every step's loss must be finite; the attention kernel must
           launch through both paths during validation (the teacher-forced
           eval step and the greedy decode) and never inside a train step
           (whose attention is the differentiable plain version), and must
           refuse inputs that want a gradient.  A run killed 3 steps into
           epoch 1 and resumed from its mid-epoch checkpoint must repeat the
           uninterrupted run's last 3 losses within 1e-5 relative.  One
           train step (dropout 0, the same Gumbel noise) on the card and on
           the CPU from the same weights and batch: caption, entity and
           action losses and the gradient norm within 1e-4 relative, the
           re-simulation losses too unless a Gumbel argmax flipped (flips
           are counted).  One validation batch as the trainer builds it,
           on the EMA weights: the teacher-forced eval forward on the card
           and on the CPU (losses within 1e-4 relative, probabilities within
           1e-4), and every form of attention call that it and the greedy
           decode make on the card recorded and held against
           attention_plain on the recorded inputs (f32 1e-5), timed beside
           plain, SDPA and the bound.  Prints ms per step split into
           forward, backward and optimizer (CUDA events), the step without
           the nonfinite guard's wait, clips/s, peak device memory, the
           kernel's launches by path, a torch.profiler window of train
           steps (device-busy time, idle share, top kernels), the parameter
           count, and whether one step's gradients repeat bit for bit.

The line before the last is {"kernels": [...]}, preceded by the card's
name and power limit as nvidia-smi reports them; the last line is
{"ok": true, "device": {...}}.  Without a CUDA card it prints no result
and exits 2.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
# the fastest rate at which the card keeps each type's accuracy, so that
# no implementation can beat the bound: f32 as 3xTF32 on the tensor cores
# (three TF32 products a product, 495 / 3 TFLOP/s), above the 67 TFLOP/s
# of the f32 CUDA cores; bf16 on the tensor cores, dense
ACCURATE_PEAK_OPS_PER_S = {torch.float32: 495e12 / 3,
                           torch.bfloat16: 989e12}
NUM_HEADS, HIDDEN = 12, 768                  # vivt (ModelConfig defaults)

# the serving path's attention calls at batch_videos=8, max_clips=12:
# (name, N, Lq, Lk, mask form, heads, launches per decoded batch)
SERVING_SHAPES = [
    ("clip_encoder", 96, 100, 100, "padding", NUM_HEADS, 2),
    ("step_encoder", 8, 12, 12, "padding", NUM_HEADS, 2),
    ("decoder_self_cached", 96, 1, 22, "cache", NUM_HEADS, 42),
    ("decoder_cross_cached", 96, 1, 3, "ones", NUM_HEADS, 42),
    ("decoder_full_causal", 96, 22, 22, "causal", NUM_HEADS, 0),  # no cache
]
# off the serving path: several ring stages of keys, a sequence that sees
# no key, and the widest head the kernel takes (dh=128: its f32 tile
# blocks hold 64 query rows, its bf16 decode step spans two chunks of
# keys) with each mask form (phase_kernels adds a row on each side of the
# threshold between the kernel's decode and tile paths)
EXTRA_SHAPES = [
    ("long_keys", 8, 300, 300, "padding", NUM_HEADS, 0),
    ("zero_visible_keys", 96, 100, 100, "none_visible", NUM_HEADS, 0),
    ("wide_heads", 96, 100, 100, "padding", HIDDEN // 128, 0),
    ("wide_heads_causal", 96, 100, 100, "causal", HIDDEN // 128, 0),
    ("wide_heads_cached", 96, 1, 22, "cache", HIDDEN // 128, 0),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, msg: str) -> None:
    emit({"phase": phase, "ok": False, "error": msg})
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def call_ms(fn, iters: int) -> float:
    """Mean time of one eager call of ``fn``, host overhead included
    (CUDA events around ``iters`` back-to-back calls, after a warm-up)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Mean device time of one call of ``fn``: ``reps`` calls captured in
    a CUDA graph, replayed ``iters`` times between CUDA events, so no
    host overhead sits between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


# ---------------------------------------------------------------------- #
# build
# ---------------------------------------------------------------------- #

def ptxas_report(log: str) -> dict:
    """{"tile_kernel<float,64>": "96 registers, 0 bytes spill stores, ...",
    ...} from nvcc's -Xptxas -v output."""
    report, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"((?:tile|decode)_kernel)I(f|13__nv_bfloat16)Li(\d+)E",
                      ln)
        if "Compiling entry function" in ln and m:
            dtype = "float" if m.group(2) == "f" else "bf16"
            name = f"{m.group(1)}<{dtype},{m.group(3)}>"
            report[name] = ""
        elif name and ("spill" in ln or "registers" in ln):
            part = ln.split(":", 1)[-1].strip() if "registers" in ln \
                else ln.strip()
            report[name] = (report[name] + ", " + part).strip(", ")
    return report


def phase_build():
    from svpc_torch.ops import _build
    t0 = time.perf_counter()
    _build.build_all()
    report = {name: ptxas_report(log)
              for name, log in _build.build_log.items()}
    emit({"phase": "build", "ok": True,
          "wall_s": time.perf_counter() - t0,
          "nvcc_s": dict(_build.build_seconds), "ptxas": report,
          "card": card_line()})


# ---------------------------------------------------------------------- #
# kernels
# ---------------------------------------------------------------------- #

def _attention_inputs(n, lq, lk, form, dtype, gen):
    dev = "cuda"
    q, k, v = (torch.randn(n, length, HIDDEN, generator=gen)
               .to(dev, dtype) for length in (lq, lk, lk))
    if form == "padding":   # [CLS] frames [SEP] then padding, per sequence
        valid = torch.randint(2, lk + 1, (n, 1), generator=gen)
        mask = (torch.arange(lk)[None] < valid).float()[:, None]
    elif form == "cache":   # positions <= t of the self-attention cache
        mask = (torch.arange(lk) <= lk // 2).float().expand(n, 1, lk)
    elif form == "ones":
        mask = torch.ones(n, 1, lk)
    elif form == "causal":
        text = (torch.arange(lk)[None]
                < torch.randint(2, lk + 1, (n, 1), generator=gen)).float()
        mask = text[:, None, :] * torch.tril(torch.ones(lq, lk))[None]
    elif form == "none_visible":  # sequence 0 sees no key at all
        mask = (torch.rand(n, 1, lk, generator=gen) > 0.3).float()
        mask[0] = 0.0
    else:
        raise ValueError(form)
    return q, k, v, mask.contiguous().to(dev)


def _bound_ms(q, k, v, mask, n, lq, lk):
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, mask, q))
    ops = 4 * n * lq * lk * HIDDEN  # two products a head, 2 ops a MAC
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ACCURATE_PEAK_OPS_PER_S[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), t_bytes


def phase_kernels(seed: int):
    import torch.nn.functional as F
    from svpc_torch.ops.attention import DECODE_MAX_LQ, LAUNCHES, _plan, \
        attention_plain, fused_attention

    cases = SERVING_SHAPES + EXTRA_SHAPES + [
        ("threshold_decode", 96, DECODE_MAX_LQ, 22, "causal", NUM_HEADS, 0),
        ("threshold_tile", 96, DECODE_MAX_LQ + 1, 22, "causal", NUM_HEADS,
         0)]
    gen = torch.Generator().manual_seed(seed)
    rows = []
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for name, n, lq, lk, form, nh, per_batch in cases:
            q, k, v, mask = _attention_inputs(n, lq, lk, form, dtype, gen)
            dh = HIDDEN // nh
            path = _plan(n, lq, nh, dh, dtype).path
            before = LAUNCHES["fused_attention." + path]
            got = fused_attention(q, k, v, mask, nh)
            if LAUNCHES["fused_attention." + path] != before + 1:
                fail("kernels", f"{name}: no launch on the {path} path")
            want = attention_plain(q, k, v, mask, nh)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            # a sequence with every key masked puts all its scores at
            # -1e4 + O(1), where the f32 grid is 2**-10: the two versions
            # round their differently summed dot products onto it
            # independently, so each probability may differ by a factor
            # exp(+-2**-10) and the output by up to 2e-3 * max|v|
            row_tol = (max(tol, 2e-3 * v.float().abs().max().item())
                       if form == "none_visible" else tol)
            row = {"shape": name, "dtype": str(dtype).split(".")[-1],
                   "N": n, "Lq": lq, "Lk": lk, "mask": form, "dh": dh,
                   "path": path,
                   "launches_per_batch": per_batch, "max_abs_err": err,
                   "tol": row_tol}
            if not (math.isfinite(err) and err <= row_tol):
                fail("kernels", f"fused_attention disagrees with "
                                f"attention_plain: {row}")
            if dtype == torch.float32:
                qh, kh, vh = (t.view(n, -1, nh, dh).transpose(1, 2)
                              for t in (q, k, v))
                add = ((1.0 - mask) * -10000.0)[:, None]
                bound, bound_by, bytes_ms = _bound_ms(q, k, v, mask, n, lq,
                                                      lk)
                kern = lambda: fused_attention(q, k, v, mask, nh)
                plain = lambda: attention_plain(q, k, v, mask, nh)
                lib = lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=add)
                row.update(ms=device_ms(kern), plain_ms=device_ms(plain),
                           library_ms=device_ms(lib),
                           call_ms=call_ms(kern, 100),
                           plain_call_ms=call_ms(plain, 100),
                           library_call_ms=call_ms(lib, 100),
                           bound_ms=bound, bound_by=bound_by,
                           bytes_bound_ms=bytes_ms)
            rows.append(row)
    emit({"phase": "kernels", "ok": True, "card": card_line(),
          "rows": rows})
    return rows


def kernel_summary(rows, phase_launches):
    """One entry per kernel: device times per decoded serving batch (each
    f32 serving shape weighted by its launches per batch), the worst f32
    error over every row but the no-visible-key one, and the main paths'
    launch counts (serve + train), in all, by the kernel's path and by
    phase."""
    total = lambda key: sum(l[key] for l in phase_launches.values())
    f32 = [r for r in rows
           if r["dtype"] == "float32" and r["mask"] != "none_visible"]
    per_batch = lambda key: sum(r[key] * r["launches_per_batch"]
                                for r in f32)
    bytes_ms = per_batch("bytes_bound_ms")
    bound = per_batch("bound_ms")
    return [{
        "name": "fused_attention", "route": "cuda",
        "source": "svpc_torch/csrc/fused_attention.cu",
        "replaces": "svpc_tpu/ops/pallas_attention.py:145",
        "launches": total("fused_attention"),
        "launches_by_path": {p: total("fused_attention." + p)
                             for p in ("tile", "decode")},
        "launches_by_phase": {ph: l["fused_attention"]
                              for ph, l in phase_launches.items()},
        "max_abs_err": max(r["max_abs_err"] for r in f32),
        "ms": per_batch("ms"), "plain_ms": per_batch("plain_ms"),
        "bound_ms": bound,
        "bound_by": "bytes" if bytes_ms >= bound else "operations",
        "library_ms": per_batch("library_ms"),
    }]


# ---------------------------------------------------------------------- #
# serve
# ---------------------------------------------------------------------- #

def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def phase_serve(seed: int, workdir: str):
    from svpc_torch.cli.serve import build_service, start_server, stop_server
    from svpc_torch.config import Config
    from svpc_torch.data.synthetic import write_serving_fixture
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.from_jax import save_reference_checkpoint
    from svpc_torch.ops.attention import LAUNCHES, reset_launches

    cfg = Config()  # vivt at its full width (ModelConfig defaults)
    t0 = time.perf_counter()
    fx = write_serving_fixture(workdir, cfg, n_videos=12, min_clips=3,
                               max_clips=12, seed=seed)
    ckpt = os.path.join(workdir, "vivt_random.chkpt")
    save_reference_checkpoint(
        ckpt, SVPCModel(cfg.model, torch.Generator().manual_seed(seed)))
    argv = ["--model_type", "vivt", "--torch_checkpoint",
            "--checkpoint", ckpt,
            "--word2idx_path", fx["word2idx_path"],
            "--verb2idx_path", fx["verb2idx_path"],
            "--video_feature_dir", fx["video_feature_dir"],
            "--duration_file", fx["duration_file"],
            "--batch_videos", "8", "--max_clips", "12"]
    service, _ = build_service(argv)          # loads, warms on the card
    server = start_server(service, "127.0.0.1", 0, max_wait_ms=100.0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    setup_s = time.perf_counter() - t0
    try:
        specs = fx["specs"]
        results, errors = {}, []

        def ask(vid):
            try:
                results[vid] = _post(base + "/v1/captions",
                                     dict(specs[vid], video_id=vid))
            except Exception as e:  # reported below, fails the phase
                errors.append(f"{vid}: {e!r}")

        threads = [threading.Thread(target=ask, args=(v,)) for v in specs]
        torch.cuda.synchronize()
        reset_launches()
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t1
        launches = dict(LAUNCHES)
        stats = _get(base + "/v1/stats")
    finally:
        stop_server(server)
    if errors or any(t.is_alive() for t in threads):
        fail("serve", f"requests failed: {errors}")
    for vid, (code, resp) in results.items():
        caps = resp.get("captions", [])
        if code != 200 or len(caps) != len(specs[vid]["timestamps"]) or \
                not all(isinstance(c.get("sentence"), str) for c in caps):
            fail("serve", f"{vid}: bad response {code} {resp}")
    n_clips = sum(len(s["timestamps"]) for s in specs.values())
    batches = stats["batches"]
    if not batches or stats["videos"] <= batches:
        fail("serve", f"no batch held more than one video: {stats}")
    if launches["fused_attention"] < 88 * batches:
        fail("serve", f"fused_attention launched {launches} times for "
                      f"{batches} batches (< 88 per batch)")
    if not (launches["fused_attention.tile"]
            and launches["fused_attention.decode"]):
        fail("serve", f"a path of fused_attention never launched: "
                      f"{launches}")
    emit({"phase": "serve", "ok": True, "setup_s": setup_s,
          "requests": len(results), "clips": n_clips, "wall_s": wall,
          "clips_per_s": n_clips / wall, "batches": batches,
          "mean_batch_videos": stats["mean_batch_videos"],
          "latency_ms": stats["latency_ms"], "batch_ms": stats["batch_ms"],
          "launches": launches,
          "launches_per_batch": launches["fused_attention"] / batches})
    return service, fx, ckpt, launches


# ---------------------------------------------------------------------- #
# parity
# ---------------------------------------------------------------------- #

def phase_parity(service, fx, ckpt):
    from svpc_torch import tokenization as tok
    from svpc_torch.cli.serve import load_serving_model
    from svpc_torch.decode.greedy import greedy_decode
    from svpc_torch.model.svpc import clip_view, to_tensors

    vids = list(fx["specs"])[:service.batch_videos]
    examples = [service.example_for(service.make_entry(v, fx["specs"][v]))
                for v in vids]
    batch = service.build_batch(examples)
    _, cpu_model = load_serving_model(service.cfg, ckpt)
    cpu_model.eval()

    def first_position(model, dev):
        b = to_tensors(batch, dev)
        with torch.no_grad():
            state = model.encode(b)
            n = b["clip_input_ids"].shape[0]
            caches, enc_kv = model.init_decode_caches((n, 1), state)
            bos = torch.full((n, 1), tok.BOS, dtype=torch.long, device=dev)
            probs, _ = model.score_position_cached(clip_view(b), state, bos,
                                                   0, caches, enc_kv)
        return probs.float().cpu(), greedy_decode(model, b).cpu()

    p_gpu, tok_gpu = first_position(service.model, service.device)
    p_cpu, tok_cpu = first_position(cpu_model, torch.device("cpu"))
    real = torch.from_numpy(batch["clip_mask"]) > 0
    diff = (p_gpu - p_cpu)[real].abs().max().item()
    finite = bool(torch.isfinite(p_gpu).all())
    sums = p_gpu[real].sum(-1)
    step = torch.from_numpy(batch["step_mask"]) > 0
    agree = (tok_gpu == tok_cpu)[step].float().mean().item()
    row = {"phase": "parity", "clips": int(real.sum()),
           "probs_shape": list(p_gpu.shape), "finite": finite,
           "max_abs_diff_probs_t0": diff, "tol": 1e-4,
           "prob_sum_min": sums.min().item(),
           "prob_sum_max": sums.max().item(),
           "token_agreement": agree}
    if not finite or diff > 1e-4 or (sums - 1.0).abs().max() > 1e-3:
        fail("parity", json.dumps(row))
    emit(dict(row, ok=True))


# ---------------------------------------------------------------------- #
# train
# ---------------------------------------------------------------------- #

class _Killed(Exception):
    pass


def _train_cfg(fx):
    """vivt at its full width (ModelConfig defaults) on the fixture."""
    from svpc_torch.config import Config

    return Config().replace_data(**{k: fx[k] for k in (
        "data_dir", "word2idx_path", "verb2idx_path", "duration_file",
        "video_feature_dir")}).replace_train(
        batch_size=16, val_batch_size=16, n_epoch=2,
        checkpoint_every_steps=3)


def _counted_train(loop, cfg, workdir, kill_after=None, resume_from=None):
    """loop.train on the card; returns (result, kernel launches made inside
    train steps).  ``kill_after`` raises _Killed at that train step."""
    from svpc_torch.ops.attention import LAUNCHES

    real, inside = loop.train_step, {"n": 0, "steps": 0}

    def counted(*args, **kwargs):
        if inside["steps"] == kill_after:
            raise _Killed()
        before = LAUNCHES["fused_attention"]
        out = real(*args, **kwargs)
        inside["n"] += LAUNCHES["fused_attention"] - before
        inside["steps"] += 1
        return out

    loop.train_step = counted
    try:
        res = loop.train(cfg, workdir, resume_from=resume_from,
                         device="cuda")
    finally:
        loop.train_step = real
    return res, inside["n"]


def _step_timing(state, batch, cfg, reps=5):
    """ms of forward, backward and optimizer per train step (CUDA events
    around each part; the first of ``reps`` steps is a warm-up), and the
    same steps' whole time without the nonfinite guard, whose check waits
    for the card (``step_ms_unguarded``), the two interleaved."""
    from svpc_torch.train.step import apply_step, step_generator

    cfgs = {True: cfg.replace_train(skip_nonfinite_updates=True),
            False: cfg.replace_train(skip_nonfinite_updates=False)}
    times = {True: [], False: []}
    for i in range(2 * reps):
        guard = i % 2 == 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        gen = step_generator("cuda", cfg.train.seed, 1000 + i)
        ev[0].record()
        out = state.model(batch, deterministic=False, generator=gen)
        ev[1].record()
        out.total_loss.backward()
        ev[2].record()
        apply_step(state, cfgs[guard], loss=out.total_loss)
        ev[3].record()
        torch.cuda.synchronize()
        times[guard].append([ev[j].elapsed_time(ev[j + 1])
                             for j in range(3)])
    mean = lambda ts, j: sum(t[j] for t in ts[1:]) / (reps - 1)
    out = dict(zip(("forward_ms", "backward_ms", "optimizer_ms"),
                   (mean(times[True], j) for j in range(3))))
    out["step_ms_unguarded"] = sum(mean(times[False], j) for j in range(3))
    out["optimizer_ms_unguarded"] = mean(times[False], 2)
    return out


def _repeat_step_bitwise(state, batch, cfg) -> bool:
    """The same step's gradients twice from one state: bitwise equal?"""
    from svpc_torch.train.step import step_generator

    grads = []
    for _ in range(2):
        state.model.zero_grad(set_to_none=True)
        out = state.model(batch, deterministic=False,
                          generator=step_generator("cuda", cfg.train.seed, 0))
        out.total_loss.backward()
        grads.append([p.grad.clone() for p in state.params.values()])
    state.model.zero_grad(set_to_none=True)
    return all(torch.equal(a, b) for a, b in zip(*grads))


def _profile_steps(state, batch, cfg, steps=3):
    """torch.profiler over ``steps`` train steps: device-busy ms a step,
    the idle share of the wall time, and the kernels taking the most
    device time."""
    from torch.profiler import ProfilerActivity, profile
    from svpc_torch.train.step import train_step

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            train_step(state, batch, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "idle_share": 1.0 - busy_ms / wall_ms if kernels else None,
            "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "device_ms_per_step": dev_us(e) / 1e3 / steps}
                            for e in top]}


class _SharedGumbel:
    """Patches the re-simulator's sampler so that the card and the CPU add
    the same Gumbel noise (drawn once on the CPU from ``seed``); ``argmax``
    keeps each device's last sample, to count the flips between them."""

    def __init__(self, seed: int):
        self.seed, self.noise, self.argmax = seed, {}, {}

    def __enter__(self):
        import svpc_torch.model.svpc as svpc
        from svpc_torch.ops.gumbel import gumbel_noise, straight_through

        def shared(logits, tau, generator=None):
            key = tuple(logits.shape)
            if key not in self.noise:
                self.noise[key] = gumbel_noise(
                    logits.shape, torch.Generator().manual_seed(self.seed),
                    "cpu")
            y = straight_through(logits, self.noise[key].to(logits.device),
                                 tau)
            self.argmax[logits.device.type] = y.detach().argmax(-1).cpu()
            return y

        self.real, svpc.gumbel_softmax_st = svpc.gumbel_softmax_st, shared
        return self

    def __exit__(self, *exc):
        import svpc_torch.model.svpc as svpc
        svpc.gumbel_softmax_st = self.real

    def flips(self) -> int:
        return int((self.argmax["cuda"] != self.argmax["cpu"]).sum())


def _rel(res):
    return {k: abs(res["cuda"][k] - res["cpu"][k])
            / max(abs(res["cpu"][k]), 1e-30) for k in res["cpu"]}


def _parity_step(cfg, batch_np, seed):
    """One train step from the same weights and batch on the card and on
    the CPU (dropout 0, the same Gumbel noise): losses, gradient norm and
    the re-simulator's Gumbel argmax flips."""
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.svpc import to_tensors
    from svpc_torch.train.optim import make_optimizer
    from svpc_torch.train.state import TrainState
    from svpc_torch.train.step import apply_step

    cfg = cfg.replace_model(hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0,
                            reasoner_dropout_prob=0.0)
    cpu_model = SVPCModel(cfg.model, torch.Generator().manual_seed(seed))
    models = {"cuda": copy.deepcopy(cpu_model).to("cuda"), "cpu": cpu_model}
    res = {}
    with _SharedGumbel(seed) as gumbel:
        for dev, model in models.items():
            state = TrainState.create(
                model, make_optimizer(cfg.train, 6,
                                      dict(model.named_parameters())),
                use_ema=True)
            out = model(to_tensors(batch_np, torch.device(dev)),
                        deterministic=False)
            out.total_loss.backward()
            m = apply_step(state, cfg, loss=out.total_loss)
            res[dev] = {k: float(getattr(out, k).detach()) for k in (
                "total_loss", "caption_loss", "entity_loss", "action_loss",
                "re_entity_loss", "re_action_loss")}
            res[dev]["grad_norm"] = float(m["grad_norm"])
    return res, _rel(res), gumbel.flips()


def _validation_check(state, cfg, seed):
    """One validation batch as the trainer builds it (the packed budget of
    the whole split, batch 16), on the EMA weights:

    * the teacher-forced eval forward on the card and on the CPU (the same
      Gumbel noise): caption, entity and action losses within 1e-4
      relative, prediction probabilities within 1e-4, Gumbel flips counted;
    * every attention call of that eval forward and of the greedy decode on
      the card, recorded: each distinct form (sequences, query and key
      lengths, mask) held against attention_plain on the recorded inputs
      (f32 1e-5; a row that sees no key, an empty packed slot, 2e-3 *
      max|v|), timed beside plain, SDPA and the bound, with its calls in
      this batch."""
    import torch.nn.functional as F
    import svpc_torch.model.layers as layers
    import svpc_torch.train.loop as loop
    from svpc_torch.data.pipeline import CaptionDataset
    from svpc_torch.decode.greedy import greedy_decode
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.svpc import to_tensors
    from svpc_torch.ops.attention import _plan, attention_plain, \
        fused_attention
    from svpc_torch.train.step import step_generator

    val_ds = CaptionDataset(cfg, "val", lazy_features=True)
    bs = min(cfg.train.val_batch_size, len(val_ds))
    batch_np, _ = next(val_ds.batches(
        bs, builder=loop.eval_packing_builder(cfg, val_ds, bs)))
    weights = state.eval_params()
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = SVPCModel(cfg.model).to(dev).eval()
        models[dev].load_state_dict({n: t.to(dev) for n, t in
                                     weights.items()}, strict=True)

    calls, stage = {}, {"name": None}

    def recording(q, k, v, mask, nh):
        if q.is_cuda:
            key = (stage["name"], q.shape[0], q.shape[1], k.shape[1],
                   tuple(mask.shape[1:]))
            if key not in calls:
                calls[key] = {"inputs": (q, k, v, mask, nh), "calls": 0}
            calls[key]["calls"] += 1
        return fused_attention(q, k, v, mask, nh)

    res, probs = {}, {}
    layers.fused_attention = recording
    try:
        with _SharedGumbel(seed) as gumbel, torch.no_grad():
            for dev, model in models.items():
                stage["name"] = "eval_step"
                out = model(to_tensors(batch_np, torch.device(dev)),
                            deterministic=True,
                            generator=step_generator(dev, 0))
                res[dev] = {k: float(getattr(out, k)) for k in (
                    "total_loss", "caption_loss", "entity_loss",
                    "action_loss", "re_entity_loss", "re_action_loss")}
                probs[dev] = out.prediction_scores.float().cpu()
            stage["name"] = "greedy"
            greedy_decode(models["cuda"],
                          to_tensors(batch_np, torch.device("cuda")))
    finally:
        layers.fused_attention = fused_attention
    rel = _rel(res)
    parity = {"losses": res, "rel": rel, "gumbel_flips": gumbel.flips(),
              "max_abs_diff_probs": (probs["cuda"] - probs["cpu"])
              .abs().max().item(), "tol": 1e-4}
    bad = [k for k in ("caption_loss", "entity_loss", "action_loss")
           if rel[k] > 1e-4]
    if not parity["gumbel_flips"]:
        bad += [k for k in ("re_entity_loss", "re_action_loss")
                if rel[k] > 1e-4]
    if parity["max_abs_diff_probs"] > 1e-4:
        bad.append("prediction_scores")

    rows = []
    for (name, n, lq, lk, mshape), c in sorted(calls.items()):
        q, k, v, mask, nh = c["inputs"]
        dh = q.shape[-1] // nh
        got = fused_attention(q, k, v, mask, nh)
        want = attention_plain(q, k, v, mask, nh)
        sees = mask.expand(n, lq, lk).amax(-1) > 0           # (N, Lq)
        diff = (got.float() - want.float()).abs().amax(-1)
        err = diff[sees].max().item() if sees.any() else 0.0
        blind = diff[~sees].max().item() if (~sees).any() else 0.0
        blind_tol = 2e-3 * v.float().abs().max().item()
        qh, kh, vh = (t.reshape(n, -1, nh, dh).transpose(1, 2)
                      for t in (q, k, v))
        add = ((1.0 - mask) * -10000.0)[:, None]
        bound, bound_by, _ = _bound_ms(q, k, v, mask, n, lq, lk)
        row = {"stage": name, "N": n, "Lq": lq, "Lk": lk,
               "mask": list(mshape), "dh": dh,
               "path": _plan(n, lq, nh, dh, q.dtype).path,
               "calls_in_batch": c["calls"], "max_abs_err": err, "tol": 1e-5,
               "max_abs_err_no_key_rows": blind,
               "no_key_rows": int((~sees).sum()),
               "ms": device_ms(lambda: fused_attention(q, k, v, mask, nh)),
               "plain_ms": device_ms(
                   lambda: attention_plain(q, k, v, mask, nh)),
               "library_ms": device_ms(
                   lambda: F.scaled_dot_product_attention(
                       qh, kh, vh, attn_mask=add)),
               "bound_ms": bound, "bound_by": bound_by}
        rows.append(row)
        if not (math.isfinite(err) and err <= 1e-5 and blind <= blind_tol):
            bad.append(f"kernel at {row}")
    return parity, rows, bad


def phase_train(seed: int, workdir: str):
    import svpc_torch.train.loop as loop
    from svpc_torch.config import Config
    from svpc_torch.data.pipeline import CaptionDataset
    from svpc_torch.data.synthetic import write_training_fixture
    from svpc_torch.model.svpc import to_tensors
    from svpc_torch.ops.attention import LAUNCHES, fused_attention, \
        reset_launches

    t_phase = t0 = time.perf_counter()
    fx = write_training_fixture(os.path.join(workdir, "train_data"), Config(),
                                n_train=96, n_val=16, seed=seed)
    cfg = _train_cfg(fx)
    fixture_s = time.perf_counter() - t0

    # the main path: 2 epochs x 6 steps, launches counted from 0
    torch.cuda.synchronize()
    reset_launches()
    t1 = time.perf_counter()
    res_a, in_steps = _counted_train(loop, cfg, os.path.join(workdir, "a"))
    train_s = time.perf_counter() - t1
    launches = dict(LAUNCHES)
    losses = [s["loss"] for s in res_a["steps"]]
    if len(losses) != 12 or not all(math.isfinite(x) for x in losses):
        fail("train", f"losses {losses}")
    if in_steps:
        fail("train", f"fused_attention launched {in_steps} times inside "
                      "train steps")
    if not (launches["fused_attention.tile"]
            and launches["fused_attention.decode"]):
        fail("train", f"a path of fused_attention did not launch during "
                      f"validation: {launches}")

    # killed 3 steps into epoch 1, resumed from the mid-epoch checkpoint
    wd_b = os.path.join(workdir, "b")
    try:
        _counted_train(loop, cfg, wd_b, kill_after=9)
        fail("train", "the kill did not happen")
    except _Killed:
        pass
    res_b, _ = _counted_train(loop, cfg, wd_b, resume_from=os.path.join(
        wd_b, "checkpoint_last"))
    resumed = [s["loss"] for s in res_b["steps"]]
    resume_rel = [abs(x - y) / abs(y) for x, y in zip(resumed, losses[9:])]
    if [s["step"] for s in res_b["steps"]] != [9, 10, 11] or \
            max(resume_rel) > 1e-5:
        fail("train", f"resumed losses {resumed} != {losses[9:]}")

    # the kernel refuses inputs that want a gradient
    q = torch.randn(4, 8, HIDDEN, device="cuda", requires_grad=True)
    try:
        fused_attention(q, q.detach(), q.detach(),
                        torch.ones(4, 1, 8, device="cuda"), NUM_HEADS)
        fail("train", "fused_attention accepted a grad-requiring input")
    except RuntimeError as e:
        if "gradient" not in str(e):
            raise

    # step timing, memory and a profiler window on the trained state
    state = res_a["state"]
    batch_np, _ = next(CaptionDataset(cfg, "train", lazy_features=True)
                       .batches(16, shuffle=True, seed=cfg.train.seed,
                                builder=loop.packing_builder(cfg)))
    batch = to_tensors(batch_np, torch.device("cuda"))
    clips = int(batch_np["clip_mask"].sum())
    torch.cuda.reset_peak_memory_stats()
    timing = _step_timing(state, batch, cfg)
    peak = torch.cuda.max_memory_allocated()
    step_ms = sum(timing[k] for k in ("forward_ms", "backward_ms",
                                      "optimizer_ms"))
    profile = _profile_steps(state, batch, cfg)
    bitwise = _repeat_step_bitwise(state, batch, cfg)

    parity, rel, flips = _parity_step(cfg, batch_np, seed)
    bad = [k for k in ("caption_loss", "entity_loss", "action_loss",
                       "grad_norm") if rel[k] > 1e-4]
    if not flips:
        bad += [k for k in ("re_entity_loss", "re_action_loss")
                if rel[k] > 1e-4]
    val_parity, val_rows, val_bad = _validation_check(state, cfg, seed)
    bad += [f"validation: {b}" for b in val_bad]
    row = {"phase": "train", "phase_s": time.perf_counter() - t_phase,
           "fixture_s": fixture_s, "train_s": train_s,
           "losses": losses, "resumed_losses": resumed,
           "resume_max_rel": max(resume_rel),
           "launches": launches, "launches_in_train_steps": in_steps,
           "batch_clips": clips, "packed_clips": len(batch_np["clip_mask"]),
           "v_len": int(batch_np["clip_input_ids"].shape[1]
                        - cfg.model.max_t_len),
           "step_ms": step_ms, **timing,
           "clips_per_s": clips / step_ms * 1e3,
           "max_memory_allocated": peak, "profile": profile,
           "parameters": sum(p.numel() for p in state.params.values()),
           "repeat_step_bitwise": bitwise,
           "parity": parity, "parity_rel": rel, "gumbel_flips": flips,
           "validation_parity": val_parity, "validation_kernel": val_rows,
           "card": card_line()}
    if bad:
        fail("train", f"card and CPU disagree on {bad}: {json.dumps(row)}")
    emit(dict(row, ok=True))
    return launches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import svpc_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    rows = phase_kernels(args.seed)
    # the fixture and checkpoint live in the checkout's build/ (ignored)
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=build) \
            as workdir:
        service, fx, ckpt, launches = phase_serve(args.seed, workdir)
        phase_parity(service, fx, ckpt)
        train_launches = phase_train(args.seed, workdir)
    print(card_line(), flush=True)
    emit({"kernels": kernel_summary(rows, {"serve": launches,
                                           "train": train_launches})})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
