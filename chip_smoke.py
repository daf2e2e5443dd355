#!/usr/bin/env python3
"""Drive svpc_torch's serving, training and evaluation paths on one NVIDIA
card and check them.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line; any failure exits non-zero:

  build    compile the CUDA kernels from svpc_torch/csrc with nvcc (one
           process per source, all started together); nvcc seconds and
           the ptxas register report.
  kernels  each kernel against its plain PyTorch version on the card, at
           the shapes the serving path gives it (f32 max abs error <= 1e-5,
           bf16 <= 2e-2), plus a sequence whose keys are all masked, a long
           key axis (Lq=Lk=300), the widest head the kernel takes (dh=128,
           with a key-padding, a full and a cache mask), a row on each
           side of the threshold between the kernel's decode and tile
           paths, and the beam decode's cached steps at K=2 (N=192), each
           in float32 and in bfloat16; the path each row took, the
           kernel's device time (CUDA-graph replay) and eager per-call
           time, the same for the plain version and for one library call
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
  serve_bf16, parity_bf16
           the same burst with --compute_dtype bfloat16: only the kernel's
           bfloat16 paths launch (tile and decode); one batch's
           first-position probabilities on the card against the CPU, both
           bfloat16, within the band of the reference side (2 max |bf16 -
           f32| + 1e-5, the CPU's bfloat16 and float32 runs of the same
           weights), and a control (the card's run with one LayerNorm gain
           off by 2^-4 of itself) outside it;
           the feature cast timed on the host (before the copy) and on the
           card, and the decode with and without the weight-cast cache.
  train    svpc_torch.train.loop.train on the card at full vivt width
           (random init from --seed) on a training fixture (96 train, 16
           val, 16 test videos): batch 16, 2 epochs x 6 steps,
           checkpoint_every_steps 3, language eval on (checkpoint_best is
           the epoch of the highest validation CIDEr).  Every step's loss must be finite; the attention kernel must
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
  train_bf16
           cli.train --compute_dtype bfloat16 --optimizer_dtype bfloat16
           on the same fixture, 2 epochs x 6 steps with validation: finite
           losses, only the bfloat16 paths of the kernel (in validation),
           float32 parameters with bfloat16 moments and shadow; the step
           timing, memory and profiler window of the train phase; on a
           4-video validation batch the eval forward's probabilities and
           one train step's gradients (each parameter's in its own band),
           card against CPU in the band, the control outside it.
  train_knobs
           svpc_tpu's one-device training knobs on the train phase's
           fixture at full width, f32: one grad_step with --remat and
           without (dropout on, one generator seed): the same loss, every
           gradient within 1e-6 of its norm, peak memory and ms of each;
           two real groups of --steps_per_dispatch 2 --grad_accum_steps 2
           (a (2, 2) group and the tail's (1, 2)) through multi_train_step
           and through sequential grad_steps / apply_steps: parameters,
           moments, EMA and per-step losses within 1e-6 of each norm; then
           cli.train --steps_per_dispatch 2 --grad_accum_steps 2
           --checkpoint_every_steps 1 --profile_steps 2 for one epoch of 6
           host batches with validation (both kernel paths launch, none
           inside a step; the trace under <workdir>/profile/ holds CUDA
           kernel events; a TensorBoard events file when tensorboard is
           importable), killed in its second call and resumed from its
           mid-epoch checkpoint to the same losses and history.
  evaluate svpc_torch.cli.evaluate on the train phase's checkpoint_best:
           greedy, then --use_beam --beam_size 2 --n_best 2
           --ingredient_f1, on the val and test splits (both kernel paths
           must launch); every metric file holds BLEU@1-4, METEOR with its
           backend label, ROUGE-L, CIDEr, re1-re4 (and ingredient F1), and
           every beam entry two ranked nbest hypotheses; valid.log.csv's
           CIDEr column matches history.json.  One val batch beam-decoded
           on the card and on the CPU: the tokens of real clips equal
           (differing positions printed), rank-0 scores within 1e-4
           relative; every attention form of the card's beam decode held
           against attention_plain (f32 1e-5) and timed; greedy and beam
           ms per batch (CUDA events) and the scorers' host seconds.
  evaluate_bf16
           cli.evaluate --compute_dtype bfloat16 (greedy, val) on the
           train phase's checkpoint and on the bfloat16 run's (which is
           also evaluated at float32): bfloat16 paths only, metrics
           complete, not every sentence of the first run empty; on the
           first checkpoint greedy ms per batch at bfloat16 and float32,
           and the teacher-forced probabilities of the card's greedy
           tokens, card against CPU in the band, the control outside it;
           token agreement reported.
  serve_beam  svpc_torch.cli.serve --use_beam --n_best 2 on the same
           checkpoint, the 16 test videos as concurrent requests: every
           caption carries two ranked nbest entries, /v1/stats names the
           decoder, and the sentences equal cli.caption --use_beam's on
           the same spec.
  native   (after parity) the native C++ feature packer (built with g++
           in the build phase, beside nvcc) against the numpy fill on one
           served batch of the serve fixture (CaptionService.build_batch,
           8 videos): byte-equal batches for the float32 store and for
           its cli.convert_features float16 copy, the pipeline's fill
           counter naming the route; the host batch build timed natively
           and with numpy, 5 alternating runs each.  The serve phases fail
           unless that counter shows every served video filled natively.
  serve_upload
           (after serve_bf16) cli.serve --upload_dir on the serve
           fixture's checkpoint: 12 concurrent CaptionClient requests for
           the disk-staged videos, then 12 uploading the same features
           inline under new ids: equal captions, both kernel paths,
           native fills; client latency p50/p90 and upload MB/s.
  export   cli.export_checkpoint --ema of the train phase's checkpoint to
           a reference .chkpt: cli.caption on it (--torch_checkpoint) and
           on the trainer checkpoint give the same sentences.
  parallel (after train_knobs) the dp x tp mesh of svpc_torch.parallel at
           full vivt width on the train fixture (vocabulary padded to
           952), f32, each part's ranks in processes of
           svpc_torch.parallel.worker with a timeout; two ranks share
           cuda:0 over gloo (NCCL refuses two ranks on one card), so the
           times are one card's, not a scaling figure.  (a) dp2 ZeRO-1:
           two train steps with dropout on against the same steps in this
           process on the same global batches (losses within 1e-5
           relative, parameters and EMA within rtol 2e-4 / atol 1e-5),
           each rank's bytes of m, v and EMA against the prediction (and
           without ZeRO-1) and its peak memory; then train.loop.train for
           3 steps with validation, language eval and checkpoints, whose
           rank-0 checkpoint in a one-process cli.evaluate gives the
           captions the run's validation decoded.  (b) tp2: greedy decode
           of one 16-video val batch, tokens equal to the one-process
           decode; every attention call at 6 heads launches the kernel,
           and each form is held against attention_plain (f32 1e-5) and
           timed.  (c) NCCL at world size 1: the collectives forward and
           backward on the card, and a dp1 x tp1 train step through the
           mesh path equal to the plain step (1e-6 relative).  The
           kernels phase also times the serving shapes at tp=2 (H=384, 6
           heads).
  dump_memories
           cli.dump_memories on the train phase's checkpoint over the val
           split on the card (pickle keys, finite), every attention form
           of that run (encoders, the full causal decoder, at the CLI's
           own batch of 16 videos) held against attention_plain (f32
           1e-5) and timed beside plain, SDPA and the bound; one 4-video
           batch on the card and on the CPU with the same Gumbel noise
           (entity and action probabilities, the re-simulator's too,
           within 1e-4); cli.validate_data clean on the fixture's three
           splits.

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
# the beam decode's cached steps at K=2 on a served batch (N = 96 clip
# slots x 2 beams): (name, N, Lq, Lk, mask form, heads, 0); its launches
# per beam-decoded batch are BEAM_LAUNCHES (the encoders' four tile
# launches are the greedy rows' shapes)
BEAM_SHAPES = [
    ("beam2_self_cached", 192, 1, 22, "cache", NUM_HEADS, 0),
    ("beam2_cross_cached", 192, 1, 3, "ones", NUM_HEADS, 0),
]
BEAM_LAUNCHES = {"beam2_self_cached": 42, "beam2_cross_cached": 42}
# the serving shapes on one rank of a tp=2 mesh: 6 of the 12 heads, H=384
# (dh=64); launches per decoded batch on each rank are TP2_LAUNCHES
TP2_SHAPES = [("tp2_" + name, n, lq, lk, form, NUM_HEADS // 2, 0)
              for name, n, lq, lk, form, _, _ in SERVING_SHAPES[:4]]
TP2_LAUNCHES = {"tp2_" + s[0]: s[6] for s in SERVING_SHAPES[:4]}
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
    """nvcc for every CUDA source and g++ for the native feature packer,
    all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from svpc_torch import native
    from svpc_torch.ops import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        packer = pool.submit(native.get_lib)
        _build.build_all()
        packer.result()
    report = {name: ptxas_report(log)
              for name, log in _build.build_log.items()}
    emit({"phase": "build", "ok": True,
          "wall_s": time.perf_counter() - t0,
          "nvcc_s": dict(_build.build_seconds), "ptxas": report,
          "gxx_packer_s": native.build_seconds,
          "packer": os.path.relpath(native.library_path()),
          "card": card_line()})


# ---------------------------------------------------------------------- #
# kernels
# ---------------------------------------------------------------------- #

def _attention_inputs(n, lq, lk, form, dtype, gen, hidden=HIDDEN):
    dev = "cuda"
    q, k, v = (torch.randn(n, length, hidden, generator=gen)
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
    ops = 4 * n * lq * lk * q.shape[-1]  # two products a head, 2 ops a MAC
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ACCURATE_PEAK_OPS_PER_S[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), t_bytes


def phase_kernels(seed: int):
    import torch.nn.functional as F
    from svpc_torch.ops.attention import DECODE_MAX_LQ, LAUNCHES, _plan, \
        attention_plain, fused_attention

    cases = SERVING_SHAPES + BEAM_SHAPES + TP2_SHAPES + EXTRA_SHAPES + [
        ("threshold_decode", 96, DECODE_MAX_LQ, 22, "causal", NUM_HEADS, 0),
        ("threshold_tile", 96, DECODE_MAX_LQ + 1, 22, "causal", NUM_HEADS,
         0)]
    gen = torch.Generator().manual_seed(seed)
    rows = []
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for name, n, lq, lk, form, nh, per_batch in cases:
            hidden = HIDDEN // 2 if name.startswith("tp2_") else HIDDEN
            q, k, v, mask = _attention_inputs(n, lq, lk, form, dtype, gen,
                                              hidden)
            dh = hidden // nh
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
                   "launches_per_batch": per_batch,
                   "launches_per_beam_batch": BEAM_LAUNCHES.get(name, 0),
                   "launches_per_tp2_batch": TP2_LAUNCHES.get(name, 0),
                   "max_abs_err": err, "tol": row_tol}
            if not (math.isfinite(err) and err <= row_tol):
                fail("kernels", f"fused_attention disagrees with "
                                f"attention_plain: {row}")
            qh, kh, vh = (t.view(n, -1, nh, dh).transpose(1, 2)
                          for t in (q, k, v))
            add = ((1.0 - mask) * -10000.0)[:, None].to(dtype)
            bound, bound_by, bytes_ms = _bound_ms(q, k, v, mask, n, lq, lk)
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


def _per_batch(rows, dtype):
    """Device times of one greedily decoded serving batch in ``dtype``
    (each serving shape weighted by its launches per batch), the same per
    beam-decoded batch at K=2 (``beam2_batch``: the encoders' rows and the
    beam rows), and the worst error over every row but the
    no-visible-key one."""
    rs = [r for r in rows
          if r["dtype"] == dtype and r["mask"] != "none_visible"]
    per_batch = lambda key: sum(r[key] * r["launches_per_batch"]
                                for r in rs)
    bytes_ms = per_batch("bytes_bound_ms")
    bound = per_batch("bound_ms")
    encoders = [r for r in rs if r["shape"] in ("clip_encoder",
                                                 "step_encoder")]
    per_beam = lambda key: sum(
        r[key] * (r["launches_per_beam_batch"] or r["launches_per_batch"])
        for r in rs if r["launches_per_beam_batch"] or r in encoders)
    per_tp2 = lambda key: sum(r[key] * r["launches_per_tp2_batch"]
                              for r in rs)
    tp2_bytes_ms = per_tp2("bytes_bound_ms")
    return {"max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": per_batch("ms"), "plain_ms": per_batch("plain_ms"),
            "bound_ms": bound,
            "bound_by": "bytes" if bytes_ms >= bound else "operations",
            "library_ms": per_batch("library_ms"),
            "beam2_batch": {key: per_beam(key) for key in (
                "ms", "plain_ms", "bound_ms", "library_ms")},
            "tp2_batch_per_rank": dict(
                {key: per_tp2(key) for key in (
                    "ms", "plain_ms", "bound_ms", "library_ms")},
                bound_by=("bytes" if tp2_bytes_ms >= per_tp2("bound_ms")
                          else "operations"),
                max_abs_err=max(r["max_abs_err"] for r in rs
                                if r["launches_per_tp2_batch"]))}


def kernel_summary(rows, phase_launches):
    """One entry per kernel: the float32 serving batch's numbers
    (``_per_batch``) at the top, the bfloat16 batch's under ``bf16``, and
    the main paths' launch counts (every phase), in all, by the kernel's
    path, by path and dtype, and by phase."""
    total = lambda key: sum(l[key] for l in phase_launches.values())
    return [{
        "name": "fused_attention", "route": "cuda",
        "source": "svpc_torch/csrc/fused_attention.cu",
        "replaces": "svpc_tpu/ops/pallas_attention.py:145",
        "launches": total("fused_attention"),
        "launches_by_path": {p: total("fused_attention." + p)
                             for p in ("tile", "decode")},
        "launches_by_path_and_dtype": {
            f"{p}.{d}": total(f"fused_attention.{p}.{d}")
            for p in ("tile", "decode") for d in ("f32", "bf16")},
        "launches_by_phase": {ph: l["fused_attention"]
                              for ph, l in phase_launches.items()},
        **_per_batch(rows, "float32"),
        "bf16": _per_batch(rows, "bfloat16"),
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


def _dtype_check(phase: str, launches, dtype: str) -> None:
    """Both of the kernel's paths launched in ``dtype`` (f32 or bf16) in
    the phase, and none in the other dtype: nothing fell back."""
    other = "f32" if dtype == "bf16" else "bf16"
    if not (launches[f"fused_attention.tile.{dtype}"]
            and launches[f"fused_attention.decode.{dtype}"]) or \
            launches[f"fused_attention.tile.{other}"] or \
            launches[f"fused_attention.decode.{other}"]:
        fail(phase, f"the kernel's {dtype} paths did not both launch, or "
                    f"{other} launched: {launches}")


def phase_serve(seed: int, workdir: str, compute_dtype: str = "float32",
                fx=None, ckpt=None):
    """The greedy burst; ``compute_dtype="bfloat16"`` serves the same
    fixture and checkpoint (``fx``, ``ckpt``) with --compute_dtype
    bfloat16 (phase serve_bf16)."""
    from svpc_torch.cli.serve import build_service, start_server, stop_server
    from svpc_torch.config import Config
    from svpc_torch.data import pipeline
    from svpc_torch.data.synthetic import write_serving_fixture
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.from_jax import save_reference_checkpoint
    from svpc_torch.ops.attention import LAUNCHES, reset_launches

    phase = "serve" if compute_dtype == "float32" else "serve_bf16"
    cfg = Config()  # vivt at its full width (ModelConfig defaults)
    t0 = time.perf_counter()
    if fx is None:
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
            "--batch_videos", "8", "--max_clips", "12",
            "--compute_dtype", compute_dtype]
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
        pipeline.reset_fills()
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t1
        launches = dict(LAUNCHES)
        fills = dict(pipeline.FILLS)
        stats = _get(base + "/v1/stats")
        health = _get(base + "/healthz")
    finally:
        stop_server(server)
    if errors or any(t.is_alive() for t in threads):
        fail(phase, f"requests failed: {errors}")
    # every video's features went through the native packer
    if fills != {"native": len(specs)}:
        fail(phase, f"videos filled by route {fills}, want all "
                    f"{len(specs)} native")
    for vid, (code, resp) in results.items():
        caps = resp.get("captions", [])
        if code != 200 or len(caps) != len(specs[vid]["timestamps"]) or \
                not all(isinstance(c.get("sentence"), str) for c in caps):
            fail(phase, f"{vid}: bad response {code} {resp}")
    n_clips = sum(len(s["timestamps"]) for s in specs.values())
    batches = stats["batches"]
    if not batches or stats["videos"] <= batches:
        fail(phase, f"no batch held more than one video: {stats}")
    if launches["fused_attention"] < 88 * batches:
        fail(phase, f"fused_attention launched {launches} times for "
                    f"{batches} batches (< 88 per batch)")
    _dtype_check(phase, launches,
                 "f32" if compute_dtype == "float32" else "bf16")
    if health.get("compute_dtype") != compute_dtype:
        fail(phase, f"/healthz compute_dtype: {health}")
    emit({"phase": phase, "ok": True, "setup_s": setup_s,
          "requests": len(results), "clips": n_clips, "wall_s": wall,
          "clips_per_s": n_clips / wall, "batches": batches,
          "mean_batch_videos": stats["mean_batch_videos"],
          "latency_ms": stats["latency_ms"], "batch_ms": stats["batch_ms"],
          "launches": launches, "feature_fills": fills,
          "launches_per_batch": launches["fused_attention"] / batches})
    return service, fx, ckpt, launches


# ---------------------------------------------------------------------- #
# parity
# ---------------------------------------------------------------------- #

def phase_parity(service, fx, ckpt):
    from svpc_torch import tokenization as tok
    from svpc_torch.cli.common import load_reference_model
    from svpc_torch.decode.greedy import greedy_decode
    from svpc_torch.model.svpc import clip_view, to_tensors

    vids = list(fx["specs"])[:service.batch_videos]
    examples = [service.example_for(service.make_entry(v, fx["specs"][v]))
                for v in vids]
    batch = service.build_batch(examples)
    _, cpu_model = load_reference_model(service.cfg, ckpt)
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


def _band(card16, cpu16, cpu32, mask=None) -> dict:
    """The bfloat16 check of one output: max |card16 - cpu16| against the
    band of the reference side alone, 2 max |cpu16 - cpu32| + 1e-5 (the
    port's own bfloat16 error on the CPU, over ``mask``'s entries)."""
    a, b, c = (t.detach().float().cpu() for t in (card16, cpu16, cpu32))
    if mask is not None:
        a, b, c = a[mask], b[mask], c[mask]
    band = 2.0 * (b - c).abs().max().item() + 1e-5
    err = (a - b).abs().max().item()
    return {"err": err, "band": band, "ok": math.isfinite(err) and err <= band}


def _band_per_tensor(names, card16, cpu16, cpu32) -> dict:
    """``_band`` of each tensor of three lists (a gradient per parameter):
    ok when every tensor is inside its own band; the tensor nearest its
    band is reported."""
    checks = [dict(_band(*t), name=n)
              for n, *t in zip(names, card16, cpu16, cpu32)]
    worst = max(checks, key=lambda c: c["err"] / c["band"])
    return {"tensors": len(checks),
            "outside": sum(not c["ok"] for c in checks),
            "worst": worst, "ok": all(c["ok"] for c in checks)}


# the control of every bfloat16 check: the card's run with this weight (the
# last decoder layer's LayerNorm gain) off by 2^-4 of itself, random signs,
# must come out outside the band
CONTROL_WEIGHT = "decoder.layer.1.output.LayerNorm.weight"


def _perturbed(model):
    """A copy of ``model`` with ``CONTROL_WEIGHT`` perturbed."""
    ctl = copy.deepcopy(model)
    w = ctl.get_parameter(CONTROL_WEIGHT)
    sign = torch.randint(0, 2, w.shape,
                         generator=torch.Generator().manual_seed(0)) * 2 - 1
    with torch.no_grad():
        w.mul_(1.0 + 2.0 ** -4 * sign.to(w.device, w.dtype))
    return ctl


def phase_parity_bf16(service, fx, ckpt):
    """One served batch at bfloat16: the first position's probabilities on
    the card against the CPU's (both bfloat16) within the band of the
    CPU's bfloat16 against its float32 run of the same weights, and the
    control (``_perturbed``) outside it; greedy tokens compared with the
    CPU's bfloat16 and the card's float32 run.  Timed: where the feature
    cast goes (on the card after a float32 copy, as the port does, or on
    the host before the copy, as svpc_tpu does), and the decode with and
    without the eval-mode weight-cast cache."""
    from svpc_torch import tokenization as tok
    from svpc_torch.cli.common import load_reference_model
    from svpc_torch.decode.greedy import greedy_decode
    from svpc_torch.model.svpc import clip_view, to_tensors

    vids = list(fx["specs"])[:service.batch_videos]
    examples = [service.example_for(service.make_entry(v, fx["specs"][v]))
                for v in vids]
    batch = service.build_batch(examples)
    cfg16 = service.cfg
    _, cpu16 = load_reference_model(cfg16, ckpt)
    _, cpu32 = load_reference_model(
        cfg16.replace_model(compute_dtype="float32"), ckpt)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    def first_position(model, dev, fdt, decode=True):
        b = to_tensors(batch, dev, fdt)
        with torch.no_grad():
            state = model.encode(b)
            n = b["clip_input_ids"].shape[0]
            caches, enc_kv = model.init_decode_caches((n, 1), state)
            bos = torch.full((n, 1), tok.BOS, dtype=torch.long, device=dev)
            probs, _ = model.score_position_cached(clip_view(b), state, bos,
                                                   0, caches, enc_kv)
        return probs.cpu(), greedy_decode(model, b).cpu() if decode else None

    p16, t16 = first_position(service.model, cuda, torch.bfloat16)
    _, t32 = first_position(copy.deepcopy(cpu32).to(cuda).eval(), cuda,
                            torch.float32)
    pc, tc = first_position(cpu16.eval(), cpu, torch.bfloat16)
    pc32, _ = first_position(cpu32.eval(), cpu, torch.float32, decode=False)
    pctl, _ = first_position(_perturbed(service.model), cuda,
                             torch.bfloat16, decode=False)
    real = torch.from_numpy(batch["clip_mask"]) > 0
    step = torch.from_numpy(batch["step_mask"]) > 0
    check = _band(p16, pc, pc32, real)
    control = _band(pctl, pc, pc32, real)

    key = "clip_video_feature"
    host_ms, card_ms = [], []
    for _ in range(6):
        t0 = time.perf_counter()
        {k: t.to(cuda) for k, t in to_tensors(batch, cpu,
                                              torch.bfloat16).items()}
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        to_tensors(batch, cuda, torch.bfloat16)
        torch.cuda.synchronize()
        card_ms.append((time.perf_counter() - t0) * 1e3)

    # a Linear casts its weights on every call in training mode, which
    # changes nothing else in a decode (dropout follows ``deterministic``)
    b = to_tensors(batch, cuda, torch.bfloat16)
    decode_ms = {True: [], False: []}
    for cached in (True, False) * 4:
        service.model.train(not cached)
        decode_ms[cached].append(_events_ms(
            lambda: greedy_decode(service.model, b), reps=2))
    service.model.eval()
    row = {"phase": "parity_bf16", "clips": int(real.sum()),
           "probs_t0": check, "control_probs_t0": control,
           "token_agreement_cpu_bf16": (
               t16 == tc)[step].float().mean().item(),
           "token_agreement_card_f32": (t16 == t32)[step].float().mean()
           .item(),
           "feature_bytes": {"bf16": batch[key].size * 2,
                             "f32": batch[key].size * 4},
           "to_device_ms_host_cast": host_ms,
           "to_device_ms_card_cast": card_ms,
           "greedy_ms_cast_cache_on": decode_ms[True],
           "greedy_ms_cast_cache_off": decode_ms[False],
           "card": card_line()}
    if not check["ok"] or control["ok"]:
        fail("parity_bf16", json.dumps(row))
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


def _counted_train(loop, cfg, workdir, kill_after=None, resume_from=None,
                   run=None):
    """loop.train on the card (or ``run()``, which calls it); returns
    (result, kernel launches made inside train steps).  ``kill_after``
    raises _Killed at that train step."""
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
        res = run() if run else loop.train(cfg, workdir,
                                           resume_from=resume_from,
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


class _AttentionRecorder:
    """Patches model/layers.py's ``fused_attention`` so that every call on
    the card is counted by its form (``stage``, sequences, query and key
    lengths, mask shape) and the inputs of each form's first call are
    kept."""

    def __init__(self):
        self.calls, self.stage = {}, None

    def __enter__(self):
        import svpc_torch.model.layers as layers
        from svpc_torch.ops.attention import fused_attention

        def recording(q, k, v, mask, nh):
            if q.is_cuda:
                key = (self.stage, q.shape[0], q.shape[1], k.shape[1],
                       tuple(mask.shape[1:]))
                if key not in self.calls:
                    self.calls[key] = {"inputs": (q, k, v, mask, nh),
                                       "calls": 0}
                self.calls[key]["calls"] += 1
            return fused_attention(q, k, v, mask, nh)

        layers.fused_attention = recording
        return self

    def __exit__(self, *exc):
        import svpc_torch.model.layers as layers
        from svpc_torch.ops.attention import fused_attention
        layers.fused_attention = fused_attention


def _form_rows(calls):
    """Each recorded attention form held against attention_plain on its
    recorded inputs (f32 1e-5; a row that sees no key, an empty packed
    slot, 2e-3 * max|v|) and timed beside plain, SDPA and the bound, with
    its calls in the recorded run.  Returns (rows, failures)."""
    import torch.nn.functional as F
    from svpc_torch.ops.attention import _plan, attention_plain, \
        fused_attention

    rows, bad = [], []
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
    return rows, bad


def _validation_check(state, cfg, seed):
    """One validation batch as the trainer builds it (the packed budget of
    the whole split, batch 16), on the EMA weights:

    * the teacher-forced eval forward on the card and on the CPU (the same
      Gumbel noise): caption, entity and action losses within 1e-4
      relative, prediction probabilities within 1e-4, Gumbel flips counted;
    * every attention call of that eval forward and of the greedy decode on
      the card, recorded and held against attention_plain (``_form_rows``).
    """
    import svpc_torch.train.loop as loop
    from svpc_torch.data.pipeline import CaptionDataset
    from svpc_torch.decode.greedy import greedy_decode
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.svpc import to_tensors
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

    res, probs = {}, {}
    with _AttentionRecorder() as rec, _SharedGumbel(seed) as gumbel, \
            torch.no_grad():
        for dev, model in models.items():
            rec.stage = "eval_step"
            out = model(to_tensors(batch_np, torch.device(dev)),
                        deterministic=True,
                        generator=step_generator(dev, 0))
            res[dev] = {k: float(getattr(out, k)) for k in (
                "total_loss", "caption_loss", "entity_loss",
                "action_loss", "re_entity_loss", "re_action_loss")}
            probs[dev] = out.prediction_scores.float().cpu()
        rec.stage = "greedy"
        greedy_decode(models["cuda"],
                      to_tensors(batch_np, torch.device("cuda")))
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
    rows, kernel_bad = _form_rows(rec.calls)
    return parity, rows, bad + kernel_bad


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
    return launches, fx, cfg, os.path.join(workdir, "a")


def _fixture_argv(fx):
    return ["--model_type", "vivt", "--data_dir", fx["data_dir"],
            "--word2idx_path", fx["word2idx_path"],
            "--verb2idx_path", fx["verb2idx_path"],
            "--video_feature_dir", fx["video_feature_dir"],
            "--duration_file", fx["duration_file"]]


def _bf16_train_parity(cfg16, state, seed):
    """One small validation batch (4 videos) at bfloat16 on the card and
    on the CPU, with the CPU's float32 run of the same weights for the
    band, and the control (``_perturbed``) on the card: the eval forward's
    probabilities on the EMA weights, and one train step's gradients
    (dropout 0, the same Gumbel noise) on the trained parameters, each
    parameter's gradient in its own band.  Returns (checks, the control's
    checks, the eval forward's losses of each run)."""
    import svpc_torch.train.loop as loop
    from svpc_torch.data.pipeline import CaptionDataset
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.svpc import to_tensors

    cfg16 = cfg16.replace_model(hidden_dropout_prob=0.0,
                                attention_probs_dropout_prob=0.0,
                                reasoner_dropout_prob=0.0)
    val_ds = CaptionDataset(cfg16, "val", lazy_features=True)
    batch_np, _ = next(val_ds.batches(
        4, builder=loop.eval_packing_builder(cfg16, val_ds, 4)))
    runs = {"card16": ("cuda", "bfloat16"), "cpu16": ("cpu", "bfloat16"),
            "cpu32": ("cpu", "float32"), "control": ("cuda", "bfloat16")}
    probs, grads, losses = {}, {}, {}
    with _SharedGumbel(seed):
        for name, (dev, dtype) in runs.items():
            model = SVPCModel(cfg16.replace_model(compute_dtype=dtype)
                              .model).to(dev).eval()
            b = to_tensors(batch_np, torch.device(dev), model.compute_dtype)
            model.load_state_dict({n: t.to(dev) for n, t in
                                   state.eval_params().items()})
            if name == "control":
                model = _perturbed(model)
            with torch.no_grad():
                out = model(b, deterministic=True)
            probs[name] = [getattr(out, k).float().cpu() for k in (
                "prediction_scores", "ent_probs", "ac_probs")]
            losses[name] = {k: float(getattr(out, k)) for k in (
                "caption_loss", "entity_loss", "action_loss",
                "re_entity_loss", "re_action_loss")}
            model.load_state_dict({n: t.detach().to(dev) for n, t in
                                   state.params.items()})
            if name == "control":
                model = _perturbed(model)
            model(b, deterministic=False).total_loss.backward()
            grads[name] = [p.grad.float().cpu() for p in model.parameters()]
    names = [n for n, _ in model.named_parameters()]

    def checks(card):
        out = {k: _band(probs[card][i], probs["cpu16"][i], probs["cpu32"][i])
               for i, k in enumerate(("prediction_scores", "ent_probs",
                                      "ac_probs"))}
        out["gradients"] = _band_per_tensor(
            names, *(grads[r] for r in (card, "cpu16", "cpu32")))
        return out

    return checks("card16"), checks("control"), losses


def phase_train_bf16(seed: int, workdir: str, fx):
    """cli.train --compute_dtype bfloat16 --optimizer_dtype bfloat16 on the
    train phase's fixture, 2 epochs x 6 steps with validation and language
    eval: finite losses, the kernel's bfloat16 paths only (validation; none
    inside a train step), float32 parameters with bfloat16 moments and
    shadow; step timing, peak memory and a profiler window as in the train
    phase; the card against the CPU (``_bf16_train_parity``)."""
    import svpc_torch.train.loop as loop
    from svpc_torch.cli import train as train_cli
    from svpc_torch.data.pipeline import CaptionDataset
    from svpc_torch.model.svpc import to_tensors
    from svpc_torch.ops.attention import LAUNCHES, reset_launches

    t_phase = time.perf_counter()
    wd = os.path.join(workdir, "bf16")
    argv = _fixture_argv(fx) + [
        "--batch_size", "16", "--val_batch_size", "16", "--n_epoch", "2",
        "--compute_dtype", "bfloat16", "--optimizer_dtype", "bfloat16",
        "--workdir", wd]
    torch.cuda.synchronize()
    reset_launches()
    t1 = time.perf_counter()
    res, in_steps = _counted_train(loop, None, wd,
                                   run=lambda: train_cli.main(argv))
    train_s = time.perf_counter() - t1
    launches = dict(LAUNCHES)
    losses = [s["loss"] for s in res["steps"]]
    if len(losses) != 12 or not all(math.isfinite(x) for x in losses):
        fail("train_bf16", f"losses {losses}")
    if in_steps:
        fail("train_bf16", f"fused_attention launched {in_steps} times "
                           "inside train steps")
    _dtype_check("train_bf16", launches, "bf16")
    state = res["state"]
    dtypes = {"params": {str(p.dtype) for p in state.params.values()},
              "moments": {str(t.dtype) for t in state.optimizer.m.values()},
              "shadow": {str(t.dtype) for t in state.ema_shadow.values()}}
    if dtypes != {"params": {"torch.float32"},
                  "moments": {"torch.bfloat16"},
                  "shadow": {"torch.bfloat16"}}:
        fail("train_bf16", f"state dtypes {dtypes}")

    cfg16 = _train_cfg(fx).replace_model(compute_dtype="bfloat16") \
        .replace_train(optimizer_dtype="bfloat16")
    batch_np, _ = next(CaptionDataset(cfg16, "train", lazy_features=True)
                       .batches(16, shuffle=True, seed=cfg16.train.seed,
                                builder=loop.packing_builder(cfg16)))
    batch = to_tensors(batch_np, torch.device("cuda"), torch.bfloat16)
    clips = int(batch_np["clip_mask"].sum())
    torch.cuda.reset_peak_memory_stats()
    timing = _step_timing(state, batch, cfg16)
    peak = torch.cuda.max_memory_allocated()
    step_ms = sum(timing[k] for k in ("forward_ms", "backward_ms",
                                      "optimizer_ms"))
    profile = _profile_steps(state, batch, cfg16)
    checks, control, eval_losses = _bf16_train_parity(cfg16, state, seed)
    row = {"phase": "train_bf16", "phase_s": time.perf_counter() - t_phase,
           "train_s": train_s, "losses": losses, "launches": launches,
           "launches_in_train_steps": in_steps, "state_dtypes": {
               k: sorted(v) for k, v in dtypes.items()},
           "history_cider": [h["lang"].get("CIDEr") for h in res["history"]],
           "batch_clips": clips, "packed_clips": len(batch_np["clip_mask"]),
           "step_ms": step_ms, **timing,
           "clips_per_s": clips / step_ms * 1e3,
           "max_memory_allocated": peak, "profile": profile,
           "parity": checks, "control": control,
           "parity_eval_losses": eval_losses, "card": card_line()}
    bad = [k for k, c in checks.items() if not c["ok"]]
    if all(c["ok"] for c in control.values()):
        bad.append("the control (a perturbed weight) passed")
    if bad:
        fail("train_bf16", f"card and CPU disagree on {bad}: "
                           f"{json.dumps(row)}")
    emit(dict(row, ok=True))
    return launches, wd


# ---------------------------------------------------------------------- #
# train_knobs
# ---------------------------------------------------------------------- #

def _norm_rel(a: dict, b: dict) -> float:
    """max over tensors of |a - b| / |b| (L2 norms; 0 where both are 0)."""
    worst = 0.0
    with torch.no_grad():
        for name, t in b.items():
            d = float((a[name].float() - t.float()).norm())
            n = float(t.float().norm())
            worst = max(worst, d / n if n else d)
    return worst


def _remat_check(cfg, batch, seed):
    """One grad_step from one state and one generator seed, the config's
    dropout on, with remat off and on (off, on, off, on): the loss equal,
    every gradient within 1e-6 of its norm; peak memory and step ms
    (CUDA events) of each."""
    import dataclasses
    from svpc_torch.model import SVPCModel
    from svpc_torch.train.optim import make_optimizer
    from svpc_torch.train.state import TrainState
    from svpc_torch.train.step import grad_step, step_generator

    base = SVPCModel(cfg.model, torch.Generator().manual_seed(seed))
    runs = {False: [], True: []}
    for remat in (False, True, False, True):
        model = SVPCModel(dataclasses.replace(cfg.model, remat=remat))
        model.load_state_dict(base.state_dict(), strict=True)
        model = model.cuda()
        state = TrainState.create(model, make_optimizer(
            cfg.train, 6, dict(model.named_parameters())), use_ema=True)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        m = grad_step(state, batch, cfg, step_generator("cuda", seed, 0))
        ev[1].record()
        torch.cuda.synchronize()
        runs[remat].append({
            "loss": float(m["loss"]), "ms": ev[0].elapsed_time(ev[1]),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "resident_bytes": resident,
            "grads": {n: p.grad.cpu() for n, p in state.params.items()}})
        del state, model, m
    off, on = runs[False][-1], runs[True][-1]
    out = {"loss": [off["loss"], on["loss"]],
           "grad_max_rel": _norm_rel(on["grads"], off["grads"])}
    for name, rs in (("off", runs[False]), ("on", runs[True])):
        out[name] = {k: [r[k] for r in rs] for k in (
            "ms", "max_memory_allocated", "resident_bytes")}
    bad = []
    if on["loss"] != off["loss"]:
        bad.append(f"remat loss {on['loss']} != {off['loss']}")
    if out["grad_max_rel"] > 1e-6:
        bad.append(f"remat gradients {out['grad_max_rel']:.3e} of a norm")
    return out, bad


def _multi_step_check(cfg, seed):
    """Two real training groups (K=2, A=2: a (2, 2) group and the tail's
    (1, 2)) through multi_train_step and through the sequential
    grad_steps / apply_steps over the same slices, from one state:
    parameters, moments, EMA and per-step losses within 1e-6 of each
    norm."""
    import svpc_torch.train.loop as loop
    from svpc_torch.data.pipeline import CaptionDataset
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.svpc import to_tensors
    from svpc_torch.train.optim import make_optimizer
    from svpc_torch.train.state import TrainState
    from svpc_torch.train.step import (apply_step, grad_step,
                                       multi_train_step, step_generator)

    cfg = cfg.replace_train(grad_accum_steps=2, steps_per_dispatch=2)
    host = CaptionDataset(cfg, "train", lazy_features=True).batches(
        16, shuffle=True, seed=cfg.train.seed,
        builder=loop.packing_builder(cfg))
    groups = list(loop.group_stack_batches(host, 2, cfg.model.max_t_len,
                                           accum=2))
    shapes = [tuple(g["clip_mask"].shape[:2]) for g, _ in groups]
    base = SVPCModel(cfg.model, torch.Generator().manual_seed(seed))
    states = []
    for _ in range(2):
        model = SVPCModel(cfg.model)
        model.load_state_dict(base.state_dict(), strict=True)
        model = model.cuda()
        states.append(TrainState.create(model, make_optimizer(
            cfg.train, 3, dict(model.named_parameters())), use_ema=True))
    fused, seq = states
    got, want, wall = [], [], {"fused": 0.0, "sequential": 0.0}
    for g, _ in groups:
        g = to_tensors(g, torch.device("cuda"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = multi_train_step(fused, g, cfg)
        got += [float(x) for x in m["loss"]]
        t1 = time.perf_counter()
        for k in range(g["clip_mask"].shape[0]):
            step, loss = seq.step, 0.0
            for i in range(g["clip_mask"].shape[1]):
                loss += float(grad_step(
                    seq, {key: v[k, i] for key, v in g.items()}, cfg,
                    step_generator("cuda", cfg.train.seed, step, i))["loss"])
            apply_step(seq, cfg)
            want.append(loss)
        torch.cuda.synchronize()
        wall["fused"] += t1 - t0
        wall["sequential"] += time.perf_counter() - t1
    rel = {"params": _norm_rel(fused.params, seq.params),
           "m": _norm_rel(fused.optimizer.m, seq.optimizer.m),
           "v": _norm_rel(fused.optimizer.v, seq.optimizer.v),
           "ema": _norm_rel(fused.ema_shadow, seq.ema_shadow),
           "losses": max(abs(a - b) / abs(b) for a, b in zip(got, want))}
    bad = [f"multi_train_step {k} {v:.3e}" for k, v in rel.items()
           if v > 1e-6]
    if shapes != [(2, 2), (1, 2)]:
        bad.append(f"groups {shapes}")
    # host clock around each whole call (the first group's includes the
    # first calls' costs): ms per optimizer step
    return {"groups": shapes, "losses": got, "sequential_losses": want,
            "max_rel": rel, "steps": fused.step,
            "ms_per_step": {k: v * 1e3 / len(got) for k, v in wall.items()}
            }, bad


def _trace_kernels(path: str) -> int:
    """CUDA kernel events in a torch.profiler Chrome trace."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return sum(1 for e in events if e.get("cat") == "kernel")


def phase_train_knobs(seed: int, workdir: str, fx):
    """svpc_tpu's one-device training knobs on the train phase's fixture at
    full vivt width, f32: remat against no remat (``_remat_check``), the
    K-step call against its sequential steps (``_multi_step_check``), then
    the main path, cli.train --steps_per_dispatch 2 --grad_accum_steps 2
    --checkpoint_every_steps 1 --profile_steps 2 for one epoch of 6 host
    batches with validation (both kernel paths must launch, none inside a
    train step; the trace must hold CUDA kernel events), killed in its
    second call and resumed from the mid-epoch checkpoint to the same
    losses and history."""
    import importlib.util

    import svpc_torch.train.loop as loop
    from svpc_torch.cli import train as train_cli
    from svpc_torch.data.pipeline import CaptionDataset
    from svpc_torch.model.svpc import to_tensors
    from svpc_torch.ops.attention import LAUNCHES, reset_launches

    t_phase = time.perf_counter()
    cfg = _train_cfg(fx)
    batch_np, _ = next(CaptionDataset(cfg, "train", lazy_features=True)
                       .batches(16, shuffle=True, seed=cfg.train.seed,
                                builder=loop.packing_builder(cfg)))
    remat, bad = _remat_check(cfg, to_tensors(batch_np, torch.device("cuda")),
                              seed)
    multi, multi_bad = _multi_step_check(cfg, seed)
    bad += multi_bad

    tensorboard = importlib.util.find_spec("tensorboard") is not None
    argv = lambda wd: _fixture_argv(fx) + [
        "--batch_size", "16", "--val_batch_size", "16", "--n_epoch", "1",
        "--steps_per_dispatch", "2", "--grad_accum_steps", "2",
        "--checkpoint_every_steps", "1", "--profile_steps", "2",
        "--workdir", wd]
    real, inside = loop.multi_train_step, {"calls": 0, "launches": 0,
                                           "kill": None}

    def counted(*args, **kwargs):
        if inside["calls"] == inside["kill"]:
            raise _Killed()
        before = LAUNCHES["fused_attention"]
        out = real(*args, **kwargs)
        inside["launches"] += LAUNCHES["fused_attention"] - before
        inside["calls"] += 1
        return out

    wd_a, wd_b = (os.path.join(workdir, "knobs_" + x) for x in "ab")
    loop.multi_train_step = counted
    try:
        torch.cuda.synchronize()
        reset_launches()
        t1 = time.perf_counter()
        res_a = train_cli.main(argv(wd_a))
        train_s = time.perf_counter() - t1
        launches = dict(LAUNCHES)
        calls_a, in_steps = inside["calls"], inside["launches"]
        inside.update(calls=0, kill=1)
        try:
            train_cli.main(argv(wd_b))
            fail("train_knobs", "the kill did not happen")
        except _Killed:
            pass
        inside.update(calls=0, kill=None)
        with open(os.path.join(wd_b, "checkpoint_last.progress.json")) as f:
            progress = json.load(f)
        res_b = train_cli.main(argv(wd_b) + [
            "--resume_from", os.path.join(wd_b, "checkpoint_last")])
    finally:
        loop.multi_train_step = real
    losses = [s["loss"] for s in res_a["steps"]]
    resumed = [s["loss"] for s in res_b["steps"]]
    resume_rel = [abs(x - y) / abs(y) for x, y in zip(resumed, losses[2:])]
    hist = [json.load(open(os.path.join(w, "history.json")))
            for w in (wd_a, wd_b)]
    if len(losses) != 3 or calls_a != 2 or \
            not all(math.isfinite(x) for x in losses):
        bad.append(f"{calls_a} calls, losses {losses}")
    if (progress["epoch"], progress["batches_done"]) != (0, 4) or \
            [s["step"] for s in res_b["steps"]] != [2] or \
            max(resume_rel, default=1.0) > 1e-5:
        bad.append(f"resume from {progress}: {resumed} against {losses}")
    hist_rel = abs(hist[1][0]["train"]["loss_per_word"]
                   - hist[0][0]["train"]["loss_per_word"]) / abs(
        hist[0][0]["train"]["loss_per_word"])
    if len(hist[1]) != 1 or hist_rel > 1e-5:
        bad.append(f"resumed history {hist[1]} against {hist[0]}")
    if in_steps:
        bad.append(f"fused_attention launched {in_steps} times inside "
                   "train steps")
    if not (launches["fused_attention.tile"]
            and launches["fused_attention.decode"]):
        bad.append(f"a path of fused_attention did not launch during "
                   f"validation: {launches}")
    trace = os.path.join(wd_a, "profile", "trace.json")
    trace_kernels = _trace_kernels(trace) if os.path.exists(trace) else 0
    if not trace_kernels:
        bad.append("no CUDA kernel event in the profiler trace")
    events = [f for f in os.listdir(wd_a) if f.startswith("events.")]
    if tensorboard and not events:
        bad.append("tensorboard is installed and wrote no events file")
    row = {"phase": "train_knobs", "phase_s": time.perf_counter() - t_phase,
           "remat": remat, "multi_step": multi, "train_s": train_s,
           "losses": losses, "resumed_losses": resumed,
           "resume_progress": progress, "history_loss_rel": hist_rel,
           "launches": launches, "launches_in_train_steps": in_steps,
           "trace_kernel_events": trace_kernels,
           "tensorboard_importable": tensorboard,
           "tensorboard_events_files": len(events), "card": card_line()}
    if bad:
        fail("train_knobs", f"{bad}: {json.dumps(row)}")
    emit(dict(row, ok=True))
    return launches


# ---------------------------------------------------------------------- #
# evaluate
# ---------------------------------------------------------------------- #

METRIC_KEYS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR",
               "METEOR_backend", "ROUGE_L", "CIDEr", "re1", "re2", "re3",
               "re4")


def _eval_argv(fx, checkpoint):
    return _fixture_argv(fx) + ["--checkpoint", checkpoint]


def _events_ms(fn, reps=3) -> float:
    """Mean ms of ``fn`` between CUDA events, after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _beam_parity(fx, checkpoint):
    """One val batch as cli.evaluate builds it, beam-decoded (K=2,
    n_best=2) on the card and on the CPU from the same eval weights: the
    tokens of real clips (both ranks) and the rank-0 scores; every
    attention form the card's beam decode makes, held against
    attention_plain (``_form_rows``); greedy and beam ms per batch."""
    import svpc_torch.train.loop as loop
    from svpc_torch.cli.common import config_from_args, load_checkpoint_model
    from svpc_torch.cli.evaluate import _parser
    from svpc_torch.data.pipeline import CaptionDataset
    from svpc_torch.decode.beam import beam_decode
    from svpc_torch.decode.greedy import greedy_decode
    from svpc_torch.model.svpc import to_tensors

    args = _parser().parse_args(_eval_argv(fx, checkpoint) + [
        "--output_dir", "unused", "--split", "val"])
    cfg, cpu_model = load_checkpoint_model(config_from_args(args), args)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    ds = CaptionDataset(cfg, "val", lazy_features=True)
    dec = loop.make_eval_decoder(gpu_model, cfg, ds, beam_size=2, n_best=2)
    batch_np, _ = next(ds.batches(dec["cfg"].train.val_batch_size,
                                  builder=dec["builder"]))
    batch = to_tensors(batch_np, torch.device("cuda"))
    with _AttentionRecorder() as rec:
        rec.stage = "beam2"
        tok_gpu, sc_gpu = beam_decode(gpu_model, batch, beam_size=2,
                                      n_best=2)
    tok_cpu, sc_cpu = beam_decode(cpu_model, to_tensors(
        batch_np, torch.device("cpu")), beam_size=2, n_best=2)
    real = torch.from_numpy(batch_np["step_mask"]) > 0          # (B, S)
    tg, tc = tok_gpu.cpu().permute(0, 2, 1, 3)[real], \
        tok_cpu.permute(0, 2, 1, 3)[real]                    # (clips, n, T)
    s0g, s0c = sc_gpu.cpu()[:, 0][real], sc_cpu[:, 0][real]
    rows, bad = _form_rows(rec.calls)
    out = {"clips": int(real.sum()),
           "clip_slots": int(batch_np["clip_mask"].shape[0]),
           "differing_token_positions": int((tg != tc).sum()),
           "rank0_score_max_rel": ((s0g - s0c).abs()
                                   / s0c.abs().clamp_min(1e-30)).max().item(),
           "tol": 1e-4, "beam_kernel": rows,
           "greedy_ms_per_batch": _events_ms(
               lambda: greedy_decode(gpu_model, batch)),
           "beam2_ms_per_batch": _events_ms(
               lambda: beam_decode(gpu_model, batch, beam_size=2,
                                   n_best=2))}
    if out["differing_token_positions"]:
        bad.append("beam tokens differ between the card and the CPU")
    if not out["rank0_score_max_rel"] <= 1e-4:
        bad.append("beam rank-0 scores differ between the card and the CPU")
    return out, bad


def phase_evaluate(fx, train_dir):
    """cli.evaluate on the trainer's checkpoint_best: greedy, then beam
    K=2 n_best=2 with ingredient F1, on the val and test splits (kernel
    launches counted over these four runs); metric files complete;
    valid.log.csv's CIDEr column filled; the beam parity of
    ``_beam_parity``; the scorers' host seconds."""
    from svpc_torch.cli.evaluate import main as evaluate_main
    from svpc_torch.evaluation import evaluate_submission
    from svpc_torch.ops.attention import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    checkpoint = os.path.join(train_dir, "checkpoint_best")
    if not os.path.exists(checkpoint):
        fail("evaluate", f"the trainer wrote no checkpoint_best (no epoch "
                         f"scored a CIDEr above 0): {os.listdir(train_dir)}")
    with open(os.path.join(train_dir, "history.json")) as f:
        history = json.load(f)
    with open(os.path.join(train_dir, "valid.log.csv")) as f:
        header, *lines = f.read().split()
    col = header.split(",").index("CIDEr")
    logged = [float(ln.split(",")[col]) for ln in lines]
    bad = []
    if len(logged) != len(history) or any(
            "CIDEr" not in h["lang"]
            or abs(c - round(100 * h["lang"]["CIDEr"], 2)) > 0.006
            for c, h in zip(logged, history)):
        bad.append(f"valid.log.csv CIDEr {logged} against history "
                   f"{[h['lang'].get('CIDEr') for h in history]}")

    out_dir = os.path.join(train_dir, "eval")
    runs = {}
    torch.cuda.synchronize()
    reset_launches()
    t1 = time.perf_counter()
    for split in ("val", "test"):
        for name, extra in (("greedy", []),
                            ("beam2_n2", ["--use_beam", "--beam_size", "2",
                                          "--n_best", "2",
                                          "--ingredient_f1"])):
            runs[f"{name}_{split}"] = evaluate_main(
                _eval_argv(fx, checkpoint) + [
                    "--split", split, "--val_batch_size", "16",
                    "--output_dir", os.path.join(out_dir, name)] + extra)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t1
    launches = dict(LAUNCHES)
    if not (launches["fused_attention.tile"]
            and launches["fused_attention.decode"]):
        bad.append(f"a path of fused_attention did not launch in "
                   f"cli.evaluate: {launches}")

    metrics = {}
    for key, run in runs.items():
        m = run["metrics"]
        want = METRIC_KEYS + (("ingredient_f1",) if "beam" in key else ())
        missing = [k for k in want if k not in m]
        numbers = [m[k] for k in want if k not in missing
                   and k != "METEOR_backend" and k != "ingredient_f1"]
        if missing or not all(math.isfinite(x) for x in numbers):
            bad.append(f"{key}: metrics missing {missing} or not finite")
        entries = [e for v in run["submission"]["results"].values()
                   for e in v]
        if "beam" in key and not all(
                len(e["nbest"]) == 2
                and e["nbest"][0]["score"] >= e["nbest"][1]["score"]
                for e in entries):
            bad.append(f"{key}: entries without two ranked nbest")
        metrics[key] = {k: m.get(k) for k in want}
        metrics[key]["videos"] = len(run["submission"]["results"])

    # the scorers' host time on one submission (the trainer's per-epoch
    # language eval scores the same way)
    ref = os.path.join(fx["data_dir"], "yc2_split_val_anet_format_para.json")
    t2 = time.perf_counter()
    evaluate_submission(runs["greedy_val"]["submission"], [ref])
    scorers_s = time.perf_counter() - t2

    parity, parity_bad = _beam_parity(fx, checkpoint)
    bad += parity_bad
    row = {"phase": "evaluate", "phase_s": time.perf_counter() - t0,
           "checkpoint_epoch": torch.load(checkpoint, map_location="cpu",
                                          weights_only=True)["epoch"],
           "history_cider": [h["lang"].get("CIDEr") for h in history],
           "valid_log_cider": logged, "evaluate_s": eval_s,
           "launches": launches, "metrics": metrics,
           "scorers_host_s": scorers_s, "beam_parity": parity,
           "card": card_line()}
    if bad:
        fail("evaluate", f"{bad}: {json.dumps(row, default=str)}")
    emit(dict(row, ok=True))
    return launches


def _checkpoint(train_dir):
    """A trainer's checkpoint_best, or checkpoint_last when no epoch scored
    a CIDEr above 0."""
    name = "checkpoint_best"
    if not os.path.exists(os.path.join(train_dir, name)):
        name = "checkpoint_last"
    return os.path.join(train_dir, name)


def _empty(run) -> dict:
    """The empty sentences of a cli.evaluate run's submission."""
    entries = [e for v in run["submission"]["results"].values() for e in v]
    return {"sentences": len(entries),
            "empty": sum(not e["sentence"].strip() for e in entries)}


def phase_evaluate_bf16(fx, train_dir, train_dir16):
    """cli.evaluate --compute_dtype bfloat16 (greedy, val) on the float32
    run's checkpoint (its captions have words) and on the bfloat16 run's:
    the kernel's bfloat16 paths only, every metric present, and not every
    sentence of the float32 run's checkpoint empty; the bfloat16 run's
    checkpoint is also evaluated at float32 (it loads at either dtype).
    On one val batch (16 videos) of the float32 run's checkpoint: greedy ms
    per batch at bfloat16 and at float32 (CUDA events), and the
    teacher-forced probabilities of the card's greedy tokens on the card
    and the CPU (bfloat16) within the band of the CPU's bfloat16 against
    its float32 run, the control (``_perturbed``) outside it; greedy
    tokens compared (at every real position, and at the positions the card
    decides by a top-1 / top-2 margin above the band)."""
    import svpc_torch.train.loop as loop
    from svpc_torch import tokenization as tok
    from svpc_torch.cli.common import config_from_args, load_checkpoint_model
    from svpc_torch.cli.evaluate import _parser
    from svpc_torch.cli.evaluate import main as evaluate_main
    from svpc_torch.data.pipeline import CaptionDataset
    from svpc_torch.decode.greedy import greedy_decode
    from svpc_torch.model.svpc import clip_view, to_tensors
    from svpc_torch.ops.attention import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    checkpoint, checkpoint16 = _checkpoint(train_dir), _checkpoint(
        train_dir16)

    def evaluate(ckpt, dtype, out):
        return evaluate_main(_eval_argv(fx, ckpt) + [
            "--split", "val", "--val_batch_size", "16", "--compute_dtype",
            dtype, "--output_dir", os.path.join(train_dir16, out)])

    torch.cuda.synchronize()
    reset_launches()
    t1 = time.perf_counter()
    run = evaluate(checkpoint, "bfloat16", "eval_f32_trained")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t1
    run16 = evaluate(checkpoint16, "bfloat16", "eval_bf16_trained")
    launches = dict(LAUNCHES)
    _dtype_check("evaluate_bf16", launches, "bf16")
    run16_at32 = evaluate(checkpoint16, "float32", "eval_bf16_trained_f32")
    bad = [f"{k} ({name})" for name, r in (
        ("float32 run's", run), ("bfloat16 run's", run16),
        ("bfloat16 run's at f32", run16_at32))
        for k in METRIC_KEYS if k not in r["metrics"]]
    empty = {"float32_trained_at_bf16": _empty(run),
             "bf16_trained_at_bf16": _empty(run16),
             "bf16_trained_at_f32": _empty(run16_at32)}
    if empty["float32_trained_at_bf16"]["empty"] == \
            empty["float32_trained_at_bf16"]["sentences"]:
        bad.append("every sentence of the float32 run's checkpoint is empty")

    models = {}
    for dtype in ("bfloat16", "float32"):
        args = _parser().parse_args(_eval_argv(fx, checkpoint) + [
            "--output_dir", "unused", "--split", "val",
            "--compute_dtype", dtype])
        cfg, models[dtype] = load_checkpoint_model(config_from_args(args),
                                                   args)
    card = {d: copy.deepcopy(m).to("cuda") for d, m in models.items()}
    ds = CaptionDataset(cfg, "val", lazy_features=True)
    dec = loop.make_eval_decoder(card["bfloat16"], cfg, ds)
    batch_np, _ = next(ds.batches(dec["cfg"].train.val_batch_size,
                                  builder=dec["builder"]))
    batches = {"card16": to_tensors(batch_np, torch.device("cuda"),
                                    torch.bfloat16),
               "card32": to_tensors(batch_np, torch.device("cuda")),
               "cpu16": to_tensors(batch_np, torch.device("cpu"),
                                   torch.bfloat16),
               "cpu32": to_tensors(batch_np, torch.device("cpu"))}
    batches["control"] = batches["card16"]
    runs = {"card16": card["bfloat16"], "card32": card["float32"],
            "cpu16": models["bfloat16"], "cpu32": models["float32"],
            "control": _perturbed(card["bfloat16"])}
    ms = {"card16": [], "card32": []}
    for k in ("card16", "card32") * 3:                    # alternating
        ms[k].append(_events_ms(lambda: greedy_decode(runs[k], batches[k])))
    tokens = {k: greedy_decode(runs[k], batches[k]).cpu()
              for k in ("card16", "cpu16")}
    cv = torch.from_numpy(batch_np["clip_video"]).long()
    cs = torch.from_numpy(batch_np["clip_step"]).long()
    fed = tokens["card16"][cv, cs]                               # (N, T)
    V = cfg.model.vocab_size
    fed = torch.where(fed >= V, torch.full_like(fed, tok.UNK), fed)[:, None]
    probs = {}
    with torch.no_grad():
        for k, model in runs.items():
            if k == "card32":
                continue
            b = batches[k]
            ids = fed.to(b["step_mask"].device)
            probs[k] = model.score_text(
                clip_view(b), model.encode(b), ids,
                torch.ones(ids.shape, device=ids.device)).float().cpu()
    real = torch.from_numpy(batch_np["clip_mask"]) > 0
    check, control = (_band(probs[k], probs["cpu16"], probs["cpu32"], real)
                      for k in ("card16", "control"))
    ext = V + torch.from_numpy(batch_np["oov_count"]).long()[cv]
    cols = torch.arange(probs["card16"].shape[-1])
    ok = (cols[None] < ext[:, None]) & (cols[None] != tok.UNK)
    sel = {k: probs[k].masked_fill(~ok[:, None, None], -1.0)
           for k in ("card16", "cpu16")}
    top2 = sel["card16"].topk(2, dim=-1).values
    decided = ((top2[..., 0] - top2[..., 1]) > check["band"])[real]
    agree = (sel["card16"].argmax(-1) == sel["cpu16"].argmax(-1))[real]
    step = torch.from_numpy(batch_np["step_mask"]) > 0
    row = {"phase": "evaluate_bf16", "phase_s": time.perf_counter() - t0,
           "checkpoints": [os.path.relpath(c, os.path.dirname(train_dir))
                           for c in (checkpoint, checkpoint16)],
           "evaluate_s": eval_s, "launches": launches,
           "metrics": {k: run["metrics"].get(k) for k in METRIC_KEYS},
           "metrics_bf16_trained": {k: run16["metrics"].get(k)
                                    for k in METRIC_KEYS},
           "empty_sentences": empty,
           "greedy_ms_per_batch_bf16": sorted(ms["card16"]),
           "greedy_ms_per_batch_f32": sorted(ms["card32"]),
           "teacher_forced_probs": check, "control": control,
           "decided_positions": int(decided.sum()),
           "argmax_differs_at_decided": int((decided & ~agree).sum()),
           "free_running_token_agreement": (
               tokens["card16"] == tokens["cpu16"])[step].float().mean()
           .item(), "card": card_line()}
    if not check["ok"]:
        bad.append("teacher-forced probabilities")
    if control["ok"]:
        bad.append("the control (a perturbed weight) passed")
    if bad:
        fail("evaluate_bf16", f"{bad}: {json.dumps(row, default=str)}")
    emit(dict(row, ok=True))
    return launches


# ---------------------------------------------------------------------- #
# serve_beam
# ---------------------------------------------------------------------- #

def phase_serve_beam(fx, train_dir):
    """cli.serve --use_beam --n_best 2 on the trainer's checkpoint_best: a
    burst of the test split's videos as concurrent requests; every caption
    carries two ranked nbest entries, and the sentences equal cli.caption
    --use_beam's on the same spec."""
    from svpc_torch.cli import caption
    from svpc_torch.cli.serve import build_service, start_server, stop_server
    from svpc_torch.data.anet import SPLIT_FILES
    from svpc_torch.ops.attention import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    checkpoint = os.path.join(train_dir, "checkpoint_best")
    with open(os.path.join(fx["data_dir"], SPLIT_FILES["test"])) as f:
        specs = {vid: {"timestamps": a["timestamps"],
                       "ingredients": a["ingredients"]}
                 for vid, a in json.load(f).items()}
    spec_path = os.path.join(train_dir, "beam_spec.json")
    with open(spec_path, "w") as f:
        json.dump(specs, f)
    argv = _eval_argv(fx, checkpoint)
    service, _ = build_service(argv + ["--use_beam", "--beam_size", "2",
                                       "--n_best", "2", "--batch_videos",
                                       "8", "--max_clips", "12"])
    server = start_server(service, "127.0.0.1", 0, max_wait_ms=100.0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    setup_s = time.perf_counter() - t0
    results, errors = {}, []

    def ask(vid):
        try:
            results[vid] = _post(base + "/v1/captions",
                                 dict(specs[vid], video_id=vid))
        except Exception as e:  # reported below, fails the phase
            errors.append(f"{vid}: {e!r}")

    try:
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
        fail("serve_beam", f"requests failed: {errors}")
    offline = caption.main(argv + [
        "--input_json", spec_path, "--use_beam", "--beam_size", "2",
        "--val_batch_size", "8",
        "--output", os.path.join(train_dir, "beam_captions.json")])
    bad = []
    for vid, (code, resp) in results.items():
        caps = resp.get("captions", [])
        if code != 200 or len(caps) != len(specs[vid]["timestamps"]) or \
                not all(len(c.get("nbest", [])) == 2
                        and c["nbest"][0]["score"] >= c["nbest"][1]["score"]
                        and c["sentence"] == c["nbest"][0]["sentence"]
                        for c in caps):
            bad.append(f"{vid}: bad response {code} {resp}")
        elif [c["sentence"] for c in caps] != \
                [c["sentence"] for c in offline[vid]]:
            bad.append(f"{vid}: served {[c['sentence'] for c in caps]} != "
                       f"cli.caption {[c['sentence'] for c in offline[vid]]}")
    if stats.get("decoder") != "beam2" or stats.get("n_best") != 2:
        bad.append(f"/v1/stats decoder: {stats}")
    if not launches["fused_attention.decode"]:
        bad.append(f"the decode path did not launch: {launches}")
    n_clips = sum(len(s["timestamps"]) for s in specs.values())
    row = {"phase": "serve_beam", "setup_s": setup_s,
           "requests": len(results), "clips": n_clips, "wall_s": wall,
           "clips_per_s": n_clips / wall, "batches": stats["batches"],
           "mean_batch_videos": stats["mean_batch_videos"],
           "latency_ms": stats["latency_ms"], "batch_ms": stats["batch_ms"],
           "decoder": stats.get("decoder"), "launches": launches,
           "card": card_line()}
    if bad:
        fail("serve_beam", f"{bad[:5]}: {json.dumps(row)}")
    emit(dict(row, ok=True))
    return launches


# ---------------------------------------------------------------------- #
# native packer, uploads, export, dump_memories
# ---------------------------------------------------------------------- #

def _spread(xs) -> dict:
    xs = sorted(xs)
    return {"min": xs[0], "median": xs[len(xs) // 2], "max": xs[-1],
            "all": xs}


def phase_native(service, fx, workdir, reps: int = 5):
    """The native packer against the numpy fill on one served batch of the
    serve fixture (8 videos, ``CaptionService.build_batch``): byte-equal
    batches for the float32 store and for its convert_features float16
    copy, the pipeline's fill counter naming the route, and the host batch
    build timed natively and with numpy, ``reps`` alternating runs each."""
    from svpc_torch import native
    from svpc_torch.cli.convert_features import convert_tree
    from svpc_torch.data import pipeline
    from svpc_torch.data.pipeline import CaptionDataset

    t0 = time.perf_counter()
    f16_dir = os.path.join(workdir, "features_f16")
    n_files = convert_tree(fx["video_feature_dir"], f16_dir)
    convert_s = time.perf_counter() - t0
    entries = [service.make_entry(v, s)
               for v, s in list(fx["specs"].items())[:service.batch_videos]]

    def examples(feat_dir, use_native):
        ds = CaptionDataset(
            service.cfg.replace_data(video_feature_dir=feat_dir), "infer",
            num_steps=service.max_clips, entries=[], lazy_features=True,
            use_native=use_native)
        return [ds.make_example(e) for e in entries]

    sets = {(store, route): examples(d, route == "native")
            for store, d in (("f32", fx["video_feature_dir"]),
                             ("f16", f16_dir))
            for route in ("native", "numpy")}
    bad, fills, batches = [], {}, {}
    for store in ("f32", "f16"):
        got = batches[store] = {}
        for route in ("native", "numpy"):
            pipeline.reset_fills()
            got[route] = service.build_batch(sets[store, route])
            fills[f"{store}.{route}"] = dict(pipeline.FILLS)
            if fills[f"{store}.{route}"] != {route: len(entries)}:
                bad.append(f"{store} {route}: fills "
                           f"{fills[f'{store}.{route}']}")
        for k, v in got["numpy"].items():
            if v.tobytes() != got["native"][k].tobytes():
                bad.append(f"{store}: {k} differs between the native and "
                           "the numpy fill")
    times = {"native": [], "numpy": []}
    for _ in range(reps):
        for route in ("native", "numpy"):
            t1 = time.perf_counter()
            service.build_batch(sets["f32", route])
            times[route].append((time.perf_counter() - t1) * 1e3)
    batch = batches["f32"]["native"]
    row = {"phase": "native", "gxx_packer_s": native.build_seconds,
           "packer": os.path.relpath(native.library_path()),
           "videos": len(entries),
           "clips": int(batch["clip_mask"].sum()),
           "packed_clips": len(batch["clip_mask"]),
           "feature_bytes": int(batch["clip_video_feature"].nbytes),
           "f16_files": n_files, "convert_s": convert_s, "fills": fills,
           "host_batch_build_ms": {r: _spread(t) for r, t in times.items()},
           "card": card_line()}
    if bad:
        fail("native", f"{bad}: {json.dumps(row)}")
    emit(dict(row, ok=True))


def _durations(fx) -> dict:
    with open(fx["duration_file"]) as f:
        rows = [ln.strip().split(",") for ln in f if ln.strip()]
    return {r[0]: (float(r[1]), float(r[2])) for r in rows}


def phase_serve_upload(fx, ckpt, workdir):
    """cli.serve --upload_dir on the serve fixture's checkpoint: 12
    concurrent CaptionClient requests for the disk-staged videos, then 12
    that upload the same videos' features inline under new ids (the main
    path, counted); every uploaded caption equals the disk-staged one,
    both kernel paths launch, every upload is filled natively."""
    import numpy as np

    from svpc_torch.cli.serve import build_service, start_server, stop_server
    from svpc_torch.client import CaptionClient
    from svpc_torch.data import pipeline
    from svpc_torch.ops.attention import LAUNCHES, reset_launches

    t0 = time.perf_counter()
    spool = os.path.join(workdir, "spool")
    argv = ["--model_type", "vivt", "--torch_checkpoint",
            "--checkpoint", ckpt,
            "--word2idx_path", fx["word2idx_path"],
            "--verb2idx_path", fx["verb2idx_path"],
            "--video_feature_dir", fx["video_feature_dir"],
            "--duration_file", fx["duration_file"],
            "--batch_videos", "8", "--max_clips", "12",
            "--upload_dir", spool]
    service, _ = build_service(argv)
    server = start_server(service, "127.0.0.1", 0, max_wait_ms=100.0)
    client = CaptionClient(f"http://127.0.0.1:{server.server_address[1]}",
                           timeout=300)
    specs, durations = fx["specs"], _durations(fx)
    features = {v: {k: np.load(os.path.join(fx["video_feature_dir"],
                                            f"{v}_{k}.npy"))
                    for k in ("resnet", "bn")} for v in specs}
    setup_s = time.perf_counter() - t0

    def burst(upload):
        results, errors, latency = {}, [], []

        def ask(vid):
            kw = {}
            if upload:
                kw = dict(features[vid], duration=durations[vid][0],
                          n_frames=durations[vid][1])
            t1 = time.perf_counter()
            try:
                results[vid] = client.caption(
                    ("up_" if upload else "") + vid,
                    specs[vid]["timestamps"], specs[vid]["ingredients"],
                    **kw)
                latency.append((time.perf_counter() - t1) * 1e3)
            except Exception as e:  # reported below, fails the phase
                errors.append(f"{vid}: {e!r}")

        threads = [threading.Thread(target=ask, args=(v,)) for v in specs]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        if errors or any(t.is_alive() for t in threads):
            fail("serve_upload", f"requests failed: {errors}")
        return results, time.perf_counter() - t1, latency

    try:
        disk, _, _ = burst(False)
        torch.cuda.synchronize()
        reset_launches()
        pipeline.reset_fills()
        up, wall, latency = burst(True)
        launches = dict(LAUNCHES)
        fills = dict(pipeline.FILLS)
        stats = client.stats()
    finally:
        stop_server(server)
    bad = [vid for vid in specs
           if [c["sentence"] for c in up[vid]["captions"]]
           != [c["sentence"] for c in disk[vid]["captions"]]
           or len(up[vid]["captions"]) != len(specs[vid]["timestamps"])]
    upload_mb = sum(a.nbytes for f in features.values()
                    for a in f.values()) / 1e6
    lat = sorted(latency)
    row = {"phase": "serve_upload", "setup_s": setup_s,
           "requests": len(up), "clips": sum(
               len(s["timestamps"]) for s in specs.values()),
           "wall_s": wall, "upload_mb": upload_mb,
           "upload_mb_per_s": upload_mb / wall,
           "client_latency_ms": {"p50": lat[len(lat) // 2],
                                 "p90": lat[min(len(lat) - 1,
                                                int(0.9 * len(lat)))]},
           "daemon_stats": stats, "launches": launches,
           "feature_fills": fills, "captions_differing": bad,
           "card": card_line()}
    row["clips_per_s"] = row["clips"] / wall
    if bad:
        fail("serve_upload", f"uploaded captions differ from the disk-"
                             f"staged ones: {json.dumps(row)}")
    if fills != {"native": len(specs)}:
        fail("serve_upload", f"videos filled by route {fills}")
    _dtype_check("serve_upload", launches, "f32")
    emit(dict(row, ok=True))
    return launches


def _test_spec(fx, workdir) -> str:
    from svpc_torch.data.anet import SPLIT_FILES

    with open(os.path.join(fx["data_dir"], SPLIT_FILES["test"])) as f:
        specs = {vid: {"timestamps": a["timestamps"],
                       "ingredients": a["ingredients"]}
                 for vid, a in json.load(f).items()}
    path = os.path.join(workdir, "test_spec.json")
    with open(path, "w") as f:
        json.dump(specs, f)
    return path


def phase_export(fx, train_dir):
    """cli.export_checkpoint --ema of the train phase's checkpoint to a
    reference .chkpt; cli.caption on the .chkpt (--torch_checkpoint) and on
    the trainer checkpoint give the same sentences on the test split."""
    from svpc_torch.cli import caption, export_checkpoint
    from svpc_torch.ops.attention import LAUNCHES, reset_launches

    ckpt = _checkpoint(train_dir)
    spec = _test_spec(fx, train_dir)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = export_checkpoint.main(_fixture_argv(fx) + [
        "--checkpoint", ckpt, "--out",
        os.path.join(train_dir, "exported.chkpt"), "--ema"])
    export_s = time.perf_counter() - t0
    runs = {}
    for name, flags in (("trainer", ["--checkpoint", ckpt]),
                        ("chkpt", ["--checkpoint", out,
                                   "--torch_checkpoint"])):
        runs[name] = caption.main(_fixture_argv(fx) + flags + [
            "--input_json", spec, "--val_batch_size", "16",
            "--output", os.path.join(train_dir, f"captions_{name}.json")])
    launches = dict(LAUNCHES)
    sents = {k: {v: [c["sentence"] for c in clips]
                 for v, clips in r.items()} for k, r in runs.items()}
    bad = [v for v in sents["trainer"]
           if sents["trainer"][v] != sents["chkpt"].get(v)]
    row = {"phase": "export", "checkpoint": os.path.basename(ckpt),
           "export_s": export_s, "chkpt_bytes": os.path.getsize(out),
           "videos": len(sents["trainer"]), "differing": bad,
           "empty": sum(not s.strip() for v in sents["chkpt"].values()
                        for s in v),
           "launches": launches}
    if bad or not sents["trainer"]:
        fail("export", f"the .chkpt captions differently: {json.dumps(row)}")
    emit(dict(row, ok=True))
    return launches


def phase_dump_memories(fx, train_dir, seed):
    """cli.dump_memories on the train phase's checkpoint over the val
    split, on the card (the main path, counted), with every attention form
    of that run recorded at the CLI's own batch and held against
    attention_plain (f32 1e-5) and timed; one 4-video val batch's dump on
    the card and on the CPU with the same Gumbel noise (every probability
    within 1e-4); cli.validate_data clean on the fixture's three
    splits."""
    import pickle

    import numpy as np

    from svpc_torch.cli import dump_memories as dm
    from svpc_torch.cli.validate_data import main as validate
    from svpc_torch.config import Config
    from svpc_torch.data.pipeline import CaptionDataset
    from svpc_torch.model import SVPCModel
    from svpc_torch.ops.attention import LAUNCHES, reset_launches
    from svpc_torch.train.state import load_eval_weights

    ckpt = _checkpoint(train_dir)
    out_dir = os.path.join(train_dir, "memories")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with _AttentionRecorder() as rec:
        rec.stage = "dump_memories"
        path = dm.main(_fixture_argv(fx) + [
            "--checkpoint", ckpt, "--split", "val", "--output_dir", out_dir,
            "--val_batch_size", "16"])
    dump_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    with open(path, "rb") as f:
        dump = pickle.load(f)
    keys = {"entity_probs", "action_probs", "entity_vectors",
            "re_pred_entity_probs", "re_pred_action_probs",
            "re_entity_vectors"}
    bad = [v for v, e in dump.items() if set(e) != keys or not all(
        np.isfinite(x).all() for k, x in e.items() if k != "entity_vectors")]

    cfg = Config.from_json(ckpt + ".cfg.json").replace_train(
        val_batch_size=4)
    weights = load_eval_weights(ckpt)
    ds = CaptionDataset(cfg, "val", lazy_features=True)
    got = {}
    with _SharedGumbel(seed):
        for dev in ("cuda", "cpu"):
            model = SVPCModel(cfg.model).to(dev).eval()
            model.load_state_dict({n: w.to(dev) for n, w in weights.items()},
                                  strict=True)
            got[dev] = dm.dump_memories(model, ds, cfg, max_batches=1)
    diffs = {}
    for k in ("entity_probs", "action_probs", "re_pred_entity_probs",
              "re_pred_action_probs"):
        diffs[k] = max(float(np.abs(got["cuda"][v][k] - e[k]).max(initial=0))
                       for v, e in got["cpu"].items())
    rows, kernel_bad = _form_rows(rec.calls)
    clean = {}
    for split in ("train", "val", "test"):
        try:
            validate(_fixture_argv(fx) + ["--split", split])
            clean[split] = True
        except SystemExit as e:
            clean[split] = e.code in (0, None)
    row = {"phase": "dump_memories", "dump_s": dump_s,
           "recipes": len(dump), "bad_recipes": bad,
           "launches": launches, "card_vs_cpu_max_abs": diffs, "tol": 1e-4,
           "forms": rows, "validate_data_clean": clean, "card": card_line()}
    if bad or len(dump) != len(ds) or \
            max(diffs.values()) > 1e-4 or kernel_bad or \
            not all(clean.values()) or not launches["fused_attention.tile"]:
        fail("dump_memories", f"{bad} {kernel_bad}: {json.dumps(row)}")
    emit(dict(row, ok=True))
    return launches


# ---------------------------------------------------------------------- #
# parallel
# ---------------------------------------------------------------------- #

# f32 m, v and EMA of the 40,144,393 parameters: 481,732,716 B on a rank
# that holds them whole; at dp2 ZeRO-1 each rank holds half of every leaf
# but the five with no even dim (9 elements), 240,866,412 B
ZERO1_PREDICTED_BYTES = {"whole": 481_732_716, "dp2_zero1": 240_866_412}


def _rank_rows(out_dir, world):
    rows = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            rows.append(json.load(f))
    return rows


def _worst_close(got, want, rtol, atol):
    """max over tensors of max(|got - want| - atol - rtol |want|): <= 0
    when every element is within the tolerance."""
    return max((got[n].float().cpu() - w.float().cpu()).abs()
               .sub(atol + rtol * w.float().cpu().abs()).max().item()
               for n, w in want.items())


def _parallel_steps(cfg, seed, base, on_card):
    """Two train steps (dropout on) at dp2 ZeRO-1 on two gloo ranks of the
    card, against the same steps in this process on the same global
    batches from the same init."""
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.svpc import to_tensors
    from svpc_torch.parallel.worker import run_job, train_batches, \
        train_state
    from svpc_torch.train.step import train_step

    spec = dict(on_card, cfg=cfg.to_dict(), seed=seed, n_steps=2,
                steps_per_epoch=6, dp=2, tp=1,
                out=os.path.join(base, "steps"))
    wall = run_job("steps", spec, 2, timeout=300)
    res = torch.load(os.path.join(spec["out"], "result.pt"),
                     weights_only=False)
    ranks = _rank_rows(spec["out"], 2)
    # the one-process peak counts what this run allocates (model, moments,
    # EMA, steps) above what earlier phases left, as a rank's counts its own
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    left = torch.cuda.memory_allocated()
    model = SVPCModel(cfg.model, torch.Generator().manual_seed(seed))
    state = train_state(cfg, model.to("cuda"), 6)
    ref = [train_step(state, to_tensors(b, torch.device("cuda")), cfg)
           for b in train_batches(cfg, 2, dp=2)]
    one_peak = torch.cuda.max_memory_allocated() - left
    losses = [{k: float(m[k]) for k in ("loss", "caption_loss",
                                        "grad_norm")} for m in ref]
    rel = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in
              zip(res["losses"], losses) for k in w)
    worst = {"params": _worst_close(res["state"]["model"], {
                 n: p.detach() for n, p in state.params.items()},
                 2e-4, 1e-5),
             "ema": _worst_close(res["state"]["ema_shadow"],
                                 state.ema_shadow, 2e-4, 1e-5)}
    row = {"wall_s": wall, "losses_mesh": res["losses"],
           "losses_one_process": losses, "loss_max_rel": rel,
           "loss_tol": 1e-5, "tol_excess": worst,
           "zero1_bytes": [{"rank": i, **{k: r[k] for k in (
               "bytes", "bytes_without_zero1", "max_memory_allocated")}}
               for i, r in enumerate(ranks)],
           "zero1_bytes_predicted": ZERO1_PREDICTED_BYTES,
           "one_process_max_memory_allocated": one_peak}
    bad = []
    if not rel <= 1e-5:
        bad.append("dp2 losses")
    if not max(worst.values()) <= 0:
        bad.append("dp2 parameters or EMA")
    for r in ranks:
        held = sum(r["bytes"].values())
        whole = sum(r["bytes_without_zero1"].values())
        if whole != ZERO1_PREDICTED_BYTES["whole"] or \
                held != ZERO1_PREDICTED_BYTES["dp2_zero1"]:
            bad.append(f"ZeRO-1 bytes {held} of {whole}")
    return row, bad


def _parallel_loop(cfg, fx, base, on_card):
    """train.loop.train for one short epoch (3 steps, validation, language
    eval, checkpoints) at dp2 ZeRO-1 on two gloo ranks of the card; its
    rank-0 checkpoint in a one-process cli.evaluate gives the captions
    the run's own validation decoded."""
    from svpc_torch.cli.evaluate import main as evaluate_main
    from svpc_torch.parallel.worker import run_job

    out = os.path.join(base, "loop")
    spec = dict(on_card, cfg=cfg.replace_train(n_epoch=1).to_dict(),
                max_steps_per_epoch=3, out=out)
    wall = run_job("train", spec, 2, timeout=300)
    with open(os.path.join(out, "result.json")) as f:
        res = json.load(f)
    with open(os.path.join(out, "greedy_pred_val_epoch0.json")) as f:
        mesh_sub = json.load(f)
    ckpt = os.path.join(out, "checkpoint_last")
    one = evaluate_main(_eval_argv(fx, ckpt) + [
        "--split", "val", "--val_batch_size", "16",
        "--output_dir", os.path.join(out, "eval_one_process")])
    sentences = lambda sub: {v: [e["sentence"] for e in es]
                             for v, es in sub["results"].items()}
    differ = [v for v, s in sentences(one["submission"]).items()
              if sentences(mesh_sub).get(v) != s]
    ranks = _rank_rows(out, 2)
    row = {"wall_s": wall, "losses": [s["loss"] for s in res["steps"]],
           "val": res["history"][0]["val"],
           "lang": res["history"][0]["lang"],
           "videos": len(sentences(mesh_sub)),
           "videos_captioned_differently": differ,
           "launches_by_rank": [r["launches"] for r in ranks]}
    bad = []
    if len(row["losses"]) != 3 or not all(
            math.isfinite(x) for x in row["losses"]):
        bad.append("loop losses")
    if differ or not row["videos"]:
        bad.append("one-process evaluate captions the checkpoint "
                   "differently")
    if not all(r["launches"]["fused_attention.tile"]
               and r["launches"]["fused_attention.decode"] for r in ranks):
        bad.append("a kernel path did not launch in a rank's validation")
    return row, bad, ckpt, [r["launches"] for r in ranks]


def _parallel_decode(ckpt, base, on_card):
    """tp2 greedy decode of one 16-video val batch on two gloo ranks of
    the card against the one-process decode; every attention of the tp
    run at 6 heads, its forms held against attention_plain."""
    import svpc_torch.train.loop as loop
    from svpc_torch.config import Config
    from svpc_torch.data.pipeline import CaptionDataset
    from svpc_torch.decode.greedy import greedy_decode
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.svpc import to_tensors
    from svpc_torch.parallel.worker import run_job
    from svpc_torch.train.state import load_eval_weights

    out = os.path.join(base, "decode")
    spec = dict(on_card, checkpoint=ckpt, val_batch_size=16, dp=1, tp=2,
                out=out)
    wall = run_job("decode", spec, 2, timeout=300)
    res = torch.load(os.path.join(out, "result.pt"), weights_only=False)
    ranks = _rank_rows(out, 2)
    cfg = Config.from_json(ckpt + ".cfg.json").replace_train(
        val_batch_size=16)
    model = SVPCModel(cfg.model)
    model.load_state_dict(load_eval_weights(ckpt), strict=True)
    model = model.to("cuda").eval()
    ds = CaptionDataset(cfg, "val", lazy_features=True)
    dec = loop.make_eval_decoder(model, cfg, ds)
    batch_np, _ = next(ds.batches(dec["cfg"].train.val_batch_size,
                                  builder=dec["builder"]))
    tokens = greedy_decode(model, to_tensors(batch_np,
                                             torch.device("cuda"))).cpu()
    real = torch.from_numpy(batch_np["step_mask"]) > 0
    calls = {("tp2_decode",) + tuple(f["key"][:3]) + (tuple(f["key"][3]),):
             {"inputs": tuple(t.to("cuda") for t in f["inputs"])
              + (f["num_heads"],), "calls": f["calls"]}
             for f in res["forms"]}
    forms, kernel_bad = _form_rows(calls)
    row = {"wall_s": wall, "clips": int(real.sum()),
           "differing_token_positions": int(
               (res["tokens"] != tokens)[real].sum()),
           "heads_by_rank": [r["heads"] for r in ranks],
           "launches_by_rank": [r["launches"] for r in ranks],
           "forms": forms}
    bad = list(kernel_bad)
    if row["differing_token_positions"] or res["tokens"].shape != \
            tokens.shape:
        bad.append("tp2 tokens differ from the one-process decode")
    if any(set(r["heads"]) != {"6"} for r in ranks):
        bad.append("an attention of the tp2 run did not take 6 heads")
    if not all(r["launches"]["fused_attention"] == sum(r["heads"].values())
               for r in ranks):
        bad.append("a tp2 attention call did not launch the kernel")
    return row, bad, [r["launches"] for r in ranks]


def _parallel_nccl(cfg, seed, base):
    """NCCL at world size 1: the collectives forward and backward on the
    card, and a dp1 x tp1 train step through the mesh path equal to the
    same step without one."""
    from svpc_torch.parallel.worker import run_job

    out = os.path.join(base, "nccl")
    spec = dict(device="cuda:0", backend="nccl", cfg=cfg.to_dict(),
                seed=seed, out=out)
    wall = run_job("nccl", spec, 1, timeout=300)
    with open(os.path.join(out, "result.json")) as f:
        res = json.load(f)
    bad = []
    if res["backend"] != "nccl" or not all(res["collectives"].values()):
        bad.append(f"NCCL collectives {res['collectives']}")
    step = res["train_step"]
    if any(abs(step["mesh"][k] - v) > 1e-6 * abs(v)
           for k, v in step["plain"].items()):
        bad.append("the dp1 x tp1 mesh step differs from the plain step")
    return dict(res, wall_s=wall), bad


def phase_parallel(seed: int, workdir: str, fx):
    """The dp x tp mesh of svpc_torch.parallel at full vivt width on the
    train fixture, f32, each part's ranks in processes of
    svpc_torch.parallel.worker (each killed at its timeout): two ranks
    share cuda:0 over gloo (NCCL refuses two ranks on one card), so their
    times are one card's, not a scaling figure."""
    t0 = time.perf_counter()
    base = os.path.join(workdir, "parallel")
    on_card = dict(device="cuda:0", backend="gloo", timeout_s=300)
    cfg = _train_cfg(fx).replace_model(vocab_pad_multiple=2) \
        .replace_train(dp_size=2, zero1=True)
    row, bad = {"phase": "parallel"}, []
    row["steps_dp2_zero1"], b = _parallel_steps(cfg, seed, base, on_card)
    bad += b
    row["loop_dp2_zero1"], b, ckpt, loop_launches = _parallel_loop(
        cfg, fx, base, on_card)
    bad += b
    row["decode_tp2"], b, decode_launches = _parallel_decode(
        ckpt, base, on_card)
    bad += b
    row["nccl_world1"], b = _parallel_nccl(
        cfg.replace_train(dp_size=1, zero1=False), seed, base)
    bad += b
    launches = {k: sum(l[k] for l in loop_launches + decode_launches)
                for k in loop_launches[0]}
    row.update(phase_s=time.perf_counter() - t0, launches=launches,
               card=card_line())
    if bad:
        fail("parallel", f"{bad}: {json.dumps(row, default=str)}")
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
        phases = {}
        service, fx, ckpt, phases["serve"] = phase_serve(args.seed, workdir)
        phase_parity(service, fx, ckpt)
        phase_native(service, fx, workdir)
        service16, _, _, phases["serve_bf16"] = phase_serve(
            args.seed, workdir, "bfloat16", fx, ckpt)
        phase_parity_bf16(service16, fx, ckpt)
        del service, service16
        phases["serve_upload"] = phase_serve_upload(fx, ckpt, workdir)
        phases["train"], train_fx, _, train_dir = phase_train(args.seed,
                                                               workdir)
        phases["train_bf16"], train_dir16 = phase_train_bf16(
            args.seed, workdir, train_fx)
        phases["train_knobs"] = phase_train_knobs(args.seed, workdir,
                                                  train_fx)
        phases["parallel"] = phase_parallel(args.seed, workdir, train_fx)
        phases["evaluate"] = phase_evaluate(train_fx, train_dir)
        phases["evaluate_bf16"] = phase_evaluate_bf16(train_fx, train_dir,
                                                      train_dir16)
        phases["serve_beam"] = phase_serve_beam(train_fx, train_dir)
        phases["export"] = phase_export(train_fx, train_dir)
        phases["dump_memories"] = phase_dump_memories(train_fx, train_dir,
                                                      args.seed)
    print(card_line(), flush=True)
    emit({"kernels": kernel_summary(rows, phases)})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
