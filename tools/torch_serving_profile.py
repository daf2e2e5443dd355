#!/usr/bin/env python3
"""Where a served batch's time goes in svpc_torch, on one NVIDIA card.

    python3 tools/torch_serving_profile.py [--seed 0] [--reps 5]

Builds the full-width vivt model (random weights from --seed) and the
serving geometry of chip_smoke.py (batch_videos=8, max_clips=12, packed
96 clips x 100 frames), fills one batch with 8 fixture videos, and prints
one JSON line with:

  phases_ms      host-clock time of each stage of one decode (host batch
                 build, host->device copy, encode, the 21 cached decode
                 steps (greedy_decode minus one encode), device->host
                 copy), each ended by a synchronize;
  batch_ms       the whole decode, mean over --reps;
  profile        torch.profiler over one decode: device-busy time (sum of
                 kernel times on the card), idle share of the wall time,
                 kernel launches, and the kernels that take the most
                 device time, and the attention kernel's launches and
                 device time by path (tile, decode);
  wrapper_call_us
                 host time of one fused_attention call at the cached
                 decode shapes: 5 rounds of 1000 calls each, queued with
                 no synchronize between them (the card needs less time a
                 call than the host, so the host clock reads the wrapper's
                 own cost), in us a call; "min" is the least round.

Run it from the repository root on a machine with the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _sync_ms(t0: float) -> float:
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 2

    from svpc_torch.config import Config
    from svpc_torch.data.synthetic import write_serving_fixture
    from svpc_torch.decode.greedy import greedy_decode
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.svpc import to_tensors
    from svpc_torch.ops.attention import LAUNCHES, fused_attention, \
        reset_launches
    from svpc_torch.serving import CaptionService

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.makedirs(os.path.join(root, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="profile_",
                                     dir=os.path.join(root, "build")) as w:
        cfg = Config()
        fx = write_serving_fixture(w, cfg, n_videos=8, min_clips=12,
                                   max_clips=12, seed=args.seed)
        cfg = cfg.replace_data(**{k: fx[k] for k in (
            "word2idx_path", "verb2idx_path", "duration_file",
            "video_feature_dir")})
        model = SVPCModel(cfg.model, torch.Generator().manual_seed(args.seed))
        svc = CaptionService(cfg, model, batch_videos=8, max_clips=12)
        examples = [svc.example_for(svc.make_entry(v, s))
                    for v, s in fx["specs"].items()]

        def decode_staged():
            out = {}
            t0 = time.perf_counter()
            batch = svc.build_batch(examples)
            out["host_batch_build"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            b = to_tensors(batch, svc.device)
            out["host_to_device"] = _sync_ms(t0)
            with torch.no_grad():
                t0 = time.perf_counter()
                svc.model.encode(b)
                out["encode"] = _sync_ms(t0)
            t0 = time.perf_counter()
            tokens = greedy_decode(svc.model, b)
            # greedy_decode encodes again, then runs the cached steps
            out["decode_steps"] = _sync_ms(t0) - out["encode"]
            t0 = time.perf_counter()
            tokens.cpu()
            out["device_to_host"] = (time.perf_counter() - t0) * 1e3
            return out

        def decode_whole():
            b = to_tensors(svc.build_batch(examples), svc.device)
            return greedy_decode(svc.model, b).cpu()

        decode_whole()  # warm
        phases = [decode_staged() for _ in range(args.reps)]
        phases_ms = {k: sum(p[k] for p in phases) / len(phases)
                     for k in phases[0]}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            decode_whole()
        batch_ms = (time.perf_counter() - t0) * 1e3 / args.reps

        from torch.profiler import ProfilerActivity, profile
        reset_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            decode_whole()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # the card's own events (kernels, copies); the CPU-side operator
        # events carry the same device time again, so they are left out
        dev_us = lambda e: getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0.0))
        kernels = [e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")]
        busy_ms = sum(dev_us(e) for e in kernels) / 1e3
        # the attention kernel's device time by path (csrc kernel names)
        attn_ms = {path: sum(dev_us(e) for e in kernels
                             if f"{path}_kernel<" in e.key) / 1e3
                   for path in ("tile", "decode")}
        top = sorted(kernels, key=dev_us, reverse=True)[:12]

        m = cfg.model
        gen = torch.Generator().manual_seed(args.seed)
        wrapper_us = {}
        for name, lk in (("decoder_self_cached", m.max_t_len),
                         ("decoder_cross_cached", 3)):
            q, k, v = (torch.randn(96, length, m.hidden_size, generator=gen)
                       .to(svc.device) for length in (1, lk, lk))
            mask = torch.ones(96, 1, lk, device=svc.device)
            rounds = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(1000):
                    fused_attention(q, k, v, mask, m.num_attention_heads)
                rounds.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            wrapper_us[name] = {"min": min(rounds), "rounds": rounds}
        print(json.dumps({
            "card": torch.cuda.get_device_name(0),
            "geometry": {"batch_videos": 8, "max_clips": 12,
                         "packed_clips": 96, "v_len": cfg.model.max_v_len,
                         "max_t_len": cfg.model.max_t_len},
            "phases_ms": phases_ms, "batch_ms": batch_ms,
            "profile": {
                "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "idle_share": (1.0 - busy_ms / wall_ms
                               if kernels else None),
                "kernel_launches": sum(e.count for e in kernels),
                # in all, and by the kernel's tile and decode paths
                "fused_attention_launches": dict(LAUNCHES),
                "fused_attention_device_ms": attn_ms,
                "top_kernels": [{"name": e.key[:80], "count": e.count,
                                 "device_ms": dev_us(e) / 1e3}
                                for e in top]},
            "wrapper_call_us": wrapper_us,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
