"""The serving window that every architecture shares: ``cli.serve``'s
daemon (``start_server`` over the service the architecture builds) in this
process, the load generator in another.

Set-up writes the video pool, has the architecture build and warm the
service on the device from the seed's weights (``Hooks.build``) and put in
its wrappers (``Hooks.install``), and sends every pool video once through
HTTP.  The window then runs the traffic file's loop for ``--seconds``.
After it: the request accounting, each served video's operations
(``Hooks.video_flops``), what a traced run's profiled slice recorded
(``Hooks.slice_readings``) and the reference check (``Hooks.check``).
Traced runs profile the window's last seconds; the architecture's
wrappers record the spans and the calls' shapes there.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import urllib.request
from typing import Callable, Dict

import numpy as np

from pbench import peaks
from pbench.fixture import pool_sizes, write_pool
from pbench.host import probe
from pbench.trace import Spans, profile_window

LOADGEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "loadgen.py")


def _schedule(traffic: Dict, seed: int, n_pool: int, seconds: float):
    """The request order (cycles of permutations of the pool) and, for an
    open loop, the due offsets: a fixed set of exponential gaps at the
    traffic's rate (``plan_seed``), in the seed's order."""
    rng = np.random.RandomState(
        np.random.SeedSequence([seed, 5]).generate_state(1)[0])
    rate = traffic.get("rate_per_s", 0.0)
    n = int(max(rate, 200.0) * seconds * 1.5) + 4 * n_pool
    sequence = np.concatenate([rng.permutation(n_pool)
                               for _ in range(n // n_pool + 1)])
    offsets = []
    if traffic["loop"] == "open":
        plan = np.random.RandomState(traffic["plan_seed"])
        gaps = plan.exponential(1.0 / rate, size=int(rate * seconds * 1.5)
                                + 16)
        offsets = np.cumsum(rng.permutation(gaps)).tolist()
    return sequence.tolist(), offsets


@dataclasses.dataclass(frozen=True)
class Hooks:
    """What an architecture gives the serving window (benchmark/arch/)."""
    # (ctx, fixture) -> the service (``build_batch``, ``close``; served by
    # ``start_server``), built on the device with the seed's weights and
    # warmed
    build: Callable
    # (ctx, service, served, rec, spans, calls) -> remove(): puts in the
    # wrappers that append (video id, tokens) to ``served`` while
    # ``rec["on"]``, add the spans "build", "copy" and "decode" to
    # ``spans`` with ``spans.wrap`` (a call that may replay CUDA graphs
    # runs inside one: pbench/spec.py) and the shapes a roofline reads to
    # ``calls["shapes"]`` while ``calls["on"]``; remove() takes them out
    install: Callable
    # (c, frames, entities, ingredient tokens) -> operations of one served
    # video
    video_flops: Callable
    # (calls) -> what a traced run's record gains from the calls recorded
    # in the profiled slice
    slice_readings: Callable
    # (ctx, fixture, served) -> the numbers compared, by name
    check: Callable


def _install(ctx, svc, served, rec, spans, calls):
    """The cell's architecture's wrappers around the program's calls;
    returns a function that takes them out again.  (tools/
    decode_graph_roofline.py wraps this function.)"""
    return ctx.cell.hooks.install(ctx, svc, served, rec, spans, calls)


def run(ctx) -> Dict:
    """Set-up, the window and the reference check of one serving run;
    returns the run's record."""
    import torch
    import svpc_torch.serving as serving
    from svpc_torch.cli.serve import start_server, stop_server

    c, traffic, seed, device = ctx.config, ctx.traffic, ctx.seed, ctx.device
    hooks = ctx.cell.hooks
    W = ctx.seconds
    fx = write_pool(ctx.workdir, c, traffic, seed)
    names = list(fx["specs"])
    ctx.mark("pool written")
    svc = hooks.build(ctx, fx)
    ctx.mark("service built and warmed")
    served, rec, spans = [], {"on": False}, Spans()
    calls = {"on": False, "shapes": []}
    remove = _install(ctx, svc, served, rec, spans, calls)
    server = start_server(svc, "127.0.0.1", 0,
                          max_wait_ms=traffic["max_wait_ms"],
                          request_timeout=traffic["timeout_s"])
    lg = None
    try:
        host, port = server.server_address[:2]
        sequence, offsets = _schedule(traffic, seed, len(names), W)
        lg = subprocess.Popen([sys.executable, LOADGEN],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                              text=True)
        lg.stdin.write(json.dumps(dict(
            host=host, port=port, cores=ctx.loadgen_cores,
            loop=traffic["loop"],
            clients=traffic.get("clients", 0),
            senders=traffic.get("senders", 0), warmup=len(names),
            seconds=W, timeout_s=traffic["timeout_s"], offsets=offsets,
            sequence=sequence,
            bodies=[json.dumps(dict(video_id=n, **fx["specs"][n]))
                    for n in names])) + "\n")
        lg.stdin.flush()
        ready = lg.stdout.readline().strip()
        if ready != "WARM":
            raise RuntimeError(f"the warm-up requests failed: {ready!r}")
        ctx.mark("warm-up requests answered")
        probe("before the window")
        server.batcher.stats = serving.ServingStats()  # the window's own
        rec["on"], spans.on = True, ctx.trace
        t0 = time.monotonic() + 0.05
        lg.stdin.write(f"GO {t0!r}\n")
        lg.stdin.flush()
        setup_s = t0 - ctx.t_start
        sl = None
        if ctx.trace:
            def switch(on):
                calls["on"] = on
            length = min(traffic["profile_s"], 0.5 * W)
            sl = profile_window(switch, W - length, length, t0, ctx.workdir,
                                spans.quiet)
        result = json.loads(lg.stdout.readline())
        lg.wait(timeout=60)
        probe("after the window")
        rec["on"] = spans.on = False
        with urllib.request.urlopen(
                f"http://{host}:{port}/v1/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        if lg is not None and lg.poll() is None:
            lg.kill()
            lg.wait()
        stop_server(server)
        svc.close()
        remove()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    trace = sl.read(spans) if sl is not None else None
    del svc, server
    if device.type == "cuda":
        torch.cuda.empty_cache()

    reqs = [dict(video=names[i], due=due - t0, sent=sent - t0,
                 done=done - t0, status=status, clips=clips)
            for i, due, sent, done, status, clips in result["requests"]]
    due = [r for r in reqs if 0.0 <= r["due"] < W]
    done = [r for r in reqs if r["status"] == 200 and 0.0 <= r["done"] <= W]
    late = sorted(r["sent"] - r["due"] for r in due) or [0.0]
    print(f"load generator: {len(due)} requests due in the window, "
          f"lateness p50 {late[len(late) // 2] * 1e3:.3f} ms, max "
          f"{late[-1] * 1e3:.3f} ms", file=sys.stderr)
    halves = [sorted(r["done"] - r["due"] for r in due
                     if (r["due"] < W / 2) == first) for first in (1, 0)]
    print("backlog: offered %.3f/s, answered in the window %.3f/s, "
          "latency p50 first half %.1f ms, second half %.1f ms" % (
              len(due) / W, len(done) / W,
              *(1e3 * h[len(h) // 2] if h else 0.0 for h in halves)),
          file=sys.stderr)
    sizes = pool_sizes(c, fx)
    model_flops = sum(hooks.video_flops(c, *sizes[r["video"]])
                      for r in done)
    record = dict(
        kind="serve", window_s=W, setup_s=setup_s,
        attempted=len(due),
        failed=sum(r["status"] != 200 for r in due),
        clips_in_window=sum(r["clips"] for r in done),
        latencies_ms=[(r["done"] - r["due"]) * 1e3 if r["status"] == 200
                      else traffic["timeout_s"] * 1e3 for r in due],
        model_flops=model_flops,
        matmul_peak=peaks.MATMUL_FLOPS_PER_S[ctx.model_cfg.compute_dtype],
        stats=stats, memory_peak_bytes=peak,
        spans={n: spans.durations(n) for n in ("build", "copy", "decode")},
        trace=trace)
    if trace is not None:
        record.update(hooks.slice_readings(calls))
    record["checks"] = hooks.check(ctx, fx, served)
    return record
