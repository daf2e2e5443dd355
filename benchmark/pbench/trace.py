"""What a traced run records: host spans from the benchmark's own
wrappers around the program's layers, and a torch.profiler slice of the
window read from its Chrome trace (device-busy time, the device
operations that took most time, the idle gaps labelled by the span that
was open, the attention kernel's device time).

The profiler's arithmetic is copied from tools/torch_serving_profile.py
(commit aeb5374): busy time is the card's own events (kernels, copies,
sets), idle share 1 - busy / wall.  Here busy time is the union of those
events' intervals over the slice, so overlapping streams count once.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "pbench.slice_start"


class Spans:
    """Host spans (name, start, end) on the monotonic clock, kept in
    memory; recorded only while ``on``."""

    def __init__(self):
        self.on = False
        self._lock = threading.Lock()
        self.items: List[Tuple[str, float, float]] = []

    def add(self, name: str, t0: float, t1: float) -> None:
        if self.on:
            with self._lock:
                self.items.append((name, t0, t1))

    def durations(self, name: str) -> List[float]:
        return [t1 - t0 for n, t0, t1 in self.items if n == name]

    def wrap(self, name: str, fn, sync=None):
        """``fn`` timed as span ``name``; ``sync()`` ends it (a device
        synchronize) when given."""
        def wrapped(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            t0 = time.monotonic()
            out = fn(*args, **kwargs)
            if sync is not None:
                sync()
            self.add(name, t0, time.monotonic())
            return out
        return wrapped


class ProfilerSlice:
    """torch.profiler over one slice of the window (the card's events)."""

    def __init__(self, workdir: str):
        self.path = os.path.join(workdir, "slice_trace.json")
        self.prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        with record_function(MARK):
            self.t_start = time.monotonic()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.t_stop = time.monotonic()
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)
        self.prof = None

    def read(self, spans: Spans) -> Dict:
        """busy_s, window_s, the device operations and idle gaps, and the
        attention kernel's device seconds."""
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(self.path)
        mark = [e for e in events if e.get("name") == MARK]
        if not mark:
            raise RuntimeError("the profiler trace lacks the slice marker")
        base_us = float(mark[0]["ts"])
        length_us = (self.t_stop - self.t_start) * 1e6
        dev = []
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
                t0 = max(float(e["ts"]) - base_us, 0.0)
                t1 = min(float(e["ts"]) + float(e.get("dur", 0)) - base_us,
                         length_us)
                if t1 > t0:
                    dev.append((t0, t1, e["name"]))
        return summarize(dev, length_us, spans, self.t_start)


def summarize(dev: List[Tuple[float, float, str]], length_us: float,
              spans: Spans, t_start: float) -> Dict:
    """Device intervals (start_us, end_us, name) of a slice of
    ``length_us`` -> busy, ops by time, the longest idle gaps by span."""
    by_name: Dict[str, float] = defaultdict(float)
    for t0, t1, name in dev:
        by_name[name] += (t1 - t0) * 1e-6
    merged: List[List[float]] = []
    for t0, t1, _ in sorted(dev):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    busy_us = sum(t1 - t0 for t0, t1 in merged)
    gaps, prev = [], 0.0
    for t0, t1 in merged + [[length_us, length_us]]:
        if t0 > prev:
            gaps.append((prev, t0))
        prev = max(prev, t1)
    labelled = []
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = t_start + (g0 + g1) / 2e6
        open_ = [n for n, s0, s1 in spans.items if s0 <= mid <= s1]
        labelled.append([open_[-1] if open_ else "none", (g1 - g0) * 1e-6])
    attention = sum(s for n, s in by_name.items()
                    if "tile_kernel<" in n or "decode_kernel<" in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us * 1e-6, "window_s": length_us * 1e-6,
            "device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": labelled, "attention_kernel_s": attention}


def profile_window(run_slice, offset_s: float, length_s: float,
                   t0: float, workdir: str) -> Optional[ProfilerSlice]:
    """Sleep until ``t0 + offset_s``, profile ``length_s`` seconds while
    ``run_slice(on)`` switches the recording wrappers on and off."""
    time.sleep(max(0.0, t0 + offset_s - time.monotonic()))
    sl = ProfilerSlice(workdir)
    sl.start()
    run_slice(True)
    time.sleep(length_s)
    run_slice(False)
    sl.stop()
    return sl
