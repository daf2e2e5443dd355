#!/usr/bin/env python3
"""The attention kernel's share of its roofline in a serving cell, with
the calls that a replayed decode graph launches counted.

The benchmark's ``fused_attention_roofline`` (benchmark/metrics/) takes
the shapes of the attention calls from the Python wrapper
``svpc_torch.model.layers.fused_attention``.  A replayed decode graph
(svpc_torch/decode/greedy.py) launches the kernels it captured without
calling that wrapper, while the profiled slice still holds their device
time, so the metric then counts the encode's calls alone.  This makes one
traced run of a cell through the benchmark's own entry, with two
additions: each graph capture records the shapes of the attention calls
it captures, and each replay inside the profiled slice adds them to the
benchmark's record of calls.  The roofline's bound then covers every
kernel whose time it divides by.  The benchmark's files are not changed.

    python3 tools/decode_graph_roofline.py --workload vivt-serve-flood \\
        --seed 1 --seconds 40

The last line of standard output is the benchmark's result line of a
``--trace 1`` run; standard error ends with the calls counted in the
profiled slice, eager and replayed.
"""

import time

T_START = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]


def install() -> dict:
    """Wraps the benchmark's serving run and the decode graphs; -> the
    counts, filled as the run goes."""
    import torch
    import pbench.serve as serve
    import svpc_torch.model.layers as layers
    from svpc_torch.decode import greedy

    seen = {"calls": None, "replayed": 0, "by_key": {}}
    real_install = serve._install
    real_capture = greedy.DecodeGraphs._capture
    real_run = greedy.DecodeGraphs.run

    def install_(ctx, svc, served, rec, spans, calls):
        seen["calls"] = calls
        return real_install(ctx, svc, served, rec, spans, calls)

    def capture(self, model, inputs, grid, key):
        fused, shapes = layers.fused_attention, []

        def recorded(q, k, v, mask, num_heads):
            # the record's form of benchmark/pbench/serve.py:_install
            shapes.append((q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                           mask.numel(), q.element_size(),
                           mask.element_size(),
                           "bfloat16" if q.dtype == torch.bfloat16
                           else "float32"))
            return fused(q, k, v, mask, num_heads)

        layers.fused_attention = recorded
        try:
            tokens = real_capture(self, model, inputs, grid, key)
        finally:
            layers.fused_attention = fused
        # the eager warm-up's calls come first, the capture's last
        n = self.entries[key].launches.get("fused_attention", 0)
        seen["by_key"][key] = shapes[len(shapes) - n:]
        return tokens

    def run(self, model, inputs, grid):
        key = greedy.graph_key(model, inputs)
        out = real_run(self, model, inputs, grid)
        calls = seen["calls"]
        if out[1] and calls is not None and calls["on"]:
            calls["shapes"].extend(seen["by_key"][key])
            seen["replayed"] += len(seen["by_key"][key])
        return out

    serve._install = install_
    greedy.DecodeGraphs._capture = capture
    greedy.DecodeGraphs.run = run
    return seen


def main(argv=None) -> int:
    from pbench.cli import main as bench

    argv = list(sys.argv[1:] if argv is None else argv)
    seen = install()
    rc = bench(T_START, argv + ["--trace", "1"])
    calls = seen["calls"]
    total = len(calls["shapes"]) if calls is not None else 0
    print(f"attention calls in the profiled slice: eager "
          f"{total - seen['replayed']}, replayed {seen['replayed']}, graphs "
          f"captured {len(seen['by_key'])}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
