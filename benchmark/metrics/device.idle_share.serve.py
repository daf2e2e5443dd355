"""1 - device-busy / wall over the profiled slice (the union of the
card's kernels, copies and sets in the torch.profiler trace)."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "serve" or not t:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
