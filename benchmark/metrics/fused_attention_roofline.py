"""The attention kernel's share of its roofline over the profiled slice:
the sum of each recorded call's bound from its shapes (pbench/flops.py)
over the device time of the kernel's events (tile_kernel, decode_kernel)
in the slice."""


def read(run):
    t = run.get("trace")
    if not t or not t["attention_kernel_s"] or "attention_bound_s" not in run:
        return None
    return 100.0 * run["attention_bound_s"] / t["attention_kernel_s"]
