"""The card memory the run held at its peak, in MiB: the CUDA caching
allocator's largest allocated total over set-up and the window (the
result line's ``device.memory_peak_bytes``), read after the window and
before the reference check runs; nothing on the CPU."""


def read(run):
    if run["kind"] != "serve" or not run["memory_peak_bytes"]:
        return None
    return run["memory_peak_bytes"] / 2 ** 20
