"""Share of the window's served batches whose greedy decode replayed a
CUDA graph, from ``/v1/stats`` (``decode_graph_batches`` over
``batches``); None where the program does not count them."""


def read(run):
    stats = run.get("stats") or {}
    if "decode_graph_batches" not in stats or not stats.get("batches"):
        return None
    return 100.0 * stats["decode_graph_batches"] / stats["batches"]
