"""The served step's model operations (encode and the greedy decode of
every clip of the requests done in the window, counted from shapes by
pbench/flops.py) over the window, as a share of the card's peak for the
precision the products run at."""


def read(run):
    if run["kind"] != "serve" or not run["trace_on"]:
        return None
    return 100.0 * run["model_flops"] / run["window_s"] / run["matmul_peak"]
