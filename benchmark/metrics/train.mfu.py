"""Forward and backward operations of the window's real clips (pbench/
flops.py) over the window, as a share of the card's peak for the
precision the products run at."""


def read(run):
    if run["kind"] != "train" or not run["trace_on"]:
        return None
    return 100.0 * run["model_flops"] / run["window_s"] / run["matmul_peak"]
