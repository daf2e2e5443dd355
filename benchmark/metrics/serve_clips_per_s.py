"""Clips captioned by requests that succeeded within the window, over the
window (host clock)."""


def read(run):
    if run["kind"] != "serve":
        return None
    return run["clips_in_window"] / run["window_s"]
