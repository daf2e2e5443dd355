"""Clips captioned by requests that succeeded within the window, over the
window (host clock); read per layer, as the host's speed moves it more
than an end-to-end bound can hold."""


def read(run):
    if run["kind"] != "serve":
        return None
    return run["clips_in_window"] / run["window_s"]
