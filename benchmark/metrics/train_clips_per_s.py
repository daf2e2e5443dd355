"""Real (unpadded) clips trained by the window's steps, over the window
(host clock, ended by a device synchronize)."""


def read(run):
    if run["kind"] != "train":
        return None
    return run["clips_in_window"] / run["window_s"]
