"""Mean stream time of train/step.grad_step (forward and backward) a
step: the time between CUDA events recorded before and after the call in
a traced run (a span on the stream, idle gaps included; not device-busy
time)."""


def read(run):
    d = run.get("fwd_bwd_ms") or []
    return sum(d) / len(d) if d else None
