"""Mean stream time of train/step.apply_step (global clip, BertAdam, EMA)
a step: the time between CUDA events recorded before and after the call
in a traced run (a span on the stream, idle gaps included; not
device-busy time)."""


def read(run):
    d = run.get("optimizer_ms") or []
    return sum(d) / len(d) if d else None
