"""Mean host time the step loop waits for its next batch (the prefetch
thread's packed build and copy), a step, in a traced run."""


def read(run):
    d = run.get("input_wait_s") or []
    if run["kind"] != "train" or not run["trace_on"] or not d:
        return None
    return 1e3 * sum(d) / len(d)
