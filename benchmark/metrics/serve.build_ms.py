"""Mean host time of CaptionService.build_batch (the packed batch and the
native feature fill) a batch, from the harness's span in a traced run."""


def read(run):
    d = run.get("spans", {}).get("build") or []
    return 1e3 * sum(d) / len(d) if d and run["trace_on"] else None
