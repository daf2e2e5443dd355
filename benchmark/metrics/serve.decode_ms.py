"""Mean time of greedy_decode (encode and the cached steps) a batch, from
the harness's span ended by torch.cuda.synchronize() in a traced run."""


def read(run):
    d = run.get("spans", {}).get("decode") or []
    return 1e3 * sum(d) / len(d) if d and run["trace_on"] else None
