"""Milliseconds per sampler step: the ``sample`` stage (synchronised at its
ends) over its steps, all traced requests together."""


def read(record):
    reqs = [r for r in record["requests"] if "sample" in r["timings"]]
    steps = sum(r["steps"] for r in reqs)
    if not steps:
        return None
    return 1e3 * sum(r["timings"]["sample"] for r in reqs) / steps
