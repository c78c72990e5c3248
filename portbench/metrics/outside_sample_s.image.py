"""Seconds of a request outside the sampling loop: tokenising, the prompt
encoders, the condition and glyph encodes, the decode and the host copy
(the request's wall time minus its ``sample`` stage), over the traced
requests."""


def read(record):
    reqs = [r for r in record["requests"] if "sample" in r["timings"]]
    if not reqs:
        return None
    return sum(r["wall_s"] - r["timings"]["sample"] for r in reqs) / len(reqs)
