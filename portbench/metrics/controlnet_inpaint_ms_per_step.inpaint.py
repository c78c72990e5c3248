"""Device ms of the inpainting ControlNet (at CFG batch 2) per step that runs
it, in the profiled request: its ``controlnet_inpaint`` spans summed, over
the ``controlnet_inpaint_steps`` counter, or over the number of those spans
where the program has no such counter (the counter counts them); None where
the request ran no such span."""

from portbench.metrics._inpaint import profiled_trace, span_ms


def read(record):
    trace = profiled_trace(record)
    if trace is None:
        return None
    steps = trace["counters"].get(
        "controlnet_inpaint_steps",
        sum(s["name"] == "controlnet_inpaint" for s in trace["spans"]))
    if not steps:
        return None
    return span_ms(trace, "controlnet_inpaint") / steps
