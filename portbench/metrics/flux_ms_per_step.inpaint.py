"""Device ms of FLUX (at CFG batch 2, both ControlNets' residuals injected)
per sampler step, in the profiled request: its ``flux`` spans summed, over
its ``steps`` counter."""

from portbench.metrics._inpaint import profiled_trace, span_ms


def read(record):
    trace = profiled_trace(record)
    if trace is None or not trace["counters"]["steps"]:
        return None
    return span_ms(trace, "flux") / trace["counters"]["steps"]
