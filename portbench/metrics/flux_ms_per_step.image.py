"""Device ms of FLUX (the ControlNet's residuals injected) per sampler step:
the program's ``flux`` spans summed, over its ``steps`` counter, in the
traced requests that ran without the profiler; None where there are
none."""

from portbench.metrics._spans import counter, device_ms, unprofiled


def read(record):
    traces = unprofiled(record)
    got = device_ms(traces, "flux")
    return sum(got) / counter(traces, "steps") if got else None
