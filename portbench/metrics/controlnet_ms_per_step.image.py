"""Device ms of the RepText ControlNet per step that runs it: the program's
``controlnet`` spans summed, over its ``controlnet_steps`` counter, in the
traced requests that ran without the profiler; None where there are
none."""

from portbench.metrics._spans import counter, device_ms, unprofiled


def read(record):
    traces = unprofiled(record)
    got = device_ms(traces, "controlnet")
    return sum(got) / counter(traces, "controlnet_steps") if got else None
