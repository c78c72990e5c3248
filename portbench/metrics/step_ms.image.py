"""Device ms of one sampler step: the mean of the program's ``step`` spans in
the traced requests that ran without the profiler; None where there are
none."""

from portbench.metrics._spans import device_ms, unprofiled


def read(record):
    got = device_ms(unprofiled(record), "step")
    return sum(got) / len(got) if got else None
