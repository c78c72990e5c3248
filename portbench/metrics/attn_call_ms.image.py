"""Device ms of one attention call, the mean of the program's ``attention``
spans (one per call of an attention entry: K1 at this cell's length) in the
traced requests that ran without the profiler; None where there are
none."""

from portbench.metrics._spans import device_ms, unprofiled


def read(record):
    got = device_ms(unprofiled(record), "attention")
    return sum(got) / len(got) if got else None
