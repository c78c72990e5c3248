"""Host microseconds of an attention entry's own path per call: from entering
the entry to its return (the checks, allocations, casts), less its kernel's
launch call, where the host waits whenever the device's launch queue is full
(the entries' ``host_ns`` less ``launch_ns``, summed over their ``calls``),
in the traced requests that ran without the profiler; None where there are
none."""

from portbench.metrics._spans import unprofiled


def read(record):
    entries = [c for t in unprofiled(record) for c in t["counters"]["attention"].values()]
    calls = sum(c["calls"] for c in entries)
    own_ns = sum(c["host_ns"] - c["launch_ns"] for c in entries)
    return 1e-3 * own_ns / calls if calls else None
