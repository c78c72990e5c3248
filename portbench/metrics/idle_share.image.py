"""Share (%) of the profiled request (its host range, from the call to the
uint8 images on the host) in which no kernel runs on the device: one minus
the union of kernel intervals over the window."""

from portbench.trace import busy_seconds, kernels


def read(record):
    traced = record.get("traced")
    if not traced:
        return None
    lo, hi = traced["window"]
    kern = kernels(traced["events"], (lo, hi))
    if not kern or hi <= lo:
        return None
    return 100.0 * (1.0 - busy_seconds(kern, (lo, hi)) / (hi - lo))
