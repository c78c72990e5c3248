"""Device milliseconds per sampler step of one kernel class, in the profiled
request's sampling loop (shared by the class readers)."""

from portbench.kernels import kernel_class
from portbench.trace import kernels


def ms_per_step(record, cls):
    traced = record.get("traced")
    if not traced or not traced["stages"].get("sample"):
        return None
    lo, hi = traced["stages"]["sample"][0]
    got = [e - s for n, s, e in kernels(traced["events"], (lo, hi)) if kernel_class(n) == cls]
    if not got:
        return None
    return 1e3 * sum(got) / traced["steps"]
