"""Share (%) of the attention kernels' time in the profiled request's
sampling loop that the least work of their calls needs: the sum over calls
of the larger of FLOP / 989 TFLOP/s and bytes / 3.35 TB/s
(``portbench.counts.attention``), each entry's calls from its launch counter
at the cell's attention shape, over the summed device time of the
attention-class kernels."""

from portbench.counts import attention
from portbench.kernels import ATTENTION, kernel_class
from portbench.trace import kernels


def read(record):
    traced = record.get("traced")
    if not traced or not traced["stages"].get("sample"):
        return None
    b, h, s, d = record["attention"]["shape"]
    calls = traced["launches"]
    bound = calls.get("K1", 0) * attention.bound_s(b, h, s, d, tables=True)[0] + (
        calls.get("K2", 0) + calls.get("K3", 0)) * attention.bound_s(b, h, s, d)[0]
    lo, hi = traced["stages"]["sample"][0]
    spent = sum(e - st for n, st, e in kernels(traced["events"], (lo, hi))
                if kernel_class(n) == ATTENTION)
    if not bound or not spent:
        return None
    return 100.0 * bound / spent
