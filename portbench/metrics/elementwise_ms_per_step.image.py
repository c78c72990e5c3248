"""Device ms per sampler step in everything that is neither a GEMM nor an
attention kernel: the fp32 norms and modulation, casts, copies, the RoPE
rotation of the streaming route, the residual adds and the Euler update."""

from portbench.kernels import ELEMENTWISE
from portbench.metrics._classes import ms_per_step


def read(record):
    return ms_per_step(record, ELEMENTWISE)
