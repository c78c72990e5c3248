"""Device ms per sampler step in GEMMs (cuBLAS and CUTLASS kernels behind the
bf16 linears of FLUX and the ControlNets)."""

from portbench.kernels import GEMM
from portbench.metrics._classes import ms_per_step


def read(record):
    return ms_per_step(record, GEMM)
