"""Device ms per sampler step in GEMMs, every product at CFG batch 2: the
reader of ``gemm_ms_per_step.image`` at this cell."""

from portbench import manifest


def read(record):
    return manifest.reader("gemm_ms_per_step.image")(record)
