"""Device ms per sampler step in everything that is neither a GEMM nor an
attention kernel, at CFG batch 2: the reader of ``elementwise_ms_per_step.image``
at this cell."""

from portbench import manifest


def read(record):
    return manifest.reader("elementwise_ms_per_step.image")(record)
