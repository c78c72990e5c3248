"""Share (%) of the attention kernels' time in the profiled request's
sampling loop that the least work of their calls needs, at this cell's
attention shape: K1 at (2, 24, 5312, 128), true CFG's two rows. The count of
``attn_roofline.image``, whose reader reads it."""

from portbench import manifest


def read(record):
    return manifest.reader("attn_roofline.image")(record)
