"""Share (%) of the profiled request in which no kernel runs on the device:
the reader of ``idle_share.image`` at this cell."""

from portbench import manifest


def read(record):
    return manifest.reader("idle_share.image")(record)
