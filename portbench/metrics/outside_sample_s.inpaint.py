"""Seconds of a request outside the sampling loop (both prompts, the
condition and masked-image encodes, the decode): the reader of
``outside_sample_s.image`` at this cell."""

from portbench import manifest


def read(record):
    return manifest.reader("outside_sample_s.image")(record)
