"""Milliseconds per sampler step of the true-CFG dual-ControlNet loop: the
reader of ``sample_step_ms.image``, which reads the ``sample`` stage of every
traced request, at this cell."""

from portbench import manifest


def read(record):
    return manifest.reader("sample_step_ms.image")(record)
