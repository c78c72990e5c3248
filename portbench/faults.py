"""Faults planted under the timed path: each has to make ``correct`` false.

Each is a context manager that patches the port's code while it is open: an
Euler step that returns its state unchanged, the answer altered where it is
produced (the uint8 image mirrored), and the ControlNet residuals dropped.
The cell runs one row on one chip, so there is no half batch and no
exchange between chips to leave out. The benchmark's runs never plant them:
``tests/test_pb_faults.py`` does on the CPU and ``control.py --faults`` on
the card, at the cell's own size.
"""

from __future__ import annotations

import contextlib
from unittest import mock


@contextlib.contextmanager
def frozen_step():
    from reptext_tpu_torch.sampling import flow_match

    with mock.patch.object(flow_match.FlowMatchSchedule, "step",
                           lambda self, lat, v, i: lat.float()):
        yield


@contextlib.contextmanager
def altered_answer():
    from reptext_tpu_torch.pipelines import txt2img

    post = txt2img.postprocess_images
    with mock.patch.object(txt2img, "postprocess_images", lambda x: post(x)[:, :, ::-1]):
        yield


@contextlib.contextmanager
def no_controlnet():
    from reptext_tpu_torch.models import controlnet

    forward = controlnet.RepTextControlNet.forward

    def zero(self, *a, **k):
        blocks, singles = forward(self, *a, **k)
        return blocks * 0, singles * 0

    with mock.patch.object(controlnet.RepTextControlNet, "forward", zero):
        yield


FAULTS = {"frozen_step": frozen_step, "altered_answer": altered_answer,
          "no_controlnet": no_controlnet}
