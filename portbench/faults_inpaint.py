"""Faults of true CFG and of the inpainting ControlNet, planted under the
timed path of an inpainting cell: each has to make ``correct`` false.

Each is a context manager that wraps, while it is open, the models that the
inpaint pipeline hands its sampler (``pipelines/inpaint.py`` builds it with
``make_inpaint_sampler``): FLUX's velocity for the negative rows replaced by
the positive rows', so the guided velocity is the conditional one alone (the
unconditional half dropped); the inpainting ControlNet's residuals zeroed;
and the RepText ControlNet's residuals zeroed, the net that draws the line.
``faults.py``'s faults act on this path too: its ``no_controlnet`` zeroes
both ControlNets, which are of one class. ``tests/test_pb_inpaint.py``
plants them on the CPU and, on the card, at the cell's size; the readings of
many seeds:

    python3 -m portbench.faults_inpaint --workload <cell> --seeds 1,2,3

which is ``control.py --faults`` with these faults planted beside
``faults.py``'s.
"""

from __future__ import annotations

import contextlib
import sys
from unittest import mock


@contextlib.contextmanager
def _sampler_models(wrap):
    """``make_inpaint_sampler`` given ``wrap(flux, reptext_net, inpaint_net)``'s models."""
    from reptext_tpu_torch.pipelines import inpaint

    make = inpaint.make_inpaint_sampler

    def patched(flux, reptext_net, inpaint_net, *a, **k):
        return make(*wrap(flux, reptext_net, inpaint_net), *a, **k)

    with mock.patch.object(inpaint, "make_inpaint_sampler", patched):
        yield


def no_uncond():
    import torch

    def wrap(flux, reptext_net, inpaint_net):
        def conditional_only(*a, **k):
            v = flux(*a, **k)
            half = v.shape[0] // 2
            return torch.cat([v[half:], v[half:]])
        return conditional_only, reptext_net, inpaint_net

    return _sampler_models(wrap)


def no_inpaint_controlnet():
    def wrap(flux, reptext_net, inpaint_net):
        def zero(*a, **k):
            blocks, singles = inpaint_net(*a, **k)
            return blocks * 0, singles * 0
        return flux, reptext_net, zero

    return _sampler_models(wrap)


def no_reptext_controlnet():
    def wrap(flux, reptext_net, inpaint_net):
        def zero(*a, **k):
            blocks, singles = reptext_net(*a, **k)
            return blocks * 0, singles * 0
        return flux, zero, inpaint_net

    return _sampler_models(wrap)


FAULTS = {"no_uncond": no_uncond, "no_inpaint_controlnet": no_inpaint_controlnet,
          "no_reptext_controlnet": no_reptext_controlnet}


def main(argv=None) -> int:
    from portbench import control, faults

    with mock.patch.dict(faults.FAULTS, FAULTS):
        return control.main([*(sys.argv[1:] if argv is None else argv), "--faults"])


if __name__ == "__main__":
    sys.exit(main())
