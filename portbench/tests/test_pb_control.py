"""The control of the check: the program's own fp8 weight-only path in its
place has to come out as not correct.

On the CPU at the tiny geometry the program (float32) matches the reference
and the fp8 control lies well away from it. On the card (``cuda``), at the
cell's own size and one seed, the program reads under each limit, and the
control and each planted fault over one of them: ``python -m pytest
portbench/tests -m cuda``."""

import pytest
import torch

from portbench import check, control, faults, manifest
from portbench.tests import tiny

CELL = "t2i-1024-s30"


def test_the_fp8_control_lies_away_from_the_reference(tmp_path):
    torch.set_num_threads(2)
    spec = tiny.spec(CELL, str(tmp_path))
    out = control.readings(spec, 21, "cpu", data_dir=str(tmp_path), log=lambda m: None)
    got, low = out["tf32"]["program"], out["tf32"]["control"]
    assert got["off4_pct"] == 0.0 and got["image_mad"] < 0.05
    assert low["image_mad"] > 0.5


@pytest.mark.cuda
def test_on_the_card_the_control_and_the_faults_fail_the_limits():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    spec = manifest.resolve(CELL)
    limits = spec["workload"]["limits"]
    out = control.readings(spec, 6000000001, "cuda:0", planted=tuple(faults.FAULTS))
    assert check.verdict(out["tf32"]["program"], limits)
    assert not check.verdict(out["tf32"]["control"], limits)
    for name, numbers in out["tf32"]["faults"].items():
        assert not check.verdict(numbers, limits), name
