"""The harness's check on the CPU at the port's tiny geometry (float32), with
the chip look skipped: a sound run is correct, and each fault that the cell
can have (``portbench/faults.py``), planted in the program under the timed
path, makes ``correct`` false."""

import time

import pytest
import torch

from portbench import faults, harness
from portbench.tests import tiny

CELL = "t2i-1024-s30"


def run_cell(tmp_path, seed=11):
    torch.set_num_threads(2)
    spec = tiny.spec(CELL, str(tmp_path))
    return harness.run(spec, seed, 0.01, False, "cpu", time.perf_counter(), log=lambda m: None,
                       data_dir=str(tmp_path))


def test_a_sound_run_is_correct(tmp_path):
    result = run_cell(tmp_path)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_fault_is_caught(fault, tmp_path):
    with faults.FAULTS[fault]():
        result = run_cell(tmp_path)
    assert not result["correct"], result["checks"]


def test_a_failing_request_is_counted(tmp_path, monkeypatch):
    from reptext_tpu_torch.pipelines import txt2img

    decode, calls = txt2img.FluxRepTextPipeline.decode, []

    def boom(self, *a, **k):          # the warm-up's decode passes, the window's fail
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("planted")
        return decode(self, *a, **k)

    monkeypatch.setattr(txt2img.FluxRepTextPipeline, "decode", boom)
    result = run_cell(tmp_path)
    assert not result["correct"] and result["failed"] == result["attempted"] >= 1
    assert result["checks"]["off4_pct"]["value"] == 100.0


def test_a_traced_run_fails_where_a_listed_metric_reads_nothing(tmp_path, monkeypatch):
    from portbench import manifest

    monkeypatch.setattr(manifest, "reader", lambda name, pkg=None: lambda record: None)
    torch.set_num_threads(2)
    spec = tiny.spec(CELL, str(tmp_path), steps=1)
    with pytest.raises(RuntimeError, match="found nothing to read"):
        harness.run(spec, 5, 0.01, True, "cpu", time.perf_counter(), log=lambda m: None,
                    data_dir=str(tmp_path))


def test_a_stage_the_pipeline_lacks_is_an_error():
    from portbench import trace

    class Pipeline:
        def decode(self):
            return None

    with pytest.raises(AttributeError, match="encode_prompt"):
        trace.wrap_stages(Pipeline(), ("decode", "encode_prompt"), "_sampler")
