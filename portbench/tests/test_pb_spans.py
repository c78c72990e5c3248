"""The readers of the program's own spans and counters (``metrics/_spans.py``
and the six readers over it) on synthetic records: the requests that ran
without the profiler are read, and nothing where every request ran under it
or the program wrote no spans; then in traced CPU runs of ``harness.run``
with the six readers listed, which read them on the program."""

import copy
import importlib.util
import itertools
import os
import time

import pytest
import torch

from portbench import harness, manifest, window
from portbench.tests import tiny

SPAN_METRICS = ("step_ms.image", "controlnet_ms_per_step.image", "flux_ms_per_step.image",
                "attn_call_ms.image", "attn_host_us_per_call.image")


def span(name, parent, start_ms, end_ms, device_ms, **attrs):
    return dict(name=name, parent=parent, start_ns=int(1e6 * start_ms), end_ns=int(1e6 * end_ms),
                device_ms=device_ms, **attrs)


def make_trace(profiled, scale=1.0, t0=1_000_000.0):
    """One request of two steps, the RepText net on the first only; every
    device ms times ``scale``. Host times in ms from ``t0``."""
    s = scale
    spans = [span("request", -1, t0, t0 + 100, 100 * s),
             span("sample", 0, t0 + 10, t0 + 90, 80 * s),
             span("step", 1, t0 + 10, t0 + 50, 40 * s),
             span("controlnet", 2, t0 + 11, t0 + 20, 9 * s),
             span("attention", 3, t0 + 12, t0 + 13, 1 * s, entry="flash_attention_rope"),
             span("flux", 2, t0 + 21, t0 + 48, 27 * s),
             span("attention", 5, t0 + 22, t0 + 23, 3 * s, entry="flash_attention_rope"),
             span("step", 1, t0 + 50, t0 + 90, 20 * s),
             span("flux", 7, t0 + 51, t0 + 88, 17 * s),
             span("attention", 8, t0 + 52, t0 + 53, 2 * s, entry="flash_attention_rope")]
    counters = {"steps": 2, "controlnet_steps": 1, "velocity_cache_skips": 0,
                "attention": {"flash_attention_rope": {"calls": 3, "host_ns": int(60e3 * s),
                                                       "launch_ns": int(30e3 * s)}}}
    return {"profiled": profiled, "spans": spans, "counters": counters}


def record(*traces, events=(), window=(0.0, 0.0)):
    return {"requests": [{"wall_s": 1.0, "timings": {"sample": 0.08, "trace": t}, "steps": 2}
                         for t in traces],
            "traced": {"window": window, "events": list(events), "stages": {},
                       "launches": {}, "steps": 2}}


# each reader on the unscaled request: mean step (40 + 20) / 2, the net 9 over
# 1 step, FLUX (27 + 17) / 2, attention (1 + 3 + 2) / 3, host (60 - 30) us / 3
WANT = {"step_ms.image": 30.0, "controlnet_ms_per_step.image": 9.0,
        "flux_ms_per_step.image": 22.0, "attn_call_ms.image": 2.0,
        "attn_host_us_per_call.image": 10.0}


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_a_reader_reads_the_requests_without_the_profiler(metric):
    read = manifest.reader(metric)
    got = read(record(make_trace(True, scale=5.0), make_trace(False), make_trace(False)))
    assert got == pytest.approx(WANT[metric])


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_a_reader_reads_nothing_where_every_request_was_profiled(metric):
    assert manifest.reader(metric)(record(make_trace(True, scale=5.0))) is None


@pytest.mark.parametrize("metric", (*SPAN_METRICS, "step_idle_ms.image"))
def test_a_reader_finds_nothing_without_spans(metric):
    read = manifest.reader(metric)
    assert read({"requests": [{"wall_s": 1.0, "timings": {"sample": 0.08}, "steps": 2}],
                 "traced": {"window": (0.0, 1.0), "events": [("k", True, 0.1, 0.2)],
                            "stages": {}, "launches": {}, "steps": 2}}) is None
    assert read({"requests": [{"wall_s": 1.0, "timings": {}, "steps": 2}]}) is None


def idle_record():
    """The profiled request on the host from 1000 s (its spans as in
    make_trace) and kernels that leave five gaps, each beginning in another
    span (the test below names them)."""
    t0 = 1000.0          # s; spans in ms from 1e6 ms
    ms = 1e-3
    kern = [(t0 - 5 * ms, t0 + 15 * ms), (t0 + 19 * ms, t0 + 48.5 * ms),
            (t0 + 51.5 * ms, t0 + 52.5 * ms), (t0 + 54.5 * ms, t0 + 84 * ms)]
    events = [("k", True, s, e) for s, e in kern]
    window = (t0 - 10 * ms, t0 + 90 * ms)
    return record(make_trace(True), events=events, window=window)


def test_step_idle_ms_labels_gaps_by_the_innermost_span():
    spec = importlib.util.spec_from_file_location(
        "step_idle", os.path.join(manifest.PKG, "metrics", "step_idle_ms.image.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rec = idle_record()
    split = mod.gaps_by_span(rec)
    # gaps: [t0-10, t0-5] outside; [t0+15, t0+19] in controlnet (t0+11..20);
    # [t0+48.5, t0+51.5] in the first step (FLUX ended at 48); [t0+52.5,
    # t0+54.5] in the attention call t0+52..53; [t0+84, t0+90] in flux (51..88)
    assert split == pytest.approx({"outside": 5e-3, "controlnet": 4e-3, "step": 3e-3,
                                   "attention": 2e-3, "flux": 6e-3})
    assert mod.read(rec) == pytest.approx((4 + 3 + 2 + 6) / 2)


def traced_run(tmp_path, requests):
    """A traced CPU run of the cell at the tiny geometry with the six span
    readers listed, its window ``requests`` long (the first one profiled)."""
    torch.set_num_threads(2)
    spec = tiny.spec("t2i-1024-s30", str(tmp_path), steps=2)
    listed = spec["per_layer"][0]
    spec["per_layer"] += [dict(copy.deepcopy(listed), name=name, source=(
        "program_counter" if name.startswith("attn_host") else "program_span"))
        for name in SPAN_METRICS]
    spec["per_layer"].append(dict(copy.deepcopy(listed), name="step_idle_ms.image",
                                  source="device_trace"))
    # a clock that ticks once a read: the window holds ``requests`` requests
    clock = itertools.count().__next__
    seconds = 3 * requests - 1
    run = window.run
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(window, "run", lambda s, one: run(seconds, one, clock=clock))
        return harness.run(spec, 2_000_000_017, 0.01, True, "cpu", time.perf_counter(),
                           log=lambda m: None, data_dir=str(tmp_path))


def test_a_traced_run_reads_the_span_readers_on_the_program(tmp_path):
    """Two traced requests, the second without the profiler: the five span
    readers read it (the device's needs a device trace, which a CPU run
    lacks), beside the cell's own metrics, and the run is correct."""
    result = traced_run(tmp_path, 2)
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert all(got[name] > 0.0 for name in SPAN_METRICS), got
    assert "step_idle_ms.image" not in got
    # a step holds its ControlNet and FLUX calls (the net runs on both steps)
    assert got["step_ms.image"] >= (got["controlnet_ms_per_step.image"]
                                    + got["flux_ms_per_step.image"])
    assert result["correct"], result["checks"]


def test_a_traced_window_of_the_profiled_request_alone_reads_nothing(tmp_path):
    """One traced request, under the profiler: the span readers read nothing,
    so a run that lists them ends with the harness's error."""
    with pytest.raises(RuntimeError, match="found nothing to read") as err:
        traced_run(tmp_path, 1)
    assert all(name in str(err.value) for name in SPAN_METRICS)
