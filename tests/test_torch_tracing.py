"""The port's request spans (``reptext_tpu_torch/utils/profiling.py``) on the
CPU at the tiny geometry: switched on by ``timings=`` alone, the tree of
stages, steps, model calls and attention calls that the pipelines record,
and their host bounds on ``torch.profiler``'s clock.

On the CPU the blocks take the plain attention; the tree tests route them
through the kernel entries (``ops.attention._kernels``), whose plain twins
then run, so that the entries' spans are counted as on the card.
"""

import dataclasses
import itertools
import time
import types

import numpy as np
import pytest
import torch

from reptext_tpu_torch.configs import (
    CLIPConfig, ControlNetConfig, FluxConfig, PipelineConfig, T5Config, VAEConfig,
)
from reptext_tpu_torch.ops import attention as attention_mod
from reptext_tpu_torch.pipelines.inpaint import FluxRepTextInpaintPipeline
from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline
from reptext_tpu_torch.utils import profiling

H = W = 64
STEPS, CN_STEPS = 3, 2
PIPE_CFG = PipelineConfig(height=H, width=W, num_inference_steps=STEPS,
                          controlnet_conditioning_step=CN_STEPS, true_guidance_scale=2.0)
IDS = dict(clip_ids=np.array([[3, 7, 255, 0, 0, 0, 0, 0]], np.int32),
           t5_ids=np.array([[5, 9, 11, 1, 0, 0, 0, 0]], np.int32))
NEG = dict(negative_clip_ids=np.array([[4, 8, 9, 255, 0, 0, 0, 0]], np.int32),
           negative_t5_ids=np.array([[6, 2, 1, 0, 0, 0, 0, 0]], np.int32))
STAGES = ("encode_prompt", "prepare", "sample", "decode")
ENTRIES = ("flash_attention_rope", "flash_attention", "plain_attention")


@pytest.fixture(scope="module")
def pipes():
    torch.manual_seed(0)
    pipe = FluxRepTextPipeline.create(
        FluxConfig().tiny(), ControlNetConfig().tiny(), VAEConfig().tiny(), PIPE_CFG,
        clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny(), device="cpu", seed=0)
    return pipe, FluxRepTextInpaintPipeline.from_pipeline(pipe, seed=7)


def conditions(shift=0):
    glyph = np.zeros((H, W, 3), np.uint8)
    glyph[20:32, 16 + shift:48] = 255
    canny = np.zeros((H, W, 3), np.uint8)
    canny[20, 16 + shift:48] = canny[31, 16 + shift:48] = 255
    pos = np.zeros((H, W), np.uint8)
    pos[18:34, 14:50] = 255
    line = types.SimpleNamespace(canny_image=canny, position_mask=pos, region_mask=pos.copy())
    return types.SimpleNamespace(lines=[line], glyph_canvas=glyph, num_lines=1)


def image_and_mask():
    image = np.random.default_rng(3).integers(0, 256, (H, W, 3)).astype(np.uint8)
    mask = np.zeros((H, W), np.uint8)
    mask[16:40, 12:52] = 255
    return image, mask


def request(pipes, kind, timings, **kw):
    """One request of ``kind`` with ``timings``; returns its images."""
    pipe, inpaint = pipes
    if kind == "txt2img":
        return pipe(conditions(), timings=timings, **IDS, **kw)
    if kind == "batch":
        ids = {k: np.concatenate([v, v]) for k, v in IDS.items()}
        return pipe.generate_batch([conditions(), conditions(4)], seeds=[1, 2], timings=timings,
                                   **ids, **kw)
    image, mask = image_and_mask()
    if kind == "inpaint":
        return inpaint(conditions(), image=image, mask=mask, timings=timings, **IDS, **NEG, **kw)
    ids = {k: np.concatenate([v, v]) for k, v in {**IDS, **NEG}.items()}
    return inpaint.generate_batch([conditions(), conditions(4)], [image, image], [mask, mask],
                                  seeds=[1, 2], timings=timings, **ids, **kw)


def entry_calls(monkeypatch):
    """Route the blocks' attention through the kernel entries (their plain
    twins on the CPU) and count the entries' calls."""
    calls = {}

    def counted(name):
        fn = getattr(attention_mod, name)

        def call(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(attention_mod, "_kernels", lambda q, backend: True)
    for name in ENTRIES:
        monkeypatch.setattr(attention_mod, name, counted(name))
    return calls


def test_no_timings_records_nothing(pipes, monkeypatch):
    """``timings=None``: no recorder in the thread during the call, no CUDA
    event made and no profiler range entered, even under a profiler."""
    def refuse(*a, **k):
        raise AssertionError("made while tracing is off")

    seen = []
    entry_calls(monkeypatch)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        monkeypatch.setattr(torch.profiler, "record_function", refuse)
        out = request(pipes, "txt2img", None,
                      callback=lambda i, lat: seen.append(profiling.active_recorder()))
    assert out.shape == (1, H, W, 3)
    assert seen == [None] * STEPS and profiling.active_recorder() is None


@pytest.mark.parametrize("kind", ["txt2img", "batch", "inpaint", "inpaint_batch"])
def test_a_traced_request_has_the_span_tree(pipes, monkeypatch, kind):
    calls = entry_calls(monkeypatch)
    timings = {}
    request(pipes, kind, timings)
    assert profiling.active_recorder() is None
    assert set(timings) == {*STAGES, "trace"}
    assert all(isinstance(timings[k], float) for k in STAGES)
    trace = timings["trace"]
    spans, counters = trace["spans"], trace["counters"]
    assert trace["profiled"] is False
    names = [s["name"] for s in spans]

    root = [i for i, s in enumerate(spans) if s["parent"] == -1]
    assert root == [0] and names[0] == "request"
    assert [s["name"] for s in spans if s["parent"] == 0] == list(STAGES)
    sample = names.index("sample")
    steps = [i for i, n in enumerate(names) if n == "step"]
    assert len(steps) == counters["steps"] == STEPS
    assert all(spans[i]["parent"] == sample for i in steps)

    def under_steps(name):
        return [steps.index(s["parent"]) for s in spans if s["name"] == name]

    assert under_steps("controlnet") == list(range(CN_STEPS))
    assert counters["controlnet_steps"] == CN_STEPS
    assert under_steps("flux") == list(range(STEPS))
    assert counters["velocity_cache_skips"] == 0
    inpainting = kind.startswith("inpaint")
    assert under_steps("controlnet_inpaint") == (list(range(STEPS)) if inpainting else [])
    assert counters["controlnet_inpaint_steps"] == (STEPS if inpainting else 0)
    # the masked-image encode of each request, inside ``prepare``
    encodes = [names[s["parent"]] for s in spans if s["name"] == "inpaint_cond"]
    assert encodes == ["prepare"] * {"inpaint": 1, "inpaint_batch": 2}.get(kind, 0)

    attn = [s for s in spans if s["name"] == "attention"]
    assert sum(calls.values()) == len(attn) > 0
    for name in ENTRIES:
        got = [s for s in attn if s["entry"] == name]
        assert len(got) == calls.get(name, 0)
        if got:
            # the plain twins launch no kernel
            assert counters["attention"][name] == {
                "calls": len(got), "host_ns": sum(s["end_ns"] - s["start_ns"] for s in got),
                "launch_ns": 0}
    models = {"controlnet", "flux", "controlnet_inpaint"}
    assert all(names[s["parent"]] in models for s in attn)

    for s in spans[1:]:
        p = spans[s["parent"]]
        assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"], (s, p)
        # the CPU runs ops synchronously: device ms is the host duration
        assert s["device_ms"] == pytest.approx((s["end_ns"] - s["start_ns"]) * 1e-6)


def test_skipped_steps_are_counted(pipes, monkeypatch):
    """A step the velocity cache skips runs no model: a ``step`` span without
    a ``flux`` span, counted in ``velocity_cache_skips``."""
    pipe, _ = pipes
    monkeypatch.setattr(pipe, "pipe_cfg", dataclasses.replace(
        PIPE_CFG, num_inference_steps=5, velocity_cache_interval=2, velocity_cache_warmup=1))
    timings = {}
    request(pipes, "txt2img", timings, output_type="latent")
    assert set(timings) == {"encode_prompt", "prepare", "sample", "trace"}
    counters = timings["trace"]["counters"]
    names = [s["name"] for s in timings["trace"]["spans"]]
    # warmup 1, interval 2, the last step forced: steps 0, 1, 3, 4 run, 2 skips
    assert counters["steps"] == 5 and names.count("flux") == 4
    assert counters["velocity_cache_skips"] == 1


def test_spans_share_the_profilers_clock(pipes, monkeypatch):
    """Under ``torch.profiler`` the spans' host bounds and the profiler's
    events are on one clock. FLUX's forward begins with an op that nothing
    else runs (``aten::acosh``): each of its events lies inside its ``flux``
    span (each bound at most 0.1 ms on the wrong side), and one begins within
    0.1 ms of its span's start (a loaded host that deschedules the thread
    moves an event later only). The first request warms the profiler."""
    flux, one = pipes[0].flux, torch.ones(())
    forward = flux.forward

    def probed(*a, **k):
        torch.acosh(one)
        return forward(*a, **k)

    monkeypatch.setattr(flux, "forward", probed)
    timings = {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        request(pipes, "txt2img", {})
        request(pipes, "txt2img", timings)
    assert timings["trace"]["profiled"] is True
    spans = [(s["start_ns"], s["end_ns"]) for s in timings["trace"]["spans"]
             if s["name"] == "flux"]
    probes = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events() if e.name() == "aten::acosh")
    probes = probes[-STEPS:]                      # the second request's
    assert len(spans) == len(probes) == STEPS
    for (start, end), (a, b) in zip(spans, probes):
        assert a - start >= -100_000 and end - b >= -100_000, (a - start, end - b)
    assert min(a - start for (start, _), (a, _) in zip(spans, probes)) <= 100_000


def test_a_request_that_raises_leaves_no_recorder(pipes):
    _, inpaint = pipes
    image, mask = image_and_mask()
    timings = {}
    with pytest.raises(ValueError, match="negative"):
        inpaint(conditions(), image=image, mask=mask, timings=timings, **IDS)
    assert profiling.active_recorder() is None and "trace" not in timings


def test_a_recorder_alone_is_a_stage_clock():
    """``SpanRecorder`` without a request: stage seconds into its dict, no
    recorder installed for the thread."""
    stages = {}
    clock = profiling.SpanRecorder(stages, "cpu")
    with clock.stage("setup"):
        assert profiling.active_recorder() is None
    with clock.stage("run"):
        pass
    assert list(stages) == ["setup", "run"] and all(v >= 0.0 for v in stages.values())


def test_a_launch_call_is_timed_inside_its_attention_span():
    """``time_launch`` adds its call's host ns to the entry's ``attention``
    span, and the counters sum them beside the entry's ``host_ns``; with no
    recorder it only calls."""
    @profiling.span_calls("attention")
    def entry(seconds):
        time.sleep(1e-3)
        return profiling.time_launch(time.sleep, seconds)

    timings = {}
    with profiling.request_trace(timings, "cpu"):
        entry(2e-3)
        entry(1e-3)
    spans = [s for s in timings["trace"]["spans"] if s["name"] == "attention"]
    assert [s["entry"] for s in spans] == ["entry", "entry"]
    assert all(1e6 <= s["launch_ns"] <= s["end_ns"] - s["start_ns"] - 1e6 for s in spans)
    c = timings["trace"]["counters"]["attention"]["entry"]
    assert c == {"calls": 2, "host_ns": sum(s["end_ns"] - s["start_ns"] for s in spans),
                 "launch_ns": sum(s["launch_ns"] for s in spans)}
    assert c["launch_ns"] >= 3e6
    assert profiling.time_launch(lambda x: x + 1, 1) == 2


def test_stage_seconds_are_on_the_perf_counter(monkeypatch):
    """A stage's seconds in ``timings`` come from ``time.perf_counter``, the
    harness's clock; the spans' host bounds from ``time.time_ns``, the
    profiler's."""
    clock = types.SimpleNamespace(time_ns=itertools.count(0, 10**9).__next__,
                                  perf_counter=iter([100.0, 102.5]).__next__)
    monkeypatch.setattr(profiling, "time", clock)
    stages = {}
    with profiling.SpanRecorder(stages, "cpu").stage("decode"):
        pass
    assert stages == {"decode": 2.5}
