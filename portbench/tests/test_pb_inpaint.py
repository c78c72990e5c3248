"""The inpainting cell ``inpaint-1280x960-s20`` on the CPU at the port's tiny
geometry (float32): a traced run through ``harness.run`` whose readers read
the program, every fault of ``faults.py`` and ``faults_inpaint.py`` caught,
the fp8 control away from the reference, and the cell added as new files
only. On the card (``cuda``), at the cell's own size and one seed, the
program reads under the limit, and the control and each fault over it."""

import json
import os
import shutil
import time
from unittest import mock

import pytest
import torch

from portbench import check, control, faults, faults_inpaint, harness, manifest
from portbench.tests import test_pb_extend, tiny

CELL, CONFIG = "inpaint-1280x960-s20", "flux1-dev-reptext-inpaint"
READERS = ("sample_step_ms.inpaint", "controlnet_inpaint_ms_per_step.inpaint",
           "flux_ms_per_step.inpaint", "attn_roofline.inpaint", "mfu.inpaint",
           "outside_sample_s.inpaint", "gemm_ms_per_step.inpaint",
           "elementwise_ms_per_step.inpaint", "idle_share.inpaint")
# the readers of the device trace, which a CPU run has not
ON_THE_CARD = ("attn_roofline.inpaint", "gemm_ms_per_step.inpaint",
               "elementwise_ms_per_step.inpaint", "idle_share.inpaint")
ALL_FAULTS = {**faults.FAULTS, **faults_inpaint.FAULTS}
# what the cell added to the benchmark, beside its BENCHMARK.json entries
CELL_FILES = (
    "portbench/configs/flux1-dev-reptext-inpaint.json", f"portbench/traffic/{CELL}.json",
    f"portbench/workloads/{CELL}.json", "portbench/traffic/inpaint.py",
    "portbench/data/inpaint_1280x960.npz", "portbench/reference/inpaint.py",
    "portbench/reference/TOLERANCES_inpaint.md", "portbench/counts/inpaint.py",
    "portbench/faults_inpaint.py", "portbench/metrics/_inpaint.py",
    *(f"portbench/metrics/{m}.py" for m in READERS), "portbench/tests/test_pb_inpaint.py")


def tiny_spec(tmp_path, steps=2):
    """The cell at the tiny geometry; the inpainting net cut as the RepText
    net is, the mask's margin to the 64-pixel image."""
    spec = tiny.spec(CELL, str(tmp_path), steps=steps)
    spec["config"]["inpaint_controlnet"].update(tiny.CN)
    spec["traffic"]["mask_margin"] = 4
    return spec


def run_cell(spec, tmp_path, traced=False, seed=2_100_000_011):
    torch.set_num_threads(2)
    return harness.run(spec, seed, 0.01, traced, "cpu", time.perf_counter(), log=lambda m: None,
                       data_dir=str(tmp_path))


def test_a_traced_run_reads_the_inpaint_readers(tmp_path):
    """The window holds the profiled request alone; the readers of the
    program's spans and of the sample stage read it, and those of the device
    trace find nothing on the CPU, which has none."""
    spec = tiny_spec(tmp_path)
    result = run_cell(spec, tmp_path, traced=True)
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert not set(ON_THE_CARD) & set(got)
    assert all(got.get(name, 0.0) > 0.0 for name in READERS if name not in ON_THE_CARD), got
    # a step holds both nets and FLUX
    assert got["sample_step_ms.inpaint"] >= (got["controlnet_inpaint_ms_per_step.inpaint"]
                                             + got["flux_ms_per_step.inpaint"])
    assert result["correct"] and result["attempted"] == 1, result["checks"]


def test_the_inpaint_readers_are_the_image_readers_at_this_cell():
    """Five of the cell's readers are the ``.image`` readers under the cell's
    names: on one record they read the same."""
    record = {"requests": [{"wall_s": 12.0, "steps": 20, "timings": {"sample": 10.6}},
                           {"wall_s": 11.0, "steps": 20, "timings": {"sample": 10.5}}],
              "traced": {"window": (0.0, 12.0), "stages": {"sample": [(1.0, 11.6)]}, "steps": 20,
                         "launches": {"K1": 1700},
                         "events": [("nvjet_hsh_256x128_2x1_v_bz_coopA_NNT", True, 1.0, 6.0),
                                    ("vectorized_elementwise_kernel", True, 6.0, 7.0),
                                    ("attn_fwd_kernel<128, true, false, 1, false, false, false>",
                                     True, 7.0, 9.0)]},
              "attention": {"shape": [2, 24, 5312, 128]}}
    for name in ("sample_step_ms", "outside_sample_s", "gemm_ms_per_step",
                 "elementwise_ms_per_step", "idle_share", "attn_roofline"):
        want = manifest.reader(f"{name}.image")(record)
        assert want is not None and manifest.reader(f"{name}.inpaint")(record) == want, name


def test_the_roofline_reads_k1_at_the_cells_shape():
    """At (2, 24, 5312, 128), 85 K1 calls a step (57 FLUX, 14 + 14 ControlNet
    blocks) over 20 steps in 2 s of attention kernels: 0.70 ms of operations
    a call at the peak, 59.6 %."""
    from portbench.counts import attention

    b, h, s, d = 2, 24, 5312, 128
    events = [("portbench.request", False, 0.0, 30.0), ("portbench.sample", False, 1.0, 20.0)]
    events += [("attn_fwd_kernel<128, true, false, 1, false, false, false>", True, 2.0 + i / 2,
                2.0 + i / 2 + 0.1) for i in range(20)]
    record = {"traced": {"stages": {"sample": [(1.0, 20.0)]}, "events": events,
                         "launches": {"K1": 85 * 20, "K2": 0, "K3": 0}},
              "attention": {"shape": [b, h, s, d]}}
    want = 100.0 * 85 * 20 * attention.bound_s(b, h, s, d, tables=True)[0] / 2.0
    assert want == pytest.approx(59.6, abs=0.05)
    assert manifest.reader("attn_roofline.inpaint")(record) == pytest.approx(want)


def test_the_step_counts_both_nets_at_the_cells_shapes():
    """269 TFLOP a step: FLUX and the RepText net 222.7, the inpainting net 46.0."""
    from portbench.counts import inpaint, step

    cfg = manifest.resolve(CELL)["config"]
    s_img = (960 // 16) * (1280 // 16)
    net = cfg["inpaint_controlnet"]
    assert step.step_flop(cfg, 2, s_img, 512) == pytest.approx(222.70e12, rel=1e-4)
    assert inpaint.controlnet_flop(net, 2, s_img, 512) == pytest.approx(45.97e12, rel=1e-4)
    # the inpainting net differs from RepText's only in its condition embedder's width
    assert (step.model_flop(cfg["controlnet"], 2, s_img, 512, control=True)
            - inpaint.controlnet_flop(net, 2, s_img, 512)) == 2 * 2 * s_img * (128 - 68) * 3072


def test_the_driver_counts_the_inpainting_net_it_built(tmp_path):
    """``mfu.inpaint`` reads the inpainting net's FLOPs that the driver puts
    in a traced request's timings, counted from the net the pipeline holds:
    the configuration's net at the cell's size; a record without them reads
    nothing."""
    from portbench.counts import PEAK_BF16_FLOPS, inpaint
    from portbench.traffic import inpaint as driver

    cfg = manifest.resolve(CELL)["config"]
    pipe = mock.Mock()
    pipe.inpaint_controlnet.config = driver.inpaint_controlnet_config(cfg)
    pipe.pipe_cfg.image_seq_len, pipe.pipe_cfg.max_sequence_length = 60 * 80, 512
    flop = driver.controlnet_inpaint_flop(pipe)
    assert flop == inpaint.controlnet_flop(cfg["inpaint_controlnet"], 2, 60 * 80, 512)
    record = {"step_flop": 222.70e12, "requests": [
        {"steps": 20, "timings": {"sample": 10.0, "controlnet_inpaint_flop": flop}},
        {"steps": 20, "timings": {"sample": 11.0}}]}
    want = 100.0 * (222.70e12 + flop) * 20 / 10.0 / PEAK_BF16_FLOPS
    assert manifest.reader("mfu.inpaint")(record) == pytest.approx(want)
    record["requests"].pop(0)
    assert manifest.reader("mfu.inpaint")(record) is None


def test_the_span_readers_read_nothing_without_a_profiled_request():
    unprofiled = {"requests": [{"wall_s": 1.0, "steps": 2, "timings": {
        "sample": 0.5, "trace": {"profiled": False, "spans": [], "counters": {"steps": 2}}}}],
        "traced": {"window": (0.0, 1.0), "events": [], "stages": {}, "launches": {}, "steps": 2},
        "attention": {"shape": [2, 4, 48, 32]}, "step_flop": 1.0}
    for name in ("controlnet_inpaint_ms_per_step.inpaint", "flux_ms_per_step.inpaint"):
        assert manifest.reader(name)(unprofiled) is None, name
    # without the ``controlnet_inpaint_steps`` counter the reader counts the
    # net's spans; a request that ran no such span reads nothing
    spans = [{"name": "controlnet_inpaint", "device_ms": 3.0},
             {"name": "controlnet_inpaint", "device_ms": 5.0}]
    reader = manifest.reader("controlnet_inpaint_ms_per_step.inpaint")
    for counters, want in (({"steps": 2}, 4.0), ({"steps": 2, "controlnet_inpaint_steps": 2}, 4.0)):
        profiled = {"requests": [{"wall_s": 1.0, "steps": 2, "timings": {
            "sample": 0.5, "trace": {"profiled": True, "spans": spans, "counters": counters}}}]}
        assert reader(profiled) == want, counters
    profiled["requests"][0]["timings"]["trace"].update(spans=[], counters={"steps": 2})
    assert reader(profiled) is None


def test_a_pipeline_without_the_sampler_method_gets_one():
    """A program whose pipeline runs the loop inside ``_sample_inpaint``: the
    driver gives the instance ``_inpaint_sampler``, the traced run wraps it in
    the ``sample`` range, and the loop runs on the same arguments. A pipeline
    that has the method is left as it is."""
    from portbench import trace
    from portbench.traffic import inpaint as driver

    class LoopInside:
        def __call__(self, latents):
            return self._sample_inpaint(latents, "tokens", "masks", "cond", "ctx", "pooled",
                                        "schedule", 3.5, 2.0)

        def _sample_inpaint(self, *args):
            return args

    pipe = driver.sampler_route(LoopInside())
    trace.wrap_stages(pipe, (), driver.SAMPLER)
    with trace.profiled() as prof:
        out = pipe("latents")
    assert out == ("latents", "tokens", "masks", "cond", "ctx", "pooled", "schedule", 3.5, 2.0)
    assert len(trace.ranges(prof["events"], trace.stage_range("sample"))) == 1

    class LoopReturned(LoopInside):
        def _inpaint_sampler(self, *args):
            return lambda latents: (latents, *args)

    pipe = LoopReturned()
    assert driver.sampler_route(pipe) is pipe and not vars(pipe)


@pytest.mark.parametrize("fault", sorted(ALL_FAULTS))
def test_a_fault_is_caught(fault, tmp_path):
    spec = tiny_spec(tmp_path)
    with ALL_FAULTS[fault]():
        result = run_cell(spec, tmp_path)
    assert not result["correct"], result["checks"]


def test_the_fp8_control_lies_away_from_the_reference(tmp_path):
    torch.set_num_threads(2)
    spec = tiny_spec(tmp_path)
    out = control.readings(spec, 21, "cpu", data_dir=str(tmp_path), log=lambda m: None)
    got, low = out["tf32"]["program"], out["tf32"]["control"]
    assert got["off4_pct"] == 0.0 and got["image_mad"] < 0.05
    assert low["image_mad"] > 0.5


def test_the_cell_is_new_files_and_entries(tmp_path):
    """``test_pb_extend.py``'s rule, for this cell: in a copy of the benchmark
    without the cell's files and entries, putting them back adds exactly
    those files, changes no file but BENCHMARK.json, and leaves the older
    cell as it was."""
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    ours = {"configs": [c for c in bench["configs"] if c["name"] == CONFIG],
            "workloads": [w for w in bench["workloads"] if w["name"] == CELL],
            "per_layer": [m for m in bench["per_layer"] if m["name"] in READERS]}
    assert [len(v) for v in ours.values()] == [1, 1, len(READERS)]
    for key, entries in ours.items():
        bench[key] = [e for e in bench[key] if e not in entries]
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    for name in CELL_FILES:
        os.remove(tmp_path / name)
    before = test_pb_extend.digests(tmp_path)
    old = manifest.resolve("t2i-1024-s30", root=str(tmp_path), pkg=str(tmp_path / "portbench"))

    for name in CELL_FILES:
        shutil.copy(os.path.join(manifest.ROOT, name), tmp_path / name)
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    after = test_pb_extend.digests(tmp_path)
    assert {k for k in before if before[k] != after.get(k)} == {"BENCHMARK.json"}
    assert set(after) - set(before) == set(CELL_FILES)
    spec = manifest.resolve(CELL, root=str(tmp_path), pkg=str(tmp_path / "portbench"))
    assert [m["name"] for m in spec["per_layer"]] == list(READERS)
    assert manifest.resolve("t2i-1024-s30", root=str(tmp_path),
                            pkg=str(tmp_path / "portbench")) == old


@pytest.mark.cuda
def test_on_the_card_the_control_and_the_faults_fail_the_limits():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    spec = manifest.resolve(CELL)
    limits = spec["workload"]["limits"]
    with mock.patch.dict(faults.FAULTS, faults_inpaint.FAULTS):
        out = control.readings(spec, 2_100_000_001, "cuda:0", planted=tuple(ALL_FAULTS))
    assert check.verdict(out["tf32"]["program"], limits)
    assert not check.verdict(out["tf32"]["control"], limits)
    for name, numbers in out["tf32"]["faults"].items():
        assert not check.verdict(numbers, limits), name
