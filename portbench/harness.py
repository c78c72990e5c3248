"""One run of one cell: set-up, warm-up, the measured window, the traced
record, then the check against the plain reference.

:func:`run` takes the device it is given and looks for no chip: ``run.py``
does that before it calls it, and the benchmark's own tests drive it on the
CPU at a tiny geometry.
"""

from __future__ import annotations

import contextlib
import sys
import time
import traceback
from typing import Callable, Dict, Optional

import numpy as np
import torch

from portbench import check, manifest, program, trace, window
from portbench.counts import step as step_counts

FORBIDDEN = ("jax", "jaxlib", "flax", "reptext_tpu")
GIB = 2 ** 30


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: ``reptext_tpu_torch`` is not ``reptext_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def checked_index(seed: int, completed: int) -> int:
    """The request of the window that the reference checks, drawn from the seed."""
    return int(np.random.default_rng([int(seed), 7]).integers(completed))


def attention_shape(cfg: dict, mix: dict, request: dict) -> list:
    """(rows, heads, joint tokens, head dim) of every attention call of a
    step; the mix states its rows (2 under true CFG)."""
    f = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    s_img = (request["height"] // f // 2) * (request["width"] // f // 2)
    fl = cfg["flux"]
    return [mix["rows"], fl["num_attention_heads"], s_img + cfg["pipeline"]["max_sequence_length"],
            fl["attention_head_dim"]]


def run(spec: dict, seed: int, seconds: float, traced: bool, device, t_start: float,
        log: Callable[[str], None] = lambda m: print(m, file=sys.stderr, flush=True),
        data_dir: Optional[str] = None) -> dict:
    """The result of one run (``run.py`` prints it as the last line)."""
    cfg, mix, work = spec["config"], spec["traffic"], spec["workload"]
    driver = manifest.driver(mix)
    data = driver.load(mix) if data_dir is None else driver.load(mix, data_dir)
    first = driver.make_request(mix, data, seed, 0)

    weights = program.draw_weights(cfg, seed, device)
    pipe = driver.build(cfg, weights, mix, first, device)
    driver.run(pipe, driver.make_request(mix, data, seed, 0, steps=mix["warmup_steps"]))
    sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"[portbench] {spec['name']}: set-up {setup_s:.3f} s (weights, build, a "
        f"{mix['warmup_steps']}-step warm-up request)")

    if traced:
        trace.wrap_stages(pipe, driver.STAGES, driver.SAMPLER)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    failed, record_traced = [], {}

    def one(i):
        req = driver.make_request(mix, data, seed, i)
        timings = {} if traced else None
        before = program.launches()
        profile = trace.profiled() if traced and i == 0 else contextlib.nullcontext({})
        image = None
        with profile as prof:
            with (torch.profiler.record_function(trace.REQUEST) if traced and i == 0
                  else contextlib.nullcontext()):
                t0 = time.perf_counter()
                try:
                    image = driver.run(pipe, req, timings)
                except Exception:       # a request the program fails counts as failed
                    failed.append(i)
                    log(traceback.format_exc())
                wall = time.perf_counter() - t0
        after = program.launches()
        if traced and i == 0:
            record_traced["events"] = prof.get("events", [])
            record_traced["launches"] = {k: after[k] - before[k] for k in after}
        return {"request": req, "image": image, "timings": timings, "wall_s": wall,
                "launches": {k: after[k] - before[k] for k in after}}

    done, length = window.run(seconds, one)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    outs = [d[2] for d in done]
    log(f"[portbench] window: {len(done)} requests in {length:.3f} s, launches "
        f"{sum_launches(outs)}, peak {peak / GIB:.3f} GiB")

    metrics, dev = {}, device_info(device, peak)
    result = {"correct": False, "attempted": len(done), "failed": len(failed)}
    breakdown = None
    if traced:
        record = traced_record(cfg, mix, driver.STAGES, outs, record_traced)
        metrics = manifest.read_metrics(spec["per_layer"], record)
        # every metric the cell lists has to read; a CPU run has no device trace
        unread = [m["name"] for m in spec["per_layer"] if m["name"] not in metrics
                  and (cuda or m["source"] != "device_trace")]
        if unread:
            raise RuntimeError(f"the cell's per-layer metrics {unread} found nothing to read "
                               "in the traced request")
        win = record["traced"]["window"]
        kern = trace.kernels(record["traced"]["events"], win)
        dev.update(busy_s=trace.busy_seconds(kern, win), window_s=win[1] - win[0])
        breakdown = make_breakdown(record)
    else:
        e2e = {"image_s": window.seconds_per_request(done, length), "peak_gib": peak / GIB,
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in spec["end_to_end"] if m["name"] in e2e}

    # the check: the program's state freed, the weights drawn again for the reference
    pick = checked_index(seed, len(done))
    got = outs[pick]["image"]
    checked = outs[pick]["request"]
    del pipe, weights, outs, done, record_traced
    program.free()
    numbers = reference_numbers(driver, cfg, checked, got, seed, device, log)
    limits = work["limits"]
    result["correct"] = not failed and check.verdict(numbers, limits)
    result["metrics"] = metrics
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    log(f"[portbench] checked request {pick} of the window: " + ", ".join(
        f"{k} {v!r}" for k, v in numbers.items()))
    result["checks"] = {k: {"value": numbers.get(k, float("inf")), "limit": v}
                        for k, v in limits.items()}
    return result


def reference_numbers(driver, cfg: dict, request: dict, got, seed: int, device, log
                      ) -> Dict[str, float]:
    """The checked request through the plain reference, on weights drawn
    again from the seed, against the program's image."""
    if got is None:
        return check.numbers(None, None)
    t0 = time.perf_counter()
    tf32 = cfg["reference"]["matmul"] == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    weights = program.draw_weights(cfg, seed, device)
    want = driver.reference(weights, cfg, request, device)
    del weights
    program.free()
    numbers = check.numbers(got, want)
    log(f"[portbench] reference of request seed {request['seed']} ({request['name']}): "
        f"{time.perf_counter() - t0:.3f} s")
    return numbers


def sum_launches(outs) -> Dict[str, int]:
    total: Dict[str, int] = {}
    for o in outs:
        for k, v in o["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def device_info(device, peak: int) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": int(peak)}


def traced_record(cfg: dict, mix: dict, stage_names, outs, traced: dict) -> dict:
    """What the per-layer readers read (``metrics/__init__.py``)."""
    events = traced.get("events", [])
    req = outs[0]["request"]
    window_ranges = trace.ranges(events, trace.REQUEST)
    stages = {name: trace.ranges(events, trace.stage_range(name))
              for name in (*stage_names, "sample")}
    shape = attention_shape(cfg, mix, req)
    rows, s, s_txt = shape[0], shape[2], cfg["pipeline"]["max_sequence_length"]
    return {
        "requests": [{"wall_s": o["wall_s"], "timings": o["timings"] or {},
                      "steps": o["request"]["steps"]} for o in outs if o["image"] is not None],
        "traced": {"window": window_ranges[0] if window_ranges else (0.0, 0.0),
                   "events": events, "stages": {k: v for k, v in stages.items() if v},
                   "launches": traced.get("launches", {}), "steps": req["steps"]},
        "attention": {"shape": shape},
        "step_flop": step_counts.step_flop(cfg, rows, s - s_txt, s_txt),
    }


def make_breakdown(record: dict) -> dict:
    """The profiled request's ten device operations that took most time and
    its ten longest idle gaps, each labelled by the stage the host was in."""
    from portbench.kernels import kernel_label

    t = record["traced"]
    win = t["window"]
    kern = trace.kernels(t["events"], win)
    by_op: Dict[str, float] = {}
    for n, s, e in kern:
        by_op[kernel_label(n)] = by_op.get(kernel_label(n), 0.0) + (e - s)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(trace.idle_gaps(kern, win, t["stages"]), key=lambda g: -g[1])[:10]
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in gaps]}
