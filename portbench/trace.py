"""The traced run's record: device kernels and the harness's own host ranges
from ``torch.profiler``, read from outside the program.

The harness wraps the pipeline's stage methods on the instance (never the
program's code) in ``record_function`` ranges, so every kernel and every idle
gap can be set against the stage the host was in. Times are in seconds on the
profiler's clock.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Optional, Tuple

REQUEST = "portbench.request"


def stage_range(name: str):
    return f"portbench.{name}"


def wrap_stages(pipe, stages, sampler: str) -> None:
    """Put each stage method of ``pipe`` named in ``stages`` in a range of its
    name, and the sampling loop that its ``sampler`` method returns in the
    range ``sample``, on this instance only. A name the pipeline lacks is an
    error, not a silent gap: the per-layer metrics read these ranges."""
    from torch.profiler import record_function

    missing = [n for n in (*stages, sampler) if not callable(getattr(pipe, n, None))]
    if missing:
        raise AttributeError(f"the pipeline has no method {missing}: the traced run cannot "
                             "put its stages in ranges (the traffic driver names them)")

    def wrapped(fn, label):
        @functools.wraps(fn)
        def call(*a, **k):
            with record_function(stage_range(label)):
                return fn(*a, **k)
        return call

    for name in stages:
        setattr(pipe, name, wrapped(getattr(pipe, name), name))
    make = getattr(pipe, sampler)
    setattr(pipe, sampler, lambda *a, **k: wrapped(make(*a, **k), "sample"))


@contextlib.contextmanager
def profiled():
    """Profile the device and the host ranges; yields a dict that receives
    ``events`` [(name, is_device, start_s, end_s)] when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    out: Dict[str, list] = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield out
    out["events"] = events(prof)


def events(prof) -> List[Tuple[str, bool, float, float]]:
    """(name, on the device, start, end) of every kernel and every harness
    range, from the profiler's raw results."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        name, dev = e.name(), e.device_type() == DeviceType.CUDA
        if dev or name.startswith("portbench."):
            start = e.start_ns() * 1e-9
            out.append((name, dev, start, start + e.duration_ns() * 1e-9))
    return out


def kernels(events, within: Optional[Tuple[float, float]] = None):
    """Device kernels (NCCL's ranges and the device-side copies of the
    harness's ranges left out), optionally those that start inside ``within``."""
    out = [(n, s, e) for n, dev, s, e in events
           if dev and not n.startswith(("nccl:", "portbench."))]
    if within is not None:
        out = [k for k in out if within[0] <= k[1] < within[1]]
    return out


def ranges(events, name: str) -> List[Tuple[float, float]]:
    return [(s, e) for n, dev, s, e in events if not dev and n == name]


def busy_intervals(kern) -> List[Tuple[float, float]]:
    """The union of kernel intervals, merged, in time order."""
    spans = sorted((s, e) for _, s, e in kern)
    merged: List[List[float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_seconds(kern, window: Tuple[float, float]) -> float:
    lo, hi = window
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in busy_intervals(kern))


def idle_gaps(kern, window: Tuple[float, float], stage_ranges: Dict[str, list]
              ) -> List[Tuple[str, float]]:
    """Every gap of the window in which no kernel runs, labelled by the
    harness range the host was in when it began (``request`` outside them)."""
    gaps, at = [], window[0]
    for s, e in busy_intervals(kern) + [(window[1], window[1])]:
        if s > at:
            label = "request"
            for name, spans in stage_ranges.items():
                if any(a <= at < b for a, b in spans):
                    label = name
            gaps.append((label, s - at))
        at = max(at, e)
    return gaps
