"""Device idle ms per sampler step in the profiled request: every gap of its
window in which no kernel runs (as ``trace.idle_gaps`` finds them), labelled
by the innermost program span the host was in when the gap began (the
spans' host bounds and the kernels share the profiler's clock), summed over
the gaps labelled ``step`` or a span inside a step, over its steps.

:func:`gaps_by_span` gives the whole split, every span name with its idle
seconds (``outside`` for gaps outside every span)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from portbench import trace
from portbench.metrics._spans import profiled


def gaps(kern, window: Tuple[float, float]) -> List[Tuple[float, float]]:
    """(start, seconds) of every gap of ``window`` with no kernel running."""
    out, at = [], window[0]
    for s, e in trace.busy_intervals(kern) + [(window[1], window[1])]:
        if s > at:
            out.append((at, s - at))
        at = max(at, e)
    return out


def innermost(spans: List[dict], times: List[float]) -> List[Optional[int]]:
    """For each of ``times`` (ascending, in seconds), the index of the
    innermost span whose host bounds hold it, or None. The spans are in the
    order they began and nest, as one thread's spans do."""
    out, stack, j = [], [], 0
    for t in times:
        while j < len(spans) and spans[j]["start_ns"] * 1e-9 <= t:
            while stack and spans[stack[-1]]["end_ns"] <= spans[j]["start_ns"]:
                stack.pop()
            stack.append(j)
            j += 1
        while stack and spans[stack[-1]]["end_ns"] * 1e-9 <= t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def labelled_gaps(record) -> Optional[Tuple[dict, List[Optional[int]], List[float]]]:
    """The profiled request's trace, each idle gap's innermost span and its
    seconds; None without a trace or kernels."""
    t, traced = profiled(record), record.get("traced")
    if t is None or not traced:
        return None
    window = traced["window"]
    kern = trace.kernels(traced["events"], window)
    if not kern:
        return None
    found = gaps(kern, window)
    return t, innermost(t["spans"], [g[0] for g in found]), [g[1] for g in found]


def gaps_by_span(record) -> Optional[Dict[str, float]]:
    """Idle seconds of the profiled request by the innermost span's name."""
    got = labelled_gaps(record)
    if got is None:
        return None
    t, labels, seconds = got
    out: Dict[str, float] = {}
    for i, sec in zip(labels, seconds):
        name = "outside" if i is None else t["spans"][i]["name"]
        out[name] = out.get(name, 0.0) + sec
    return out


def read(record):
    got = labelled_gaps(record)
    if got is None:
        return None
    t, labels, seconds = got
    spans = t["spans"]
    in_step: List[bool] = []
    for s in spans:       # a parent comes before its children
        in_step.append(s["name"] == "step" or (s["parent"] >= 0 and in_step[s["parent"]]))
    steps = t["counters"]["steps"]
    if not steps:
        return None
    return 1e3 * sum(sec for i, sec in zip(labels, seconds)
                     if i is not None and in_step[i]) / steps
