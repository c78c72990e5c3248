"""The program's own spans and counters in the traced requests: the
``timings["trace"]`` that ``reptext_tpu_torch/utils/profiling.py`` writes
(``profiled``, ``spans`` with host bounds in ns on the profiler's clock and
device ms, ``counters``). A program without spans writes no ``trace``: the
span readers then find nothing and return None.

The readers of device and host times read only the requests that ran without
``torch.profiler``, whose per-op cost on the host would slow the step they
time. Where every traced request ran under it, as in a traced window of one
request, they read nothing."""

from __future__ import annotations

from typing import List, Optional


def _traces(record) -> List[dict]:
    return [r["timings"]["trace"] for r in record.get("requests", [])
            if "trace" in (r.get("timings") or {})]


def unprofiled(record) -> List[dict]:
    """The traces of the traced requests that ran without ``torch.profiler``."""
    return [t for t in _traces(record) if not t["profiled"]]


def profiled(record) -> Optional[dict]:
    """The trace of the request that ran under ``torch.profiler``, or None."""
    return next((t for t in _traces(record) if t["profiled"]), None)


def device_ms(traces: List[dict], name: str) -> List[float]:
    """Device ms of every span ``name`` in ``traces``."""
    return [s["device_ms"] for t in traces for s in t["spans"] if s["name"] == name]


def counter(traces: List[dict], name: str) -> int:
    return sum(t["counters"][name] for t in traces)
