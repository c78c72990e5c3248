"""The traced request that ran under ``torch.profiler``, for the readers of
the program's spans in the inpainting cells.

``_spans.py``'s readers read only requests without the profiler, and a
traced inpainting window may hold none: a request takes about 11 s, the
profiled one about 18 s with the profiler's post-processing, and a second
request runs only while the first stays under half the window. So these
readers read the profiled request, which every traced run has."""

from __future__ import annotations

from typing import Optional


def profiled_trace(record) -> Optional[dict]:
    """The program's trace of the traced request that ran under the
    profiler, or None."""
    return next((t for t in (((r.get("timings") or {}).get("trace"))
                             for r in record.get("requests", []))
                 if t and t.get("profiled")), None)


def span_ms(trace: dict, name: str) -> float:
    """Device ms of every span ``name`` of the trace, summed."""
    return sum(s["device_ms"] for s in trace["spans"] if s["name"] == name)
