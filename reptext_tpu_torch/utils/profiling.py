"""Tracing and step timing.

Counterpart of ``reptext_tpu/utils/profiling.py``: :func:`device_trace`, a
``torch.profiler`` trace of the CPU and (on the card) the CUDA activity,
written as a Chrome trace, and :class:`StepTimer`, the JAX class's wall-clock
step timer with warmup exclusion. PyTorch returns before the device has
finished, so on the card the timer synchronises the device before it reads
the clock, at the start and at the end of every step.

The port adds the program's own spans (:class:`SpanRecorder`), switched on per
request by the pipelines' ``timings=`` dict and by nothing else. With
``timings=None`` nothing is recorded: the samplers and the attention entries
read :func:`active_recorder` (one thread-local read; on the card an
attention call reads it twice, the second time in :func:`time_launch`) and
find None. With a
dict, :func:`request_trace` installs a recorder for the calling thread (ranks
that run as threads each get their own) and the request's spans form a tree:

- ``request``, the root;
- the stages ``encode_prompt``, ``prepare``, ``sample`` and ``decode``, each
  ending in a device synchronisation, whose host seconds, on
  ``time.perf_counter``'s clock, go into ``timings`` under their names (what
  ``timings`` held before the spans); inside the inpaint pipeline's
  ``prepare``, ``inpaint_cond``, the masked-image encode;
- ``step``, one per sampler step; inside it ``controlnet`` (the RepText
  net), ``controlnet_inpaint`` (the inpaint sampler's second net) and
  ``flux``; the mask-and-sum, the Euler update and the casts are the step's
  own time;
- ``attention``, one per call of an attention entry (K1, K2, K3 and the plain
  path), carrying the entry's name, and on the card ``launch_ns``: the host
  ns of the kernel's launch call (:func:`time_launch`), where the host waits
  whenever the device's launch queue is full.

Beside the spans, two counters without a span, a dict increment a call and
no CUDA event, since a step makes hundreds: the calls of each norm entry
(``ops/norms.py``'s ``modulate`` and ``rms_norm``, :func:`count_norm_call`),
and the blocks' joins (:func:`count_join`): each double and single block
that joined its streams and branches in place or by copies
(``ops/attention.py::joins_in_place``).

Each span holds its parent's index, its host start and end in ns on
``time.time_ns()``'s clock, which is the clock of ``torch.profiler``'s events
(Unix-epoch ns), and its device ms: CUDA events at its two ends on the
request's stream, read after the request's last stage has synchronised the
device (the recorder adds no synchronisation); on the CPU, where ops run
synchronously, its host duration. ``timings["trace"]`` receives
``{"profiled", "spans", "counters"}`` when the request ends; ``profiled``
says whether ``torch.profiler`` was on. The spans enter no
``record_function`` range: a profiler that traces the card copies every range
onto the device's timeline, where a reader of its kernel events takes it for
a kernel. Their host bounds set them against the kernels all the same.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Union

import torch

Device = Union[str, torch.device]


def _cuda(device: Device) -> bool:
    """Whether ``device`` is a CUDA device; raises if it is one and there is
    no card (the caller asks for the CPU explicitly)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but torch.cuda.is_available() is False; "
                           "pass device='cpu' to trace or time on the CPU")
    return device.type == "cuda"


@contextlib.contextmanager
def device_trace(log_dir: str, device: Device = "cuda") -> Iterator[torch.profiler.profile]:
    """Profile the block: CPU activity, and CUDA kernels on the card. Writes
    ``log_dir/trace.json`` (Chrome trace format, viewable in Perfetto or
    TensorBoard's profiler) and yields the profiler (``key_averages()``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if _cuda(device):
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if activities[-1] == ProfilerActivity.CUDA:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclasses.dataclass
class StepTimer:
    """Wall-clock step timing with warmup exclusion.

    Usage:
        timer = StepTimer(warmup=2)
        for _ in range(n):
            with timer.step():
                out = fn(x)
        print(timer.summary())

    ``device``: the card (default; synchronised before each clock read) or
    ``"cpu"``.
    """

    warmup: int = 1
    times: List[float] = dataclasses.field(default_factory=list)
    device: Device = "cuda"
    _seen: int = 0

    def __post_init__(self):
        self._sync = _cuda(self.device)

    def _clock(self) -> float:
        if self._sync:
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    @contextlib.contextmanager
    def step(self):
        start = self._clock()
        yield
        elapsed = self._clock() - start
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(elapsed)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"steps": 0}
        ts = sorted(self.times)
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "min_s": ts[0],
            "max_s": ts[-1],
        }


# ----------------------------------------------------------- program spans

_local = threading.local()
_OFF = contextlib.nullcontext()


def active_recorder() -> Optional["SpanRecorder"]:
    """The recorder of the request this thread runs; None when tracing is off."""
    return getattr(_local, "recorder", None)


class _Span:
    """One span; entered and left as a context manager by its recorder's
    thread. ``sync``: a stage, which synchronises the device before its host
    end and writes its seconds into ``timings``. ``events``: whether it
    records CUDA events of its own (the request reads its stages')."""

    __slots__ = ("rec", "name", "attrs", "sync", "events", "parent", "start_ns", "end_ns",
                 "start_s")

    def __init__(self, rec: "SpanRecorder", name: str, attrs: dict, sync: bool = False,
                 events: bool = True):
        self.rec, self.name, self.attrs, self.sync = rec, name, attrs, sync
        self.events = [] if events and rec.cuda else None

    def __enter__(self) -> "_Span":
        rec = self.rec
        self.parent = rec.open[-1] if rec.open else -1
        rec.open.append(len(rec.spans))
        rec.spans.append(self)
        if self.events is not None:
            self.events.append(rec.event())
        self.start_ns = time.time_ns()
        if self.sync:
            self.start_s = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        rec = self.rec
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events.append(rec.event())
        if self.sync and exc_type is None:
            if rec.cuda:
                torch.cuda.synchronize(rec.device)
                self.end_ns = time.time_ns()
            rec.timings[self.name] = time.perf_counter() - self.start_s
        rec.open.pop()

    def device_ms(self, children: List["_Span"]) -> float:
        """The device's ms from the span's start event to its end event; for
        a span without events, from its first child's start to its last
        child's end; on the CPU its host duration."""
        if not self.rec.cuda:
            return (self.end_ns - self.start_ns) * 1e-6
        first, last = (self, self) if self.events else (children[0], children[-1])
        return first.events[0].elapsed_time(last.events[1])


class SpanRecorder:
    """The spans of one request (the module note). ``timings`` receives the
    stages' seconds; :func:`request_trace` makes the recorder of a request,
    installs it for the thread and writes :meth:`result` into ``timings``.
    Used alone, it is a stage clock that nothing else in the program sees."""

    def __init__(self, timings: Dict, device: Device):
        self.timings = timings
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.current_stream(self.device) if self.cuda else None
        self.profiled = bool(torch.autograd.profiler._is_profiler_enabled)
        self.spans: List[_Span] = []
        self.open: List[int] = []
        self.norm_calls: Dict[str, int] = {}
        self.joins: Dict[str, int] = {"inplace": 0, "copied": 0}

    def event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def span(self, name: str, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def stage(self, name: str) -> _Span:
        """A span that ends in a device synchronisation; its host seconds,
        synchronisation included, go into ``timings[name]``."""
        return _Span(self, name, {}, sync=True)

    def result(self) -> dict:
        """``{"profiled", "spans", "counters"}`` once every span has ended
        and the last stage has synchronised the device. A span is a dict of
        ``name``, ``parent`` (an index, -1 for the root), ``start_ns``,
        ``end_ns``, ``device_ms`` and its attributes (``entry``). Counters:
        ``steps``, ``controlnet_steps`` (steps that ran the RepText net),
        ``controlnet_inpaint_steps`` (steps that ran the inpaint sampler's
        second net), ``velocity_cache_skips`` (steps that ran no FLUX: both samplers run
        it on every step they compute), per attention entry its ``calls``,
        ``host_ns`` (entering the entry to its return) and ``launch_ns`` (the
        part spent in kernel launch calls; 0 on the CPU), ``norm``: the
        calls of each norm entry, by its name, and ``joins``: the blocks that
        joined in place (``inplace``) and by copies (``copied``)."""
        children: Dict[int, List[_Span]] = {}
        for s in self.spans:
            children.setdefault(s.parent, []).append(s)
        spans = [dict(name=s.name, parent=s.parent, start_ns=s.start_ns, end_ns=s.end_ns,
                      device_ms=s.device_ms(children.get(i, [])), **s.attrs)
                 for i, s in enumerate(self.spans)]
        steps = [i for i, s in enumerate(spans) if s["name"] == "step"]
        ran = {s["parent"] for s in spans if s["name"] == "flux"}
        attention: Dict[str, Dict[str, int]] = {}
        for s in spans:
            if s["name"] == "attention":
                c = attention.setdefault(s["entry"], {"calls": 0, "host_ns": 0, "launch_ns": 0})
                c["calls"] += 1
                c["host_ns"] += s["end_ns"] - s["start_ns"]
                c["launch_ns"] += s.get("launch_ns", 0)
        counters = {"steps": len(steps),
                    "controlnet_steps": sum(s["name"] == "controlnet" for s in spans),
                    "controlnet_inpaint_steps": sum(s["name"] == "controlnet_inpaint"
                                                    for s in spans),
                    "velocity_cache_skips": len(set(steps) - ran), "attention": attention,
                    "norm": dict(self.norm_calls), "joins": dict(self.joins)}
        return {"profiled": self.profiled, "spans": spans, "counters": counters}


@contextlib.contextmanager
def request_trace(timings: Optional[Dict], device: Device
                  ) -> Iterator[Optional[SpanRecorder]]:
    """The ``request`` span of one pipeline call, under which its stages and
    the spans of the samplers and attention entries nest. Yields None and
    records nothing when ``timings`` is None; else the thread's recorder,
    and ``timings["trace"]`` receives its result when the request ends
    (nothing when it raises)."""
    if timings is None:
        yield None
        return
    rec = SpanRecorder(timings, device)
    prev = getattr(_local, "recorder", None)
    _local.recorder = rec
    try:
        with _Span(rec, "request", {}, events=False):
            yield rec
    finally:
        _local.recorder = prev
    timings["trace"] = rec.result()
    # a span refers to its recorder: free the spans and their CUDA events now,
    # not at a later request's cyclic collection
    rec.spans.clear()


def span(recorder: Optional[SpanRecorder], name: str):
    """``recorder.span(name)``; nothing when ``recorder`` is None."""
    return _OFF if recorder is None else recorder.span(name)


def stage(recorder: Optional[SpanRecorder], name: str):
    """``recorder.stage(name)``; nothing when ``recorder`` is None."""
    return _OFF if recorder is None else recorder.stage(name)


def span_calls(name: str) -> Callable[[Callable], Callable]:
    """Decorator: every call of the function under an active recorder is a
    span ``name`` carrying ``entry``, the function's name."""

    def wrap(fn: Callable) -> Callable:
        entry = fn.__name__

        @functools.wraps(fn)
        def call(*args, **kwargs):
            rec = getattr(_local, "recorder", None)
            if rec is None:
                return fn(*args, **kwargs)
            with _Span(rec, name, {"entry": entry}):
                return fn(*args, **kwargs)

        return call

    return wrap


def count_norm_call(entry: str) -> None:
    """One call of the norm entry ``entry`` under the thread's recorder
    (its ``norm`` counter); nothing when tracing is off."""
    rec = getattr(_local, "recorder", None)
    if rec is not None:
        rec.norm_calls[entry] = rec.norm_calls.get(entry, 0) + 1


def count_join(in_place: bool) -> None:
    """One block's joins, in place or by copies, under the thread's recorder
    (its ``joins`` counter); nothing when tracing is off."""
    rec = getattr(_local, "recorder", None)
    if rec is not None:
        rec.joins["inplace" if in_place else "copied"] += 1


def time_launch(launch: Callable, *args):
    """``launch(*args)``, a kernel's launch call; under an active recorder its
    host ns are added to the innermost open span's ``launch_ns`` (the
    attention span of the entry that launches)."""
    rec = getattr(_local, "recorder", None)
    if rec is None:
        return launch(*args)
    t0 = time.time_ns()
    try:
        return launch(*args)
    finally:
        attrs = rec.spans[rec.open[-1]].attrs
        attrs["launch_ns"] = attrs.get("launch_ns", 0) + time.time_ns() - t0
