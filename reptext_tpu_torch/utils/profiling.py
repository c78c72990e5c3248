"""Tracing and step timing.

Counterpart of ``reptext_tpu/utils/profiling.py``: :func:`device_trace`, a
``torch.profiler`` trace of the CPU and (on the card) the CUDA activity,
written as a Chrome trace, and :class:`StepTimer`, the JAX class's wall-clock
step timer with warmup exclusion. PyTorch returns before the device has
finished, so on the card the timer synchronises the device before it reads
the clock, at the start and at the end of every step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Iterator, List, Union

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
