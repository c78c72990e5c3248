"""The measured window: whole requests, one after the other.

The first request always runs; each later one starts only while the elapsed
time plus the last request's time stays within the window's seconds. The
window ends with its last request, so seconds per image is the window's
time over the requests it completed: all the work over all the time."""

from __future__ import annotations

import time
from typing import Any, Callable, List, Tuple


def run(seconds: float, one: Callable[[int], Any], clock: Callable[[], float] = time.perf_counter
        ) -> Tuple[List[Tuple[float, float, Any]], float]:
    """([(start, end, result) per request, relative to the window's start],
    the window's length)."""
    t0 = clock()
    done: List[Tuple[float, float, Any]] = []
    last = 0.0
    while not done or (clock() - t0) + last <= seconds:
        start = clock()
        out = one(len(done))
        end = clock()
        last = end - start
        done.append((start - t0, end - t0, out))
    return done, done[-1][1]


def seconds_per_request(done, length: float) -> float:
    return length / len(done)
