"""The attention A/B study on the card: the port's counterparts of the JAX
package's ``benchmarks/sweep_attention.py`` and ``benchmarks/
exp_softmax_overlap.py``, run as ``python -m reptext_tpu_torch.benchmarks.<name>``.

Each module has ``run(device) -> dict`` (what ``chip_smoke.py`` calls) and a
``main()`` that prints what the JAX script prints. Times come from CUDA
events: the median of 20 calls after 3 warm-ups, each call timed alone (the
JAX scripts chain 20 calls in one jitted loop, a guard against their remote
TPU's dispatch latency that a local card does not need). There is no CPU
fallback: a time is only ever the card's.
"""

from __future__ import annotations

import math
import statistics
from typing import Callable, Sequence

import torch

# the study's shape: FLUX at 1024^2 (512 text + 4096 image tokens), 24 heads
B, H, S, D = 1, 24, 4608, 128
REPEATS, WARMUP = 20, 3
TENSOR_CORE_BF16 = 989e12       # one H100 SXM, dense bf16 (NVIDIA's data sheet)


def require_cuda(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the attention study times the card; got device {device} with "
                           f"torch.cuda.is_available() = {torch.cuda.is_available()}")
    return device


def random_qkv(shape: Sequence[int], seed: int, device) -> list:
    """bf16 standard-normal q, k, v drawn on ``device`` from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(*shape, generator=g, device=device).to(torch.bfloat16)
            for _ in range(3)]


def cuda_time_ms(fn: Callable[[], object], repeats: int = REPEATS, warmup: int = WARMUP) -> float:
    """Median over ``repeats`` CUDA-event-timed calls of ``fn``, after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def check_correct(fn, device, atol: float = 2e-2) -> float:
    """The JAX scripts' ``check_correct``: ``fn`` at (1, 2, S, D) against an
    fp32 softmax reference; raises when the max-abs error reaches ``atol``."""
    q, k, v = random_qkv((1, 2, S, D), 7, device)
    ref = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(D),
                        dim=-1) @ v.float()
    err = (fn(q, k, v).float() - ref).abs().max().item()
    if not err < atol:
        raise AssertionError(f"max err {err} (atol {atol})")
    return err


def tensor_core_ms(b: int = B, h: int = H, s: int = S, d: int = D) -> float:
    """The tensor cores' speed of light for one forward: both products,
    4 B H S^2 D FLOP at the bf16 dense peak."""
    return 4 * b * h * s * s * d / TENSOR_CORE_BF16 * 1e3
