"""One joint attention call's least work: both products, 4 B H S^2 D FLOP
(at the bf16 tensor-core rate), and q, k, v read and the output written once
in the call's dtype, the fp32 log-sum-exp written, and, for the RoPE-fused
entry, its fp32 cos and sin tables [S, D] read."""

from __future__ import annotations

from typing import Tuple

from portbench.counts import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S


def flop(b: int, h: int, s: int, d: int) -> int:
    return 4 * b * h * s * s * d


def nbytes(b: int, h: int, s: int, d: int, elem: int = 2, tables: bool = False) -> int:
    return 4 * b * h * s * d * elem + 4 * b * h * s + (2 * s * d * 4 if tables else 0)


def bound_s(b: int, h: int, s: int, d: int, elem: int = 2, tables: bool = False
            ) -> Tuple[float, str]:
    """(seconds, what bounds it): the larger of the operations at the peak
    rate and the bytes at the memory rate."""
    t_ops = flop(b, h, s, d) / PEAK_BF16_FLOPS
    t_bytes = nbytes(b, h, s, d, elem, tables) / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
