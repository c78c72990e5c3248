"""Times the blocks' joins on the card: the copy-free route against copies.

At the main path's shapes (txt2img 1024², batch 1, 4608 joint tokens; the
inpainting cell's CFG batch 2 at 1280x960, 5312 tokens; 512 text tokens,
FLUX.1-dev's widths) it times, by CUDA events over back-to-back calls:

- K1 on the joint q, k and v with the three ``torch.cat`` copies that make
  them, K1 on the joint tensors alone (contiguous [B, H, S, D], as ``cat``
  leaves them, and in the projections' [B, S, H, D] layout), and K1's
  segment route (the text and image segments as the projections leave them,
  each stream's output dense);
- the single block's MLP join: ``F.gelu`` then ``torch.cat([attn, mlp])``,
  against the GELU kernel writing into ``proj_out``'s input buffer (and into
  a dense tensor), and eager ``F.gelu`` alone;
- a double and a single block at full width, random bf16 weights, on each
  route (the copied one forced by a join rule that always says no).

A reading is ``INNER`` calls queued back to back between two CUDA events,
divided by ``INNER``: device time, the host's own time hidden while it runs
ahead.

Each line gives the median ms, the spread (first to third quartile) and, for
the memory-bound ops, the bytes moved and their share of 3.35 TB/s. Run on
the card: ``python -m reptext_tpu_torch.benchmarks.join_times [--reps N]``;
it prints one JSON line per case and, with ``--output``, writes them all.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

HEADS, D, TXT, MLP = 24, 128, 512, 12288
INNER = 10
PEAK_BYTES_PER_S = 3.35e12
SHAPES = ((1, 4608), (2, 5312))


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def time_ms(fn: Callable[[], object], reps: int, inner: int = INNER) -> List[float]:
    """Device ms a call: ``inner`` calls back to back between two events
    (the host queues ahead, so its own time between launches is hidden),
    ``reps`` times after a warm-up round."""
    for _ in range(inner):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return out


def summary(name: str, times: List[float], nbytes: float = 0.0, **extra) -> Dict:
    q1, med, q3 = statistics.quantiles(times, n=4)
    row = {"case": name, "ms": med, "iqr_ms": q3 - q1, **extra}
    if nbytes:
        row["gb"] = nbytes / 1e9
        row["bound_share"] = nbytes / PEAK_BYTES_PER_S / (med * 1e-3)
    print(json.dumps(row), flush=True)
    return row


def kernel_cases(b: int, s: int, reps: int, dev) -> List[Dict]:
    from reptext_tpu_torch.nn.blocks import split_heads
    from reptext_tpu_torch.ops import flash_attention as fa
    from reptext_tpu_torch.ops.gelu import gelu_tanh_into
    from reptext_tpu_torch.ops.rope import rope_cos_sin_half

    gen = torch.Generator(device=dev).manual_seed(s)
    inner = HEADS * D
    ids = torch.zeros(s, 3, device=dev)
    side = int((s - TXT) ** 0.5)
    ids[TXT:, 1] = torch.arange(s - TXT, device=dev) // side
    ids[TXT:, 2] = torch.arange(s - TXT, device=dev) % side
    cos, sin = rope_cos_sin_half(ids, (16, 56, 56), 10000)

    def stream(n):
        return split_heads(torch.randn(b, n, inner, generator=gen, device=dev)
                           .to(torch.bfloat16), HEADS)

    q, k, v = ((stream(TXT), stream(s - TXT)) for _ in range(3))
    joint = [torch.cat(x, dim=2) for x in (q, k, v)]
    strided = [stream(s) for _ in range(3)]
    tag = f"({b},{HEADS},{s},{D})"
    cat_bytes = 3 * 2 * b * s * inner * 2
    rows = [
        summary(f"K1 joint + q/k/v cat {tag}", time_ms(
            lambda: fa.flash_attention_rope(*(torch.cat(x, dim=2) for x in (q, k, v)), cos, sin),
            reps), shape=tag),
        summary(f"q/k/v cat {tag}", time_ms(
            lambda: [torch.cat(x, dim=2) for x in (q, k, v)], reps), cat_bytes, shape=tag),
        summary(f"K1 joint {tag}", time_ms(
            lambda: fa.flash_attention_rope(*joint, cos, sin), reps), shape=tag),
        summary(f"K1 joint in the projections' [B, S, H, D] layout {tag}", time_ms(
            lambda: fa.flash_attention_rope(*strided, cos, sin), reps), shape=tag),
        summary(f"K1 segments {tag}", time_ms(
            lambda: fa.flash_attention_rope(q, k, v, cos, sin), reps), shape=tag),
    ]
    mlp = torch.randn(b, s, MLP, generator=gen, device=dev).to(torch.bfloat16)
    attn = torch.randn(b, s, inner, generator=gen, device=dev).to(torch.bfloat16)
    buf = torch.empty(b, s, inner + MLP, dtype=torch.bfloat16, device=dev)
    attn_like = torch.empty_like(mlp)
    gelu_bytes = 2 * b * s * MLP * 2
    shape = f"[{b},{s},{MLP}]"
    rows += [
        summary(f"F.gelu + cat([attn, mlp]) {shape}", time_ms(
            lambda: torch.cat([attn, F.gelu(mlp, approximate="tanh")], dim=-1), reps),
            gelu_bytes + 2 * b * s * (inner + MLP) * 2, shape=shape),
        summary(f"F.gelu {shape}", time_ms(lambda: F.gelu(mlp, approximate="tanh"), reps),
                gelu_bytes, shape=shape),
        summary(f"GELU kernel into proj_out's input {shape}", time_ms(
            lambda: gelu_tanh_into(mlp, buf[..., inner:]), reps), gelu_bytes, shape=shape),
        summary(f"GELU kernel, dense out {shape}", time_ms(
            lambda: gelu_tanh_into(mlp, attn_like), reps), gelu_bytes, shape=shape),
    ]
    return rows


def block_cases(b: int, s: int, reps: int, dev) -> List[Dict]:
    from reptext_tpu_torch.nn import blocks
    from reptext_tpu_torch.nn.blocks import JointTransformerBlock, SingleTransformerBlock
    from reptext_tpu_torch.ops.rope import rope_cos_sin_half

    gen = torch.Generator(device=dev).manual_seed(b)
    dim = HEADS * D
    joint = JointTransformerBlock(dim, HEADS, D, device=dev, dtype=torch.bfloat16)
    single = SingleTransformerBlock(dim, HEADS, D, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        for p in (*joint.parameters(), *single.parameters()):
            p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.02
                    + (1.0 if p.dim() == 1 and p.shape[0] == D else 0.0))
    img = torch.randn(b, s - TXT, dim, generator=gen, device=dev).to(torch.bfloat16)
    txt = torch.randn(b, TXT, dim, generator=gen, device=dev).to(torch.bfloat16)
    seq = torch.cat([txt, img], dim=1)
    temb = torch.randn(b, dim, generator=gen, device=dev).to(torch.bfloat16)
    ids = torch.zeros(s, 3, device=dev)
    side = int((s - TXT) ** 0.5)
    ids[TXT:, 1] = torch.arange(s - TXT, device=dev) // side
    ids[TXT:, 2] = torch.arange(s - TXT, device=dev) % side
    cos, sin = rope_cos_sin_half(ids, (16, 56, 56), 10000)
    rule = blocks.joins_in_place
    rows = []
    with torch.inference_mode():
        for route in ("copied", "in_place", "in_place", "copied"):
            blocks.joins_in_place = rule if route == "in_place" else (lambda *a, **kw: False)
            try:
                rows.append(summary(f"double block, {route} (B={b}, S={s})", time_ms(
                    lambda: joint(img, txt, temb, cos, sin), reps), route=route))
                rows.append(summary(f"single block, {route} (B={b}, S={s})", time_ms(
                    lambda: single(seq, temb, cos, sin, None, TXT), reps), route=route))
            finally:
                blocks.joins_in_place = rule
    return rows


def main(argv=None) -> List[Dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=15)
    parser.add_argument("--output", default=None)
    args = parser.parse_args(argv)
    from reptext_tpu_torch.ops import _build

    _build.load()
    dev = torch.device("cuda")
    print(json.dumps({"card": card(), "torch": torch.__version__}), flush=True)
    rows = []
    for b, s in SHAPES:
        rows += kernel_cases(b, s, args.reps, dev)
        rows += block_cases(b, s, args.reps, dev)
    if args.output:
        with open(args.output, "w") as f:
            json.dump({"card": card(), "rows": rows}, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
