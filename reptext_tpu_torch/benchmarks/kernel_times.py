"""The attention kernels' times at FLUX.1-dev's head dim, for A/B runs of two checkouts.

K1 (RoPE fused) and K2 at the 1024^2 request's (1, 24, 4608, 128), K3 at the
1536x1152 inpaint request's (2, 24, 7424, 128) and the 1536^2 one's (1, 24,
9728, 128), and K4 (one backward call: preprocess, main kernel, epilogue) at
(1, 24, 4608, 128) and every train launch's (2, 24, 4608, 128), all bf16 on
seeded inputs with FLUX's RoPE tables, three ways, ``--rounds`` times in
turn, one JSON line per round with the card's name and power limit: ``ms``,
the median of 20 CUDA-event timings of one call after 3 warm-ups (what
``chip_smoke.py`` reports: the device waits for the host's launches inside
the window); ``ms_back_to_back``, one event pair around 20 calls in a row
divided by 20 (the launches queue up, so the device never waits for the
host: the kernels' own time); ``host_us``, the host's seconds per call over
those 20 (the wrapper and the launch, not the kernels; the host's time, not
the device's). Only entry points that every version of the port with the
streaming kernel (K3) has are used, so the same script times another
checkout's kernels when that checkout comes first on ``PYTHONPATH``; run the
two in turns in one call (parent, change, change, parent):

    PYTHONPATH=PARENT python reptext_tpu_torch/benchmarks/kernel_times.py --label parent
    PYTHONPATH=. python reptext_tpu_torch/benchmarks/kernel_times.py --label change
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from reptext_tpu_torch.benchmarks.backward_order import median_ms, rope_tables


def run(label: str, rounds: int, device="cuda") -> None:
    from reptext_tpu_torch.ops import flash_attention as fa
    from reptext_tpu_torch.ops.rope import apply_rope_half

    dev = torch.device(device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, s):
        return [torch.randn(b, 24, s, 128, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(3)]

    cases = {}
    q, k, v = qkv(1, 4608)
    cos, sin = rope_tables(4608, dev)
    cases["K1 (1,24,4608,128)"] = lambda: fa.flash_attention_rope(q, k, v, cos, sin)
    cases["K2 (1,24,4608,128)"] = lambda: fa.flash_attention(q, k, v)
    for b, s in ((2, 7424), (1, 9728)):
        qs, ks, vs = qkv(b, s)
        cases[f"K3 ({b},24,{s},128)"] = (
            lambda qs=qs, ks=ks, vs=vs: fa.flash_attention_streaming(qs, ks, vs))
    for b in (1, 2):
        qb, kb, vb = (x.repeat(b, 1, 1, 1) for x in (q, k, v))
        out, lse = fa.flash_attention_rope(qb, kb, vb, cos, sin)
        do = torch.randn(out.shape, generator=gen, device=dev).to(torch.bfloat16)
        args = (apply_rope_half(qb, cos, sin), apply_rope_half(kb, cos, sin), vb, out, lse, do)
        cases[f"K4 ({b},24,4608,128)"] = lambda args=args: fa.flash_attention_backward(*args)
    def back_to_back(fn, n=20):
        fn()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host = time.perf_counter() - t0
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / n, 1e6 * host / n

    for r in range(rounds):
        ms = {name: median_ms(fn) for name, fn in cases.items()}
        b2b = {name: back_to_back(fn) for name, fn in cases.items()}
        print(json.dumps({"label": label, "round": r, "device": smi, "ms": ms,
                          "ms_back_to_back": {k: v[0] for k, v in b2b.items()},
                          "host_us": {k: v[1] for k, v in b2b.items()}}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="change")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs a CUDA card")
    run(args.label, args.rounds)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
