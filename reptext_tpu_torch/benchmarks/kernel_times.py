"""The attention kernels' times at FLUX.1-dev's and the demo's head dims, for A/B runs of checkouts.

K1 (RoPE fused) and K2 at the 1024^2 request's (1, 24, 4608, 128), K3 at the
1536x1152 inpaint request's (2, 24, 7424, 128) and the 1536^2 one's (1, 24,
9728, 128), and K4 (one backward call: preprocess, main kernel, epilogue) at
(1, 24, 4608, 128) and every train launch's (2, 24, 4608, 128); and at head
dim 64: K1 and K4 at (1, 24, 4608, 64), K2 and K4 at the trained-weights demo's
(16, 4, 69, 64), K3 at (1, 24, 9728, 64). All bf16 on seeded inputs with
FLUX's RoPE tables (the demo's axes at 64), three ways, ``--rounds`` times in
turn, one JSON line per round with the card's name and power limit: ``ms``,
the median of 20 CUDA-event timings of one call after 3 warm-ups (what
``chip_smoke.py`` reports: the device waits for the host's launches inside
the window); ``ms_back_to_back``, one event pair around 20 calls in a row
divided by 20 (the launches queue up, so the device never waits for the
host: the kernels' own time); ``host_us``, the host's seconds per call over
those 20 (the wrapper and the launch, not the kernels; the host's time, not
the device's). Only entry points that every version of the port with the
streaming kernel (K3) has are used (head dim 64 needs a version that takes
it: the kernels at 64 came after K3), so the same script times another
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


def demo_tables(txt: int, grid: int, device):
    """fp32 half-split tables at head dim 64 (the demo's axes (8, 28, 28)) of
    ``txt`` zero text ids and a ``grid`` x ``grid`` image grid."""
    from reptext_tpu_torch.ops.latents import prepare_latent_image_ids
    from reptext_tpu_torch.ops.rope import rope_cos_sin_half

    ids = torch.cat([torch.zeros(txt, 3, device=device),
                     prepare_latent_image_ids(2 * grid, 2 * grid, device)])
    return rope_cos_sin_half(ids, (8, 28, 28), 10000)


def run(label: str, rounds: int, device="cuda") -> None:
    from reptext_tpu_torch.ops import flash_attention as fa
    from reptext_tpu_torch.ops.rope import apply_rope_half

    dev = torch.device(device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, s, h=24, d=128):
        return [torch.randn(b, h, s, d, generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(3)]

    def backward_args(q, k, v, cos, sin):
        out, lse = fa.flash_attention_rope(q, k, v, cos, sin)
        do = torch.randn(out.shape, generator=gen, device=dev).to(torch.bfloat16)
        return (apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin), v, out, lse, do)

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
        args = backward_args(*(x.repeat(b, 1, 1, 1) for x in (q, k, v)), cos, sin)
        cases[f"K4 ({b},24,4608,128)"] = lambda args=args: fa.flash_attention_backward(*args)
    q, k, v = qkv(1, 4608, d=64)
    cos, sin = demo_tables(512, 64, dev)
    cases["K1 (1,24,4608,64)"] = lambda: fa.flash_attention_rope(q, k, v, cos, sin)
    args = backward_args(q, k, v, cos, sin)
    cases["K4 (1,24,4608,64)"] = lambda args=args: fa.flash_attention_backward(*args)
    qd, kd, vd = qkv(16, 69, h=4, d=64)
    cos_d, sin_d = demo_tables(5, 8, dev)
    cases["K2 (16,4,69,64)"] = lambda: fa.flash_attention(qd, kd, vd)
    args_d = backward_args(qd, kd, vd, cos_d, sin_d)
    cases["K4 (16,4,69,64)"] = lambda: fa.flash_attention_backward(*args_d)
    qs, ks, vs = qkv(1, 9728, d=64)
    cases["K3 (1,24,9728,64)"] = lambda: fa.flash_attention_streaming(qs, ks, vs)

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
