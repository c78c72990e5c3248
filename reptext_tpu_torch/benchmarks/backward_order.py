"""K4 (the attention backward) on the card: its time and whether it repeats bit for bit.

For each shape (default: the 1024^2 request's (1, 24, 4608, 128), every train
launch's (2, 24, 4608, 128), and two lengths that end in a partial tile: the
union ControlNet's joint sequence at 1024^2 (4609: its mode token in front of
512 text and 4096 image tokens) and 5121), the forward runs through the RoPE entry (K1) on seeded bf16 inputs
with the real text/image tables, then ``flash_attention_backward`` is called
twice on the same inputs: dq, dk and dv must be bit-equal across the two
calls, and dq is held against the plain version within 2^-5 of max|plain dq|
(``chip_smoke.py``'s limit). Then the backward is timed with CUDA events
(the median of 20 calls after 3 warm-ups; one call is the preprocess pass,
the zeroing of the dq buffer and its counters, the main kernel and the
epilogue), ``--rounds`` times in turn. One JSON line per run, with the card's
name. Only the entry points shared by every version of the port since K4's
redesign are used, so the same script times another checkout's package when
that checkout comes first on ``PYTHONPATH``:

    python reptext_tpu_torch/benchmarks/backward_order.py
    PYTHONPATH=OTHER_CHECKOUT python reptext_tpu_torch/benchmarks/backward_order.py --label parent
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

SHAPES = ((1, 24, 4608), (2, 24, 4608), (1, 24, 4609), (1, 24, 5121))


def rope_tables(seq: int, device):
    """fp32 half-split tables of FLUX's ids at 1024^2: a 64 x 64 image grid
    behind ``seq - 4096`` zero text ids (512 T5 tokens; 513 with a union
    ControlNet's mode token)."""
    from reptext_tpu_torch.ops.latents import prepare_latent_image_ids
    from reptext_tpu_torch.ops.rope import rope_cos_sin_half

    ids = torch.cat([torch.zeros(seq - 4096, 3, device=device),
                     prepare_latent_image_ids(128, 128, device)])
    return rope_cos_sin_half(ids, (16, 56, 56), 10000)


def median_ms(fn, repeats: int = 20, warmup: int = 3) -> float:
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


def run(label: str, rounds: int, device="cuda") -> dict:
    from reptext_tpu_torch.ops import flash_attention as fa
    from reptext_tpu_torch.ops.rope import apply_rope_half

    if not torch.cuda.is_available():
        raise RuntimeError("K4 is timed on the card; torch.cuda.is_available() is False")
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(11)
    result = {"label": label, "device": torch.cuda.get_device_name(dev), "shapes": {}}
    for b, h, s in SHAPES:
        q, k, v = (torch.randn(b, h, s, 128, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        cos, sin = rope_tables(s, dev)
        out, lse = fa.flash_attention_rope(q, k, v, cos, sin)
        do = torch.randn(b, s, h, 128, generator=gen, device=dev).to(torch.bfloat16).transpose(1, 2)
        args = (apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin), v, out, lse, do)
        first = fa.flash_attention_backward(*args)
        second = fa.flash_attention_backward(*args)
        torch.cuda.synchronize()
        equal = [bool(torch.equal(x, y)) for x, y in zip(first, second)]
        diff = (first[0].float() - second[0].float()).abs().max().item()
        plain_dq = torch.cat([fa.flash_attention_backward_plain(
            *(x[:, i:i + 4] for x in args))[0] for i in range(0, h, 4)], dim=1)
        err = (first[0].float() - plain_dq.float()).abs().max().item()
        lim = 2.0 ** -5 * plain_dq.float().abs().max().item()
        times = [median_ms(lambda: fa.flash_attention_backward(*args)) for _ in range(rounds)]
        result["shapes"][f"({b},{h},{s},128)"] = {
            "ms": times, "dq_dk_dv_bit_equal": equal, "dq_run_to_run_max_abs": diff,
            "dq_vs_plain_max_abs": err, "dq_vs_plain_limit": lim, "dq_ok": err <= lim}
        del q, k, v, out, lse, do, args, first, second, plain_dq
        torch.cuda.empty_cache()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.label, args.rounds)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
