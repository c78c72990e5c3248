"""Flash-attention forward sweep at the FLUX shape (1, 24, 4608, 128) on the card.

The port's counterpart of the JAX package's ``benchmarks/sweep_attention.py``.
The JAX script sweeps the Pallas forward over ``block_q``; the CUDA kernel has
one tiling (128-query CTAs, 128-key tiles), so the production line is K2
(``flash_attention``) once. Then the exp2 variant (``exp2_attn``,
``_exp2_kernel``: log2(e) folded into the scale), checked against an fp32
softmax at (1, 2, 4608, 128) (atol 2e-2) before it is timed; the plain PyTorch
path of the same function (``flash_attention_plain``, the counterpart of the
JAX script's "xla einsum"); and the tensor cores' speed of light. Run on the
card:

    python -m reptext_tpu_torch.benchmarks.sweep_attention
"""

from __future__ import annotations

import argparse

import torch

from reptext_tpu_torch.benchmarks import (
    B, D, H, S, check_correct, cuda_time_ms, random_qkv, require_cuda, tensor_core_ms,
)
from reptext_tpu_torch.ops.attention_variants import exp2_attn
from reptext_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain


def run(device="cuda") -> dict:
    """Times (ms): ``kernels`` (K2 and exp2, hand-written), ``plain_ms``,
    ``tensor_core_ms`` and the best kernel's share of it (``best_mfu``)."""
    device = require_cuda(device)
    q, k, v = random_qkv((B, H, S, D), 0, device)
    kernels = {"K2": cuda_time_ms(lambda: flash_attention(q, k, v)[0])}
    exp2_err = check_correct(exp2_attn, device)
    kernels["exp2 bq=256"] = cuda_time_ms(lambda: exp2_attn(q, k, v))
    sol = tensor_core_ms()
    return {"device": torch.cuda.get_device_name(device), "shape": [B, H, S, D],
            "kernels": kernels, "exp2_err": exp2_err,
            "plain_ms": cuda_time_ms(lambda: flash_attention_plain(q, k, v)[0]),
            "tensor_core_ms": sol, "best_mfu": sol / min(kernels.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    r = run(ap.parse_args(argv).device)
    print(f"{r['device']}, (B, H, S, D) = {tuple(r['shape'])}, bf16", flush=True)
    for name, ms in r["kernels"].items():
        print(f"cuda {name}: {ms:.3f} ms", flush=True)
    print(f"exp2 check: max err {r['exp2_err']:.1e} (atol 2e-2)")
    print(f"plain PyTorch: {r['plain_ms']:.3f} ms", flush=True)
    print(f"\ntensor-core speed of light (989 TF/s): {r['tensor_core_ms']:.3f} ms")
    print(f"best kernel MFU: {100 * r['best_mfu']:.1f}%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
