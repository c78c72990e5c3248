"""Can the exponentials overlap the products inside the flash kernel? (the card's A/B)

The port's counterpart of the JAX package's ``benchmarks/
exp_softmax_overlap.py``. On the TPU the question was whether the VPU's exp
overlaps the MXU; on the H100 the exponentials run on the special-function
unit beside the tensor cores. Measured against the production kernel (K2,
``flash_attention``) at (1, 24, 4608, 128) bf16:

1. *chunked online softmax* (``chunked_attn``, ``_chunked_kernel``): the
   running-max kernel; its 128-key tiles are the chunks, so ``block_q`` and
   ``n_chunks`` (the TPU's tiling, swept as the JAX script sweeps them) set
   nothing on the card but the correctness check's plain twin;
2. *bf16 exp* (``bf16exp_attn``, ``_bf16exp_kernel``): the exponential's
   argument rounded to bf16 and evaluated by ``ex2.approx.ftz.bf16x2``.

Each variant is first checked against an fp32 softmax at (1, 2, 4608, 128)
(atol 2e-2, 4e-2 for bf16 exp), as the JAX script checks it. Run on the card:

    python -m reptext_tpu_torch.benchmarks.exp_softmax_overlap
"""

from __future__ import annotations

import argparse

import torch

from reptext_tpu_torch.benchmarks import (
    B, D, H, S, check_correct, cuda_time_ms, random_qkv, require_cuda, tensor_core_ms,
)
from reptext_tpu_torch.ops.attention_variants import bf16exp_attn, chunked_attn
from reptext_tpu_torch.ops.flash_attention import flash_attention

TILINGS = [(bq, nc) for bq in (256, 512) for nc in (2, 4, 8)]


def run(device="cuda") -> dict:
    """Times (ms) and check errors: ``production_ms`` (K2), ``chunked`` (one
    entry per (block_q, n_chunks)), ``bf16exp``, ``tensor_core_ms``."""
    device = require_cuda(device)
    q, k, v = random_qkv((B, H, S, D), 0, device)
    result = {"device": torch.cuda.get_device_name(device), "shape": [B, H, S, D],
              "production_ms": cuda_time_ms(lambda: flash_attention(q, k, v)[0]),
              "chunked": []}
    for bq, nc in TILINGS:
        err = check_correct(lambda a, b, c, bq=bq, nc=nc: chunked_attn(a, b, c, bq, nc), device)
        ms = cuda_time_ms(lambda bq=bq, nc=nc: chunked_attn(q, k, v, bq, nc))
        result["chunked"].append({"block_q": bq, "n_chunks": nc, "ms": ms, "err": err})
    err = check_correct(bf16exp_attn, device, atol=4e-2)
    result["bf16exp"] = {"block_q": 256, "ms": cuda_time_ms(lambda: bf16exp_attn(q, k, v)),
                         "err": err}
    result["tensor_core_ms"] = tensor_core_ms()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    r = run(ap.parse_args(argv).device)
    print(f"{r['device']}, (B, H, S, D) = {tuple(r['shape'])}, bf16", flush=True)
    print(f"production (K2):              {r['production_ms']:.3f} ms", flush=True)
    for c in r["chunked"]:
        print(f"chunked bq={c['block_q']} chunks={c['n_chunks']}: {c['ms']:.3f} ms "
              f"(err {c['err']:.1e})", flush=True)
    print(f"bf16-exp bq=256:              {r['bf16exp']['ms']:.3f} ms "
          f"(err {r['bf16exp']['err']:.1e})", flush=True)
    print(f"tensor-core speed of light (989 TF/s): {r['tensor_core_ms']:.3f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
