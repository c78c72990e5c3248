"""Fidelity gates against the trained demo checkpoint, on the port.

Counterpart of ``benchmarks/trained_gates.py``: every sampling variant that
could cost legibility is scored by the frozen OCR judge on the same
fixed-seed samples of the trained checkpoint that
``reptext_tpu_torch/examples/overfit_e2e.py --params-cache DIR`` writes:

- the uncached reference;
- the fixed-interval velocity cache (interval 2, ``linear``, warmup of a
  third of the steps);
- the adaptive velocity cache (``adaptive-linear``, threshold 0.05, at most 3
  skips in a row);
- fp8 weight-only storage (``quantize_weights()`` on the fp32 demo pipeline;
  ``QuantLinear`` dequantizes into fp32 there).

Gate: base accuracy >= 0.9 and each variant's delta < 0.05
(``--allow-low-accuracy`` lifts the base-accuracy assertion for wiring runs on
an under-trained checkpoint). Beside each variant's accuracy it prints its
sampler ms/step and its forward attention launches: a step the cache skips
launches none, so the launches show how many steps it skipped. Writes its
own JSON (default ``reptext_tpu_torch/benchmarks/trained_gates.json``).

Usage:
    python -m reptext_tpu_torch.examples.overfit_e2e --holdout --params-cache DIR
    python -m reptext_tpu_torch.benchmarks.trained_gates --params-cache DIR
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

DEFAULT_OUTPUT = str(Path(__file__).resolve().parent / "trained_gates.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--params-cache", default="results/overfit_ckpt")
    ap.add_argument("--steps-sample", type=int, default=20)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--adaptive-threshold", type=float, default=0.05)
    ap.add_argument("--output", default=DEFAULT_OUTPUT)
    ap.add_argument("--allow-low-accuracy", action="store_true",
                    help="wiring checks on under-trained checkpoints: skip the "
                         "base-accuracy>=0.9 exit assertion")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    from reptext_tpu_torch.examples.overfit_e2e import (
        TRAIN_WORDS, build_overfit_set, build_pipeline, device_info, load_judge,
        precompute_batch, sample_and_score,
    )
    from reptext_tpu_torch.io.checkpoint import load_pipeline_params

    device = torch.device(args.device)
    saved = load_pipeline_params(args.params_cache, ("vae", "flux", "controlnet"))
    judge = load_judge(device)
    # all 16 training words: one misread word is 0.0625, not 0.125
    samples = build_overfit_set(args.size, words=TRAIN_WORDS)
    pipe = build_pipeline(args.size, args.steps_sample, device)
    for name in ("vae", "flux", "controlnet"):
        getattr(pipe, name).load_state_dict(saved[name])
    base_cfg = pipe.pipe_cfg
    batch = precompute_batch(pipe, samples)
    warmup = max(args.steps_sample // 3, 1)

    def run(label, view):
        res = sample_and_score(view, samples, batch, args.steps_sample, judge)
        per_image = res["attention_launches"] / len(samples)
        print(f"      {label}: char accuracy {res['char_accuracy']:.4f}, "
              f"{res['sample_ms_per_step']:.2f} ms/step, {per_image:.1f} forward attention "
              f"launches per image", flush=True)
        return res

    print("[1/4] uncached reference...", flush=True)
    res_ref = run("uncached", pipe)
    print("[2/4] fixed-interval velocity cache (interval 2)...", flush=True)
    res_vc = run("fixed cache", pipe.with_config(dataclasses.replace(
        base_cfg, velocity_cache_interval=2, velocity_cache_warmup=warmup,
        velocity_cache_mode="linear")))
    print("[3/4] adaptive velocity cache...", flush=True)
    res_ad = run("adaptive cache", pipe.with_config(dataclasses.replace(
        base_cfg, velocity_cache_mode="adaptive-linear",
        velocity_cache_threshold=args.adaptive_threshold, velocity_cache_warmup=warmup,
        velocity_cache_max_skip=3)))
    print("[4/4] fp8 weight-only storage...", flush=True)
    # quantize_weights() gives the view new quantized modules; pipe keeps its own
    res_fp8 = run("fp8 weights", pipe.with_config(base_cfg).quantize_weights())

    acc = res_ref["char_accuracy"]
    variants = {"uncached": res_ref, "vc_fixed": res_vc, "vc_adaptive": res_ad,
                "fp8w": res_fp8}
    name, limit = device_info(device)
    out = {
        "protocol": "trained demo checkpoint (%s), %d words, %d^2, %d steps, seed-fixed" % (
            args.params_cache, len(samples), args.size, args.steps_sample),
        "weights": "trained (overfit_e2e demo checkpoint)",
        "char_accuracy_uncached": round(acc, 4),
        "char_accuracy_vc_fixed": round(res_vc["char_accuracy"], 4),
        "char_accuracy_vc_adaptive": round(res_ad["char_accuracy"], 4),
        "char_accuracy_fp8w": round(res_fp8["char_accuracy"], 4),
        "vc_fixed_delta": round(acc - res_vc["char_accuracy"], 4),
        "vc_adaptive_delta": round(acc - res_ad["char_accuracy"], 4),
        "fp8w_delta": round(acc - res_fp8["char_accuracy"], 4),
        "adaptive_threshold": args.adaptive_threshold,
        "base_accuracy_acceptable": bool(acc >= 0.9),
        "vc_fixed_acceptable": bool(acc - res_vc["char_accuracy"] < 0.05),
        "vc_adaptive_acceptable": bool(acc - res_ad["char_accuracy"] < 0.05),
        "fp8w_acceptable": bool(acc - res_fp8["char_accuracy"] < 0.05),
        "mean_edge_iou_uncached": round(res_ref["mean_edge_iou"], 4),
        "mean_edge_iou_vc_fixed": round(res_vc["mean_edge_iou"], 4),
        "mean_edge_iou_fp8w": round(res_fp8["mean_edge_iou"], 4),
        "sample_ms_per_step": {k: r["sample_ms_per_step"] for k, r in variants.items()},
        "attention_launches_per_image": {k: r["attention_launches"] / len(samples)
                                         for k, r in variants.items()},
        "device": name,
        "power_limit": limit,
    }
    Path(args.output).parent.mkdir(parents=True, exist_ok=True)
    Path(args.output).write_text(json.dumps(out, indent=1))
    print(json.dumps(out, indent=1))
    print(f"wrote {args.output}")
    if not args.allow_low_accuracy:
        assert out["base_accuracy_acceptable"], out
    return 0


if __name__ == "__main__":
    sys.exit(main())
