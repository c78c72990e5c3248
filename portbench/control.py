"""The check's readings for a cell, one process for many seeds.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 [--faults] [--fp32-reference]

For each seed: the weights drawn, the program built, one request of the
cell's traffic through the timed path (the lower reading: the program
against the plain reference); with ``--faults`` the same request with each
fault of ``faults.py`` planted; then the same request with the program's
own lower-precision path switched on, fp8 weight-only storage of FLUX's and
the ControlNet's block stacks (``quantize_weights()``: the control, which
has to fail); then the reference. ``--fp32-reference`` adds the reference
with TF32 off and reads how far the TF32 reference itself lies from it. One
JSON line per seed on standard output. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import check, faults, harness, manifest, program


def readings(spec: dict, seed: int, device, fp32_reference: bool = False,
             planted: tuple = (), warm: bool = True, data_dir=None,
             log=lambda m: print(m, file=sys.stderr, flush=True)) -> dict:
    cfg, mix = spec["config"], spec["traffic"]
    driver = manifest.driver(mix)
    data = driver.load(mix) if data_dir is None else driver.load(mix, data_dir)
    req = driver.make_request(mix, data, seed, seed % len(mix["requests"]))
    t0 = time.perf_counter()
    weights = program.draw_weights(cfg, seed, device)
    pipe = driver.build(cfg, weights, mix, req, device)
    if warm:
        driver.run(pipe, driver.make_request(mix, data, seed, 0, steps=mix["warmup_steps"]))
    got = driver.run(pipe, req)
    faulty = {}
    for name in planted:
        with faults.FAULTS[name]():
            faulty[name] = driver.run(pipe, req)
    pipe.quantize_weights()
    low = driver.run(pipe, req)
    del pipe, weights
    program.free()
    log(f"[control] seed {seed}: the program's requests {time.perf_counter() - t0:.1f} s")
    out = {"seed": seed, "request": req["name"], "request_seed": req["seed"]}
    images = {}
    for label, matmul in (("tf32", True), ("fp32", False))[:2 if fp32_reference else 1]:
        t0 = time.perf_counter()
        torch.backends.cuda.matmul.allow_tf32 = matmul and cfg["reference"]["matmul"] == "tf32"
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32
        weights = program.draw_weights(cfg, seed, device)
        want = images[label] = driver.reference(weights, cfg, req, device)
        del weights
        program.free()
        out[label] = {"program": check.numbers(got, want), "control": check.numbers(low, want),
                      "faults": {k: check.numbers(v, want) for k, v in faulty.items()},
                      "reference_s": time.perf_counter() - t0}
    if fp32_reference:
        out["tf32_vs_fp32"] = check.numbers(images["tf32"], images["fp32"])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", action="store_true", help="plant each fault of faults.py too")
    p.add_argument("--fp32-reference", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("[control] no CUDA device", file=sys.stderr)
        return 2
    spec = manifest.resolve(args.workload)
    planted = tuple(faults.FAULTS) if args.faults else ()
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        out = readings(spec, seed, "cuda:0", args.fp32_reference, planted, warm=i == 0)
        print(json.dumps(out), flush=True)
    if harness.forbidden_modules():
        print(f"[control] forbidden modules: {harness.forbidden_modules()}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
