"""The benchmark of the port, one run of one cell.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or its
per-layer ones with ``--trace 1``), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared with its limit
(also the last lines of standard error). Exits non-zero with no result when
there is no CUDA device or fewer than the cell asks for, when the program
cannot be imported, or when JAX, Flax or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench")
# every compile and kernel cache at a fixed path inside the checkout; the
# port's own nvcc build goes to reptext_tpu_torch/_build/ there
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("CUDA_CACHE_PATH", "cuda"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(CACHE, _sub)
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(message: str) -> int:
    print(f"[portbench] {message}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import manifest

    spec = manifest.resolve(args.workload)
    import torch

    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available():
        return fail("no CUDA device (torch.cuda.is_available() is False): nothing is measured")
    if torch.cuda.device_count() < chips:
        return fail(f"the cell needs {chips} CUDA devices, {torch.cuda.device_count()} found")
    try:
        import reptext_tpu_torch  # noqa: F401
    except ImportError as e:
        return fail(f"the program (reptext_tpu_torch) cannot be imported: {e}")
    from portbench import harness

    result = harness.run(spec, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    bad = harness.forbidden_modules()
    if bad:
        return fail(f"modules of JAX or of the JAX package were loaded: {bad}")
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
