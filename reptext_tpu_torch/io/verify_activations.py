"""Per-layer activation capture and diffing for weight-conversion validation.

Counterpart of ``reptext_tpu/io/verify_activations.py``, with its names and
its report: conversion errors in a 12B model surface only as subtle image
degradation, so a converted model is checked layer by layer against recorded
activations.

- :func:`capture_activations`: run a module with a forward hook on every named
  submodule and return a flat {path: array} dict of their outputs, in the JAX
  function's path format: the module path with ``/`` between names, then the
  call's index within the forward (a module called twice gives ``/0`` and
  ``/1``), then the position inside a tuple or list output; the module
  itself is ``__call__``. The port's modules name their submodules after the
  Flax tree, so most paths match the JAX capture's, but for the scanned
  stacks.
- :func:`diff_activations`: compare against a recorded reference and report
  per-layer max-abs and relative errors, worst first.
- :func:`save_activations` / :func:`load_activations`: .npz round trip.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def _flatten(out: Any, prefix: str) -> Dict[str, np.ndarray]:
    """Tensors (and numbers) in a nested output, by position; None skipped."""
    flat: Dict[str, np.ndarray] = {}
    if out is None:
        return flat
    if isinstance(out, dict):
        for k, v in out.items():
            flat.update(_flatten(v, f"{prefix}/{k}"))
    elif isinstance(out, (tuple, list)):
        for i, v in enumerate(out):
            flat.update(_flatten(v, f"{prefix}/{i}"))
    elif isinstance(out, torch.Tensor):
        flat[prefix] = out.detach().float().cpu().numpy()
    else:
        arr = np.asarray(out)
        if arr.dtype != object:
            flat[prefix] = arr
    return flat


@torch.no_grad()
def capture_activations(model: torch.nn.Module, *args, **kwargs) -> Dict[str, np.ndarray]:
    """Forward pass capturing every submodule's output (see the module note).

    Returns {module_path/call_index[/position]: activation as float32 numpy}.
    """
    acts: Dict[str, np.ndarray] = {}
    calls: Dict[str, int] = {}

    def hook(path):
        def record(_module, _inputs, output):
            n = calls.get(path, 0)
            calls[path] = n + 1
            acts.update(_flatten(output, f"{path}/{n}"))
        return record

    handles = [m.register_forward_hook(hook(name.replace(".", "/") if name else "__call__"))
               for name, m in model.named_modules()]
    try:
        model(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    return acts


def diff_activations(
    ours: Dict[str, np.ndarray],
    reference: Dict[str, np.ndarray],
    rtol_warn: float = 1e-2,
) -> List[Tuple[str, float, float]]:
    """Compare activation dicts; returns [(path, max_abs_err, rel_err)] sorted
    worst-first. Paths present in only one dict, or of another shape, are
    reported with inf."""
    report: List[Tuple[str, float, float]] = []
    for path in sorted(set(ours) | set(reference)):
        if path not in ours or path not in reference:
            report.append((path, float("inf"), float("inf")))
            continue
        a = np.asarray(ours[path], np.float32)
        b = np.asarray(reference[path], np.float32)
        if a.shape != b.shape:
            report.append((path, float("inf"), float("inf")))
            continue
        abs_err = float(np.max(np.abs(a - b))) if a.size else 0.0
        denom = float(np.max(np.abs(b))) + 1e-9
        report.append((path, abs_err, abs_err / denom))
    report.sort(key=lambda r: r[2], reverse=True)
    return report


def save_activations(acts: Dict[str, np.ndarray], path: str) -> None:
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in acts.items()})


def load_activations(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def print_report(report: List[Tuple[str, float, float]], top: int = 20) -> None:
    print(f"{'rel_err':>10} {'max_abs':>10}  path")
    for path, abs_err, rel in report[:top]:
        print(f"{rel:10.3e} {abs_err:10.3e}  {path}")
