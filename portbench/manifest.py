"""Everything the harness runs is found by name from ``BENCHMARK.json``.

A cell ``<workload>`` names its configuration (``configs`` entry -> its
``file``) and its traffic mix (``traffic/<traffic>.json``, whose ``driver``
is ``traffic/<driver>.py``); ``workloads/<workload>.json`` holds the limits
its correctness check compares against; each per-layer metric is the reader
``metrics/<metric>.py``. Adding a cell or a metric adds files and entries
and edits none."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(name: str, root: str = ROOT, pkg: str = PKG) -> dict:
    """The cell ``name``: its entry, its configuration, its traffic mix and
    its workload file, and the metrics it reports, each read from its file."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = read_json(os.path.join(pkg, "traffic", f"{cell['traffic']}.json"))
    workload = read_json(os.path.join(pkg, "workloads", f"{name}.json"))
    return {"name": name, "cell": cell, "config": config, "traffic": traffic,
            "workload": workload,
            "end_to_end": metrics_of(bench["end_to_end"], name),
            "per_layer": metrics_of(bench["per_layer"], name),
            "run_seconds": bench["run_seconds"]}


def metrics_of(entries: List[dict], cell: str) -> List[dict]:
    """The metrics that ``cell`` reports: those without ``workloads`` and
    those that list it."""
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def driver(traffic: dict):
    return importlib.import_module(f"portbench.traffic.{traffic['driver']}")


def reader(metric: str, pkg: str = PKG) -> Callable[[dict], Optional[float]]:
    """``read`` of ``metrics/<metric>.py`` (a file name may hold dots)."""
    path = os.path.join(pkg, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.m_{abs(hash(path))}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(per_layer: List[dict], record: dict, pkg: str = PKG) -> Dict[str, dict]:
    """Each per-layer metric its reader finds, with its unit; those that find
    nothing are left out."""
    out = {}
    for m in per_layer:
        value = reader(m["name"], pkg)(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
