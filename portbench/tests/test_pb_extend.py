"""A later change adds a cell and a per-layer metric as new files and new
entries: in a temporary copy, both are picked up and no existing file changes."""

import hashlib
import json
import os
import shutil

from portbench import manifest


def digests(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in base:
                path = os.path.join(base, f)
                out[os.path.relpath(path, root)] = hashlib.sha256(open(path, "rb").read()).digest()
    return out


def test_new_cell_and_metric_are_files_and_entries(tmp_path):
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    pkg = tmp_path / "portbench"
    shutil.copytree(manifest.PKG, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path)

    # a traffic mix: data only, read by an existing driver
    mix = json.load(open(pkg / "traffic" / "t2i-1024-s30.json"))
    mix.update(requests=["latin"], steps=20, controlnet_steps=10)
    json.dump(mix, open(pkg / "traffic" / "t2i-1024-s20-latin.json", "w"))
    json.dump({"config": "flux1-dev-reptext", "traffic": "t2i-1024-s20-latin", "chips": 1,
               "limits": {"off4_pct": 2.0}},
              open(pkg / "workloads" / "t2i-1024-s20-latin.json", "w"))
    (pkg / "metrics" / "requests_traced.image.py").write_text(
        "def read(record):\n    return float(len(record['requests'])) or None\n")

    # the new entries, appended to the copy's BENCHMARK.json
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    bench["workloads"].append({"name": "t2i-1024-s20-latin", "config": "flux1-dev-reptext",
                               "traffic": "t2i-1024-s20-latin", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "requests_traced.image", "unit": "requests",
                               "better": "higher", "source": "host_clock", "layer": "cli",
                               "moves": "image_s", "workloads": ["t2i-1024-s20-latin"]})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))

    spec = manifest.resolve("t2i-1024-s20-latin", root=str(tmp_path), pkg=str(pkg))
    assert spec["traffic"]["steps"] == 20 and spec["traffic"]["requests"] == ["latin"]
    assert spec["workload"]["limits"] == {"off4_pct": 2.0}
    assert "requests_traced.image" in [m["name"] for m in spec["per_layer"]]
    got = manifest.read_metrics([m for m in spec["per_layer"]
                                 if m["name"] == "requests_traced.image"],
                                {"requests": [{}, {}]}, pkg=str(pkg))
    assert got == {"requests_traced.image": {"value": 2.0, "unit": "requests"}}
    # an old cell does not report the new metric
    old = manifest.resolve("t2i-1024-s30", root=str(tmp_path), pkg=str(pkg))
    assert "requests_traced.image" not in [m["name"] for m in old["per_layer"]]

    after = digests(tmp_path)
    changed = {k for k in before if before[k] != after.get(k)}
    assert changed == {"BENCHMARK.json"}
    assert set(after) - set(before) == {
        "portbench/traffic/t2i-1024-s20-latin.json", "portbench/workloads/t2i-1024-s20-latin.json",
        "portbench/metrics/requests_traced.image.py"}


def test_a_metric_that_finds_nothing_is_left_out(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "nothing.py").write_text("def read(record):\n    return None\n")
    assert manifest.read_metrics([{"name": "nothing", "unit": "%"}], {},
                                 pkg=str(tmp_path)) == {}
