"""BENCHMARK.json against the benchmark's contract, and every file it names."""

import json
import os
import re

import pytest

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert os.path.isdir(os.path.join(manifest.ROOT, p)) and not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"] and "\t" not in c["why"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert len(CELLS) == len(set(CELLS))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_resolves(cell):
    spec = manifest.resolve(cell)
    assert spec["workload"]["config"] == spec["cell"]["config"]
    assert spec["workload"]["traffic"] == spec["cell"]["traffic"]
    assert spec["workload"]["chips"] == spec["cell"]["chips"]
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert manifest.driver(spec["traffic"]).run
    for m in spec["per_layer"]:
        assert callable(manifest.reader(m["name"]))
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and spec["per_layer"]


def test_config_files_are_their_own_and_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p.rstrip("/") + "/") for p in BENCH["paths"])
        cfg = manifest.read_json(os.path.join(manifest.ROOT, c["file"]))
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]


@pytest.mark.parametrize("cell", CELLS)
def test_configs_hold_the_published_geometry(cell):
    """Every group of the file builds the port's config, at its published
    sizes: the port's defaults (FLUX.1-dev, RepText's net, T5-XXL, CLIP-L)."""
    from reptext_tpu_torch import configs as C

    from portbench import program

    got = program.port_configs(manifest.resolve(cell)["config"])
    want = {"flux": C.FluxConfig(), "controlnet": C.ControlNetConfig(), "vae": C.VAEConfig(),
            "clip": C.CLIPConfig(), "t5": C.T5Config()}
    for name, c in got.items():
        assert c == want[name], name
