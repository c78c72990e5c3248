"""A measurement path without a card fails, prints no result and does not
fall back to the CPU; so does a checkout that holds only the benchmark."""

import os
import shutil
import subprocess
import sys

import pytest

from portbench import manifest

ARGS = ["--workload", "t2i-1024-s30", "--seed", "4294967311", "--seconds", "1", "--trace", "0"]


def test_main_without_a_card(capsys, monkeypatch):
    import torch

    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(ARGS) != 0
    assert capsys.readouterr().out == ""


def test_main_with_too_few_cards(capsys, monkeypatch):
    import torch

    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(ARGS) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("only_the_benchmark", [False, True])
def test_the_command_exits_non_zero_with_no_result(tmp_path, only_the_benchmark):
    root = manifest.ROOT
    if only_the_benchmark:
        shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp_path)
        shutil.copytree(manifest.PKG, tmp_path / "portbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        root = str(tmp_path)
    bench = manifest.load_benchmark()
    cmd = [sys.executable if w == "python3" else w for w in bench["command"]]
    out = subprocess.run(cmd + ARGS, cwd=root, capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout.strip() == ""
