"""Nothing the benchmark runs loads JAX, Flax or the JAX package; the plain
reference loads nothing of the program either. Top-level names are compared
whole: the port's ``reptext_tpu_torch`` begins with ``reptext_tpu``."""

import os
import subprocess
import sys
import textwrap

from portbench import harness, manifest

ENV = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}


def loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code) + textwrap.dedent("""
        import sys
        print("MODULES", " ".join(sorted({m.split('.')[0] for m in sys.modules})))
        """)], cwd=manifest.ROOT, env=ENV, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("MODULES ")][-1]
    return set(line.split()[1:])


def test_names_compare_whole():
    assert harness.forbidden_modules(["reptext_tpu_torch", "reptext_tpu_torch.cli",
                                      "portbench.run", "jaxtyping"]) == []
    assert harness.forbidden_modules(["reptext_tpu.ops", "jax", "jaxlib.xla_client",
                                      "flax.linen"]) == ["flax.linen", "jax", "jaxlib.xla_client",
                                                         "reptext_tpu.ops"]


def test_a_whole_run_loads_no_jax():
    """A run of the harness end to end (tiny geometry on the CPU: the path a
    card run takes but the kernels), then its modules."""
    tops = loaded_after("""
        import tempfile, time, torch
        torch.set_num_threads(2)
        import portbench.run
        from portbench import harness
        from portbench.tests import tiny
        with tempfile.TemporaryDirectory() as d:
            spec = tiny.spec("t2i-1024-s30", d, steps=1)
            harness.run(spec, 3, 0.01, True, "cpu", time.perf_counter(), data_dir=d)
        """)
    assert "reptext_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    tops = loaded_after("""
        import portbench.reference.pipeline, portbench.reference.nets, portbench.reference.host
        """)
    assert not tops & (set(harness.FORBIDDEN) | {"reptext_tpu_torch"})


def test_reference_sources_import_nothing_of_the_program():
    ref = os.path.join(manifest.PKG, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            text = open(os.path.join(ref, name)).read()
            for word in ("reptext_tpu", "jax", "flax"):
                assert f"import {word}" not in text and f"from {word}" not in text, name
