"""The port's tools against the JAX package's: per-layer activation capture
and diffing (``io/verify_activations.py``), tracing and step timing
(``utils/profiling.py``), the attention backend switch
(``ops/attention.py::set_default_backend``) and the CLI's
``--attention-backend``; and what the kernel wrappers take (head dims 32, 64
and 128, bf16 and fp32), checked without a launch. CPU, float32.

Tolerances: activations within 5e-4 of each layer's max|JAX activation|
(fp32 through the blocks, sums in another order); reports and file round
trips exactly.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reptext_tpu.io import verify_activations as jva
from reptext_tpu.models.flux import FluxTransformer2D as JFlux
from reptext_tpu.ops import attention as jattn
from reptext_tpu.utils import profiling as jprof
from reptext_tpu_torch import cli
from reptext_tpu_torch.io import verify_activations as tva
from reptext_tpu_torch.models.flux import FluxTransformer2D
from reptext_tpu_torch.ops import attention as tattn
from reptext_tpu_torch.ops import flash_attention as fa
from reptext_tpu_torch.utils import profiling as tprof

from test_torch_train import B, FLUX_CFG, _batch, _trees
from torch_port_util import carried, port_config, t


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these tests run tiny models as thousands of small
    ops, which the test tier's workers, sharing the host's cores, slow by two
    orders of magnitude with a pool of threads each; the thread count is put
    back after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def default_backend():
    """Every test here leaves the process-wide backend at 'auto'."""
    yield
    tattn.set_default_backend("auto")


# ------------------------------------------------------ activation capture


@functools.lru_cache(maxsize=None)
def _flux_activations():
    b = _batch()
    flux_tree, _ = _trees()
    args = (b["x0"], b["prompt_embeds"], b["pooled"], np.zeros((B,), np.float32), b["img_ids"],
            b["txt_ids"], b["guidance"])
    want = jva.capture_activations(JFlux(FLUX_CFG), flux_tree, *map(jnp.asarray, args))
    module = carried(FluxTransformer2D(port_config(FLUX_CFG)), flux_tree)
    return tva.capture_activations(module, *map(t, args)), want


def _unstacked(jax_acts, n_layers):
    """The JAX capture with its scanned stacks ("double_blocks/block/...",
    one leading layer axis) split into the port's per-layer paths."""
    out = {}
    for path, arr in jax_acts.items():
        stack = path.split("/")[0]
        if stack in n_layers and path.split("/")[1] == "block":
            for i in range(n_layers[stack]):
                out[f"{stack}/{i}/" + path.split("/", 1)[1]] = np.asarray(arr)[i]
        else:
            out[path] = np.asarray(arr)
    return out


def test_capture_and_diff_match_the_jax_tool_on_the_tiny_flux():
    """Every layer the port captures, against the JAX capture of the same
    FLUX on the same inputs (the scanned stacks split per layer): the paths
    agree, each within tolerance of the other; diff_activations and
    print_report give the JAX functions' report on the same dicts."""
    ours, want = _flux_activations()
    assert ours["__call__/0"].shape == np.asarray(want["__call__/0"]).shape
    ref = _unstacked(want, {"double_blocks": FLUX_CFG.num_layers,
                            "single_blocks": FLUX_CFG.num_single_layers})
    common = set(ours) & set(ref)
    assert {"__call__/0", "x_embedder/0", "context_embedder/0", "proj_out/0",
            "double_blocks/1/block/to_q/0", "single_blocks/3/block/proj_out/0"} <= common
    assert len(common) >= 0.9 * len(ours)
    for path in common:
        err = np.abs(ours[path] - ref[path]).max()
        assert err <= 5e-4 * max(np.abs(ref[path]).max(), 1e-6), path
    report = tva.diff_activations(ours, ref)
    assert report == jva.diff_activations(ours, ref)
    assert [p for p, a, _ in report if a == float("inf")] == sorted(set(ours) ^ set(ref))
    assert all(r <= 5e-4 for _, _, r in report if np.isfinite(r))


def test_report_print_and_file_round_trip(tmp_path, capsys):
    ours, _ = _flux_activations()
    path = str(tmp_path / "acts.npz")
    tva.save_activations(ours, path)
    back = tva.load_activations(path)
    assert set(back) == set(ours) and all(np.array_equal(back[k], ours[k]) for k in ours)
    assert jva.load_activations(path).keys() == back.keys()
    shifted = {k: v + (1.0 if k == "proj_out/0" else 0.0) for k, v in ours.items()}
    report = tva.diff_activations(shifted, ours)
    assert report[0][0] == "proj_out/0" and report[-1][1] == 0.0
    tva.print_report(report, top=5)
    mine = capsys.readouterr().out
    jva.print_report(report, top=5)
    assert mine == capsys.readouterr().out and len(mine.splitlines()) == 6


def test_a_module_called_twice_is_captured_per_call():
    lin = torch.nn.Linear(3, 2)
    seq = torch.nn.Module()
    seq.lin = lin

    def forward(x):
        return seq.lin(seq.lin(x[..., :3])[..., :1].repeat(1, 3)), torch.zeros(1)

    seq.forward = forward
    acts = tva.capture_activations(seq, torch.ones(1, 3))
    assert {"lin/0", "lin/1", "__call__/0/0", "__call__/0/1"} == set(acts)


# ------------------------------------------------------------- profiling


def test_step_timer_matches_the_jax_interface():
    ours, ref = tprof.StepTimer(warmup=2, device="cpu"), jprof.StepTimer(warmup=2)
    for timer in (ours, ref):
        assert timer.summary() == {"steps": 0}
        for _ in range(5):
            with timer.step():
                sum(range(1000))
    assert len(ours.times) == len(ref.times) == 3
    s = ours.summary()
    assert set(s) == set(ref.summary()) and s["steps"] == 3
    assert s["min_s"] <= s["p50_s"] <= s["max_s"] and s["min_s"] > 0


def test_the_card_is_the_default_and_never_a_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the refusal is the CPU host's")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprof.StepTimer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with tprof.device_trace(str(tmp_path)):
            pass


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with tprof.device_trace(str(tmp_path / "trace"), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    assert any("mm" in e.key for e in prof.key_averages())


# ----------------------------------------------- the attention backend switch


def test_backend_names_and_errors_are_the_jax_ones(default_backend):
    assert tattn.get_default_backend() == jattn.get_default_backend() == "auto"
    for name in ("xla", "pallas", "auto"):
        tattn.set_default_backend(name)
        assert tattn.get_default_backend() == name
    for mod in (tattn, jattn):
        with pytest.raises(ValueError, match="unknown attention backend 'triton'"):
            mod.set_default_backend("triton")
    assert tattn.get_default_backend() == "auto"


def _qkv(s=16, d=32):
    r = np.random.default_rng(0)
    return [t(r.standard_normal((1, 2, s, d))) for _ in range(3)]


def test_backends_on_cpu_tensors(default_backend):
    """auto and xla run the plain version on the CPU; pallas names the
    kernels, which take CUDA tensors: a CPU call raises (no fallback)."""
    q, k, v = _qkv()
    want = tattn.plain_attention(q, k, v)
    for name in ("auto", "xla"):
        tattn.set_default_backend(name)
        assert torch.equal(tattn.attention(q, k, v), want)
    tattn.set_default_backend("pallas")
    with pytest.raises(ValueError, match="'pallas' attention backend"):
        tattn.attention(q, k, v)
    assert torch.equal(tattn.attention(q, k, v, backend="xla"), want)
    with pytest.raises(ValueError, match="unknown attention backend"):
        tattn.attention(q, k, v, backend="cuda")


def test_cli_attention_backend(default_backend):
    args = cli.build_parser().parse_args(
        ["--mode", "train", "--tiny", "--device", "cpu", "--random-weights", "--size", "64",
         "--attention-backend", "xla"])
    assert args.attention_backend == "xla"
    cli.build_pipeline(args)
    assert tattn.get_default_backend() == "xla"
    assert cli.build_parser().parse_args(["--tiny"]).attention_backend == "auto"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--attention-backend", "cudnn"])


# ---------------------------------------- what the kernel wrappers take


def _passes_to_the_device_check(d, dtype):
    """Head dim and dtype pass the checks; the next one is the device (a CPU
    tensor never reaches a kernel)."""
    fa.check_head_dim(d)
    x = torch.zeros(1, 2, 8, d, dtype=dtype)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa._check("q", x, x.shape)


@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16), (64, torch.float32),
                                     (128, torch.bfloat16), (128, torch.float32)])
def test_the_wrappers_take_head_dims_64_128_in_bf16_and_fp32(d, dtype):
    _passes_to_the_device_check(d, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_wrappers_take_head_dim_32_in_bf16_and_fp32(dtype):
    _passes_to_the_device_check(32, dtype)


def test_the_wrappers_refuse_head_dim_32_fp16_and_the_ring_fp32():
    """What the wrappers refuse now that head dim 32 and K5 in fp32 are
    taken (the name is the one this test had when it refused both): a head
    dim of none of the instantiations (48), fp16 and fp64, a dtype outside
    the ones asked for, a wrong shape."""
    from reptext_tpu_torch.ops import ring_attention as ra

    with pytest.raises(ValueError, match="head dim 48"):
        fa.check_head_dim(48)
    for d in (32, 64, 128):                               # K5 takes them all, as K1-K4
        fa.check_head_dim(d, ra._SUPPORTED_HEAD_DIMS)
    with pytest.raises(ValueError, match="head dim 48"):
        fa.check_head_dim(48, ra._SUPPORTED_HEAD_DIMS)
    x = torch.zeros(1, 2, 8, 64)
    with pytest.raises(TypeError, match="float16 is rejected"):
        fa._check("q", x.half(), x.shape)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa._check("q", x.double(), x.shape)
    with pytest.raises(TypeError, match="must be bfloat16, got torch.float32"):
        fa._check("q", x, x.shape, (torch.bfloat16,))
    with pytest.raises(ValueError, match="shape"):
        fa._check("q", x.to(torch.bfloat16), (1, 2, 8, 128))


# ------------------------------------------- the ControlNet training example


def test_train_controlnet_example_trains_on_the_cpu():
    """examples/train_controlnet.py's protocol: warm start, the region-weighted
    loss under the ElasticTrainer, 20 steps, the loss down."""
    from reptext_tpu_torch.examples import train_controlnet

    losses = train_controlnet.main(20, "cpu")
    assert len(losses) == 20 and losses[-1] < losses[0]
