"""The port's training data path and train CLI, on the CPU at tiny geometry.

GlyphTextDataset batches through the tiny port pipeline (shapes, step
determinism, the replaceable conditions, a batch that trains), the
PrefetchLoader (order, rollback, errors) and ``--mode train``; the twins of
tests/test_data.py.
"""

import math
import re

import numpy as np
import pytest
import torch

from reptext_tpu_torch import cli
from reptext_tpu_torch.configs import (
    CLIPConfig, ControlNetConfig, FluxConfig, PipelineConfig, T5Config, VAEConfig,
)
from reptext_tpu_torch.data import GlyphTextDataset, PrefetchLoader
from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline
from reptext_tpu_torch.sampling.train_controlnet import (
    init_controlnet_training, make_controlnet_train_step,
)

H = W = 64


@pytest.fixture(scope="module")
def dataset():
    pipe = FluxRepTextPipeline.create(
        FluxConfig().tiny(), ControlNetConfig().tiny(), VAEConfig().tiny(),
        PipelineConfig(height=H, width=W, num_inference_steps=2, controlnet_conditioning_step=1),
        clip_cfg=CLIPConfig().tiny(), t5_cfg=T5Config().tiny(), seed=0, device="cpu")
    return GlyphTextDataset(pipe, batch_size=2, seed=7)


def test_batch_shapes(dataset):
    cfg = dataset.pipe.pipe_cfg
    cn_cfg = dataset.pipe.controlnet.config
    s_img = cfg.image_seq_len
    b = dataset.batch(0)
    assert b["x0"].shape == (2, s_img, 64)
    assert b["cond_tokens"].shape == (2, s_img, cn_cfg.in_channels + cn_cfg.extra_condition_channels)
    assert b["token_mask"].shape == (2, s_img, 1)
    # T5 ids padded to the 512-token budget, as in serving
    assert b["prompt_embeds"].shape == (2, cfg.max_sequence_length, 32)
    assert b["pooled"].shape == (2, 32) and b["guidance"].shape == (2,)
    assert b["img_ids"].shape == (s_img, 3) and b["txt_ids"].shape == (cfg.max_sequence_length, 3)
    # masks are real text regions: nonzero somewhere, not everywhere
    m = b["token_mask"]
    assert 0 < float(m.sum()) < m.numel()
    # autograd may save every tensor (none was made in inference mode)
    assert not any(v.is_inference() for v in b.values() if v is not None)


def test_step_indexed_determinism(dataset):
    b1, b2, b3 = dataset.batch(3), dataset.batch(3), dataset.batch(4)
    for k in ("x0", "cond_tokens", "token_mask", "prompt_embeds"):
        assert torch.equal(b1[k], b2[k]), k
    assert not torch.equal(b1["x0"], b3["x0"])


def test_conditions_come_from_a_replaceable_method(dataset, monkeypatch):
    calls = []
    real = dataset.conditions

    def conditions(spec, step, index):
        calls.append((spec["text"], step, index))
        return real(spec, step, index)

    monkeypatch.setattr(dataset, "conditions", conditions)
    dataset.batch(5)
    assert [c[1:] for c in calls] == [(5, 0), (5, 1)]
    assert [c[0] for c in calls] == [dataset.sample_spec(5, i)["text"] for i in range(2)]


def test_prefetch_loader_sequential_and_rollback():
    calls = []

    def batch_fn(step):
        calls.append(step)
        return {"step": step}

    loader = PrefetchLoader(batch_fn, depth=2)
    try:
        assert [loader(i)["step"] for i in range(5)] == list(range(5))
        # rollback replay: jumping backward restarts prefetch at that step
        assert loader(2)["step"] == 2
        assert loader(3)["step"] == 3
        # skipping forward drains stale prefetched steps
        assert loader(6)["step"] == 6
    finally:
        loader.close()


def test_prefetch_loader_propagates_errors():
    def batch_fn(step):
        if step == 1:
            raise RuntimeError("bad batch")
        return step

    loader = PrefetchLoader(batch_fn, depth=1)
    try:
        assert loader(0) == 0
        with pytest.raises(RuntimeError, match="bad batch"):
            loader(1)
    finally:
        loader.close()


def test_a_batch_trains(dataset):
    """One warm-started ControlNet step on a dataset batch: a finite loss, and
    gradient reaches the heads through the saved condition tensors."""
    pipe = dataset.pipe
    cn_cfg = pipe.controlnet.config
    cn, opt = init_controlnet_training(pipe.flux, pipe.controlnet, cn_cfg.num_layers,
                                       cn_cfg.num_single_layers, learning_rate=1e-3)
    step = make_controlnet_train_step(cn, opt)
    loss = step(pipe.flux, dataset.batch(1), torch.Generator().manual_seed(0))
    assert math.isfinite(float(loss))
    assert cn.double_blocks[0].proj.weight.grad.abs().max() > 0
    assert cn.double_blocks[0].proj.weight.abs().max() > 0   # updated from zero


def test_train_cli_runs_and_reports_a_finite_loss(capsys):
    assert cli.main(["--mode", "train", "--tiny", "--device", "cpu", "--random-weights",
                     "--train-steps", "3",
                     "--batch-size", "2", "--size", "64"]) == 0
    out = capsys.readouterr().out
    assert out.count("[step]") == 3
    last = re.search(r"trained 3 steps: .* -> loss\(last 1 mean\)=([-\d.naif]+)", out)
    assert last and np.isfinite(float(last.group(1))), out


@pytest.mark.parametrize("argv,match", [
    (["--mode", "serve", "--shard", "sp2"], "not ported"),   # serving under SP
    (["--mode", "inpaint", "--shard", "2x4"], "not ported"),
    (["--mode", "train", "--shard", "2x4"], "--shard is not ported"),
])
def test_cli_refuses_what_is_not_ported(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(argv + ["--tiny", "--random-weights"])


def test_txt2img_still_needs_text_and_position():
    with pytest.raises(SystemExit):
        cli.main(["--tiny", "--random-weights"])
