"""The inpainting cell's path on the CPU at the tiny geometry (float32):
the port's inpaint pipeline through the benchmark's driver
(``portbench/traffic/inpaint.py``: ``cli.generate_inpaint`` over
``FluxRepTextInpaintPipeline``) against the plain reference
(``portbench/reference/inpaint.py``), which imports nothing of the port;
the pipeline's sampler route (``_inpaint_sampler``) against a direct
``make_inpaint_sampler`` call; and the request's draws from its seed."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench import check, program
from portbench.tests.test_pb_inpaint import tiny_spec
from portbench.traffic import inpaint as driver
from reptext_tpu_torch.ops.latents import prepare_latent_image_ids
from reptext_tpu_torch.sampling.sampler_inpaint import make_inpaint_sampler

SEED = 2_100_000_301


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    """The tiny cell's spec, its data, and the first request of the window."""
    torch.set_num_threads(2)
    d = tmp_path_factory.mktemp("inpaint_cell")
    spec = tiny_spec(d, steps=3)
    data = driver.load(spec["traffic"], str(d))
    return spec, data, driver.make_request(spec["traffic"], data, SEED, 0)


def program_image(spec, request, dtype="float32"):
    cfg = dict(spec["config"], dtype=dtype)
    pipe = driver.build(cfg, program.draw_weights(cfg, SEED, "cpu"), spec["traffic"], request,
                        "cpu")
    return driver.run(pipe, request)


def test_the_program_matches_the_plain_reference(cell):
    """float32 against the float32 reference: equal images; the same request
    computed in bf16 lies beyond the limit the float32 run keeps."""
    spec, _, request = cell
    cfg = spec["config"]
    want = driver.reference(program.draw_weights(cfg, SEED, "cpu"), cfg, request, "cpu")
    got = check.numbers(program_image(spec, request), want)
    assert got["off4_pct"] == 0.0 and got["image_mad"] < 0.05, got
    low = check.numbers(program_image(spec, request, "bfloat16"), want)
    assert low["image_mad"] > 0.05, low


def test_the_sampler_route_is_the_direct_sampler_bit_for_bit(cell, monkeypatch):
    """A request through ``_inpaint_sampler`` gives the latents, bit for bit,
    that a direct ``make_inpaint_sampler`` call over the pipeline's models
    gives for it (the route before the sampler had its method)."""
    spec, _, request = cell
    cfg = spec["config"]
    pipe = driver.build(cfg, program.draw_weights(cfg, SEED, "cpu"), spec["traffic"], request,
                        "cpu")
    args = driver.cli_args(request)
    kw = dict(output_type="latent")

    def direct(self, schedule, cond_tokens, token_masks, inpaint_cond, ctx_cfg, pooled_cfg,
               gscale, tscale):
        pcfg = dataclasses.replace(self.pipe_cfg, true_guidance_scale=tscale)
        sampler = make_inpaint_sampler(self.flux, self.controlnet, self.inpaint_controlnet,
                                       schedule, pcfg, self.inpaint_conditioning_scale,
                                       self.compute_dtype)
        img_ids = prepare_latent_image_ids(pcfg.latent_height, pcfg.latent_width, self.device)
        txt_ids = torch.zeros((ctx_cfg.shape[1], 3), device=self.device)
        return lambda lat: sampler(lat, cond_tokens, token_masks, inpaint_cond, ctx_cfg,
                                   pooled_cfg, txt_ids, img_ids,
                                   torch.full((lat.shape[0],), gscale, dtype=torch.float32))

    from reptext_tpu_torch import cli

    view = driver.condition_view(request)
    routed = cli.generate_inpaint(args, pipe, view, request["image"], request["mask"], **kw)
    monkeypatch.setattr(type(pipe), "_inpaint_sampler", direct)
    plain = cli.generate_inpaint(args, pipe, view, request["image"], request["mask"], **kw)
    assert torch.equal(routed, plain)


def test_a_request_seed_gives_the_same_photo_mask_and_image(cell):
    spec, data, request = cell
    mix = spec["traffic"]
    again = driver.make_request(mix, data, SEED, 0)
    assert again["seed"] == request["seed"] and again["run_seed"] == SEED
    assert np.array_equal(again["image"], request["image"])
    assert np.array_equal(again["mask"], request["mask"])
    other = driver.make_request(mix, data, SEED, 1)
    assert other["seed"] != request["seed"]
    assert not np.array_equal(other["image"], request["image"])
    # the mask is the line's region box grown by the margin, whatever the seed
    assert np.array_equal(other["mask"], request["mask"])
    ys, xs = np.nonzero(request["mask"])
    rows, cols = np.nonzero(request["conditions"]["region_mask"])
    margin = mix["mask_margin"]
    assert (ys.min(), xs.min()) == (max(rows.min() - margin, 0), max(cols.min() - margin, 0))
    assert np.array_equal(program_image(spec, request), program_image(spec, again))
