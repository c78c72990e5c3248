"""Closed-loop text inpainting: one client, one request at a time, through
``cli.generate_inpaint`` on the port's ``FluxRepTextInpaintPipeline``.

Each request is a txt2img request of the mix (``txt2img.make_request``: its
text line's frozen conditions, prompt and seed) plus what an inpainting user
brings: a photo and a mask over the line, both drawn from the request's own
seed (a photo stand-in of smooth colour gradients and noise; the line's
region box grown by the mix's ``mask_margin``), the negative prompt and the
true-CFG scale. The inpainting ControlNet's weights are the benchmark's too:
drawn from the run's seed under their own component, for the program in
:func:`build` and again for the reference in :func:`reference`. What the
check compares of a request is :func:`answer`: the image, and the box the
user asked to edit enlarged to the image's size.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from portbench import program, weights as W
from portbench.counts import inpaint as inpaint_counts
from portbench.traffic import txt2img

STAGES = ("encode_prompt", "prepare_control_tokens", "prepare_inpaint_cond", "prepare_latents",
          "decode")
SAMPLER = "_inpaint_sampler"
COMPONENT = zlib.crc32(b"inpaint_controlnet")
load = txt2img.load
condition_view = txt2img.condition_view


def photo(seed: int, height: int, width: int) -> np.ndarray:
    """A photo stand-in from the seed: smooth colour gradients plus noise, uint8 [H, W, 3]."""
    r = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, height), np.linspace(0, 1, width), indexing="ij")
    base = np.stack([yy, xx, 0.5 * (yy + xx)], axis=-1) * r.uniform(80, 200, 3)
    return np.clip(base + r.normal(0, 12, (height, width, 3)) + 30, 0, 255).astype(np.uint8)


def box_mask(region_mask: np.ndarray, margin: int) -> np.ndarray:
    """uint8 [H, W]: 255 on the line's region box grown by ``margin`` pixels."""
    ys, xs = np.nonzero(np.asarray(region_mask) > 0)
    mask = np.zeros(region_mask.shape, np.uint8)
    mask[max(ys.min() - margin, 0):ys.max() + margin + 1,
         max(xs.min() - margin, 0):xs.max() + margin + 1] = 255
    return mask


def answer(images: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """What the check compares of a request: the uint8 images [N, H, W, 3],
    then the inpainted box of each (the mask's bounding box) enlarged to
    [H, W] by nearest sampling: [2N, H, W, 3]. Half of the values compared
    lie in the box the user asked to edit, where the RepText net draws the
    line; over the image alone the box is about 5 % of them, and a fault of
    that net would move the number by a few points."""
    ys, xs = np.nonzero(np.asarray(mask) > 0)
    h, w = images.shape[1:3]
    rows = ys.min() + np.arange(h) * (ys.max() + 1 - ys.min()) // h
    cols = xs.min() + np.arange(w) * (xs.max() + 1 - xs.min()) // w
    return np.concatenate([images, images[:, rows][:, :, cols]])


def make_request(mix: dict, data, seed: int, index: int, steps: int = None) -> dict:
    """The index-th request of the mix: a txt2img request with the photo,
    mask, negative prompt and true-CFG scale of an inpainting request, and
    the run's seed, from which both sides draw the inpainting net."""
    req = txt2img.make_request(mix, data, seed, index, steps)
    req.update(kind="inpaint", run_seed=int(seed),
               image=photo(req["seed"], req["height"], req["width"]),
               mask=box_mask(req["conditions"]["region_mask"], int(mix["mask_margin"])),
               negative_prompt=mix["negative_prompt"],
               true_guidance=float(mix["true_guidance"]),
               inpaint_scale=float(mix["inpaint_scale"]))
    return req


def inpaint_controlnet_config(cfg: dict):
    """The port's ControlNetConfig of the configuration's ``inpaint_controlnet`` group."""
    from reptext_tpu_torch.configs import ControlNetConfig

    return ControlNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in cfg["inpaint_controlnet"].items()})


def inpaint_weights(cfg: dict, seed: int, device):
    """The inpainting ControlNet's weights for ``seed``, drawn as every other
    component is (``weights.draw_all``), under its own name."""
    from reptext_tpu_torch.pipelines.txt2img import MODULES

    module = MODULES["inpaint_controlnet"](inpaint_controlnet_config(cfg), device="meta")
    return W.draw(W.spec_of(module.state_dict().items()), seed, COMPONENT, device,
                  program.DTYPES[cfg["dtype"]], cfg.get("scaled_init", {}).get("inpaint_controlnet"))


def build(cfg: dict, weights, mix: dict, request: dict, device):
    """The port's inpaint pipeline at the request's size: the txt2img
    pipeline over the weights, then ``from_pipeline`` (the CLI's route) with
    the inpainting net's weights drawn from the run's seed."""
    from reptext_tpu_torch.pipelines.inpaint import FluxRepTextInpaintPipeline

    base = program.build(cfg, weights, program.pipeline_config(cfg, mix, request), device)
    pipe = FluxRepTextInpaintPipeline.from_pipeline(
        base, inpaint_controlnet_config(cfg), inpaint_weights(cfg, request["run_seed"], device))
    pipe.inpaint_conditioning_scale = float(mix["inpaint_scale"])
    return sampler_route(pipe)


def sampler_route(pipe):
    """``pipe`` with a :data:`SAMPLER` method, which the traced run wraps in
    its ``sample`` range. A program whose pipeline runs the loop inside
    ``_sample_inpaint`` and has no such method gets one on this instance:
    ``_sample_inpaint`` then calls it and runs the loop it returns, the same
    loop on the same arguments."""
    if callable(getattr(type(pipe), SAMPLER, None)):
        return pipe
    loop = type(pipe)._sample_inpaint

    def sampler(schedule, cond_tokens, token_masks, inpaint_cond, ctx_cfg, pooled_cfg, gscale,
                tscale):
        return lambda latents: loop(pipe, latents, cond_tokens, token_masks, inpaint_cond,
                                    ctx_cfg, pooled_cfg, schedule, gscale, tscale)

    def sample_inpaint(latents, cond_tokens, token_masks, inpaint_cond, ctx_cfg, pooled_cfg,
                       schedule, gscale, tscale):
        return getattr(pipe, SAMPLER)(schedule, cond_tokens, token_masks, inpaint_cond, ctx_cfg,
                                      pooled_cfg, gscale, tscale)(latents)

    setattr(pipe, SAMPLER, sampler)
    pipe._sample_inpaint = sample_inpaint
    return pipe


def cli_args(request: dict):
    """The CLI's arguments of the request, as a user of ``--mode inpaint``
    passes them (the photo and mask go to ``generate_inpaint`` as arrays,
    as the CLI's ``main`` hands them over once it has read its files)."""
    from reptext_tpu_torch import cli

    argv = ["--mode", "inpaint", "--text", request["text"],
            "--position", *map(str, request["position"]), "--prompt", request["prompt"],
            "--negative-prompt", request["negative_prompt"], "--steps", str(request["steps"]),
            "--controlnet-step", str(request["controlnet_steps"]),
            "--guidance-scale", str(request["guidance"]),
            "--true-guidance-scale", str(request["true_guidance"]),
            "--seed", str(request["seed"]), "--random-weights"]
    return cli.build_parser().parse_args(argv)


def controlnet_inpaint_flop(pipe) -> float:
    """The inpainting ControlNet's model FLOPs in one step of the pipeline's
    requests, counted from the net the pipeline holds (``counts/inpaint.py``)
    at true CFG's two rows, the pipeline's image tokens and its text length."""
    cfg = pipe.pipe_cfg
    return inpaint_counts.controlnet_flop(
        dataclasses.asdict(pipe.inpaint_controlnet.config), 2,
        cfg.image_seq_len, cfg.max_sequence_length)


def run(pipe, request: dict, timings=None) -> np.ndarray:
    """One request through the CLI's inpaint request function: its
    :func:`answer`, uint8 [2, H, W, 3]. A traced request's ``timings`` also
    get ``controlnet_inpaint_flop``, which ``mfu.inpaint`` reads: the
    harness's record counts FLUX and the RepText net alone."""
    from reptext_tpu_torch import cli

    images = cli.generate_inpaint(cli_args(request), pipe, condition_view(request),
                                  request["image"], request["mask"], timings=timings)
    if timings is not None:
        timings["controlnet_inpaint_flop"] = controlnet_inpaint_flop(pipe)
    return answer(images, request["mask"])


def reference(weights, cfg: dict, request: dict, device) -> np.ndarray:
    """The request's :func:`answer` from the plain reference, the inpainting
    net's weights drawn again from the run's seed: uint8 [2, H, W, 3]."""
    from portbench.reference import inpaint

    both = dict(weights, inpaint_controlnet=inpaint_weights(cfg, request["run_seed"], device))
    return answer(inpaint.generate(both, cfg, request, device), request["mask"])
