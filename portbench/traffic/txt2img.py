"""Closed-loop txt2img: one client, one request at a time, through
``cli.generate``. The mix names the frozen condition arrays and the request
names in them, taken in turn; each request has its own seed, drawn from the
run's seed and its index.

A driver is everything the harness does that depends on the kind of
request: ``load`` and ``make_request`` (the traffic), ``build`` (the
program's pipeline), ``run`` (one request through the program),
``reference`` (the same request through the plain reference), and the
pipeline's stage methods that the traced run puts in named ranges:
``STAGES``, and ``SAMPLER``, the method that returns the sampling loop."""

from __future__ import annotations

import os

import numpy as np

from portbench import program

STAGES = ("encode_prompt", "prepare_control_tokens", "prepare_latents", "decode")
SAMPLER = "_sampler"
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


def request_seed(seed: int, index: int) -> int:
    return int(np.random.SeedSequence([int(seed), index]).generate_state(1)[0] & 0x7FFFFFFF)


def conditions(data, name: str) -> dict:
    return {k: np.asarray(data[f"{name}.{k}"]) for k in
            ("canny_image", "position_mask", "region_mask", "glyph_canvas")}


def make_request(mix: dict, data, seed: int, index: int, steps: int = None) -> dict:
    """The index-th request of the mix: its prompt, text, conditions and seed."""
    name = mix["requests"][index % len(mix["requests"])]
    cond = conditions(data, name)
    height, width = cond["canny_image"].shape[:2]
    return {"kind": "txt2img", "name": name, "seed": request_seed(seed, index),
            "prompt": mix["prompt"], "text": str(data[f"{name}.text"]),
            "position": [int(v) for v in data[f"{name}.position"]],
            "height": int(height), "width": int(width),
            "steps": steps or mix["steps"],
            "controlnet_steps": min(mix["controlnet_steps"], steps or mix["steps"]),
            "guidance": float(mix["guidance"]), "conditions": cond}


def load(mix: dict, data_dir: str = DATA):
    return np.load(os.path.join(data_dir, mix["data"]))


def condition_view(request: dict):
    """The conditions as the pipelines read them: one text line."""
    import types

    c = request["conditions"]
    line = types.SimpleNamespace(canny_image=c["canny_image"], position_mask=c["position_mask"],
                                 region_mask=c["region_mask"])
    return types.SimpleNamespace(lines=[line], glyph_canvas=c["glyph_canvas"], num_lines=1)


def build(cfg: dict, weights, mix: dict, request: dict, device):
    """The port's txt2img pipeline over the weights, at the request's size."""
    return program.build(cfg, weights, program.pipeline_config(cfg, mix, request), device)


def run(pipe, request: dict, timings=None) -> np.ndarray:
    """One request through the CLI's request function: uint8 [1, H, W, 3]."""
    from reptext_tpu_torch import cli

    return cli.generate(program.cli_args(request), pipe, condition_view(request),
                        timings=timings)


def reference(weights, cfg: dict, request: dict, device) -> np.ndarray:
    """The request's image from the plain reference: uint8 [1, H, W, 3]."""
    from portbench.reference import pipeline

    return pipeline.generate(weights, cfg, request, device)
