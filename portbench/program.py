"""The system under test, reached from outside: the port's modules, its
pipelines and its CLI's request functions.

Everything of ``reptext_tpu_torch`` that the benchmark touches goes through
this module and the traffic drivers: the parameter names and shapes of its
modules built on the meta device, ``FluxRepTextPipeline.create(params=...)``
with the benchmark's weights, ``cli.generate`` for the requests, and the
attention entries' launch counters.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench import weights as W

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_configs(cfg: dict):
    """The port's config dataclasses of a configuration file's groups."""
    from reptext_tpu_torch.configs import (
        CLIPConfig, ControlNetConfig, FluxConfig, T5Config, VAEConfig,
    )

    def make(cls, group):
        kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg[group].items()}
        return cls(**kw)

    return {"flux": make(FluxConfig, "flux"), "controlnet": make(ControlNetConfig, "controlnet"),
            "vae": make(VAEConfig, "vae"), "clip": make(CLIPConfig, "clip"),
            "t5": make(T5Config, "t5")}


def specs(cfg: dict) -> Dict[str, W.Spec]:
    """(name, shape) of every parameter of every component, read from the
    port's modules built on the meta device."""
    from reptext_tpu_torch.pipelines.txt2img import MODULES

    return {name: W.spec_of(MODULES[name](c, device="meta").state_dict().items())
            for name, c in port_configs(cfg).items()}


def draw_weights(cfg: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    return W.draw_all(specs(cfg), seed, device, DTYPES[cfg["dtype"]], cfg.get("scaled_init", {}))


def pipeline_config(cfg: dict, mix: dict, request: dict):
    """The port's PipelineConfig of a request of the mix."""
    from reptext_tpu_torch.configs import PipelineConfig

    p = cfg["pipeline"]
    return PipelineConfig(
        height=request["height"], width=request["width"], num_inference_steps=mix["steps"],
        guidance_scale=mix["guidance"],
        controlnet_conditioning_scale=p["controlnet_conditioning_scale"],
        controlnet_conditioning_step=mix["controlnet_steps"],
        max_sequence_length=p["max_sequence_length"], glyph_latent_init=p["glyph_latent_init"],
        glyph_latent_scale=p["glyph_latent_scale"], base_image_seq_len=p["base_image_seq_len"],
        max_image_seq_len=p["max_image_seq_len"], base_shift=p["base_shift"],
        max_shift=p["max_shift"])


def build(cfg: dict, params: Dict[str, Dict[str, torch.Tensor]], pipe_cfg, device):
    """The port's txt2img pipeline over the benchmark's weights."""
    from reptext_tpu_torch.ops.attention import set_default_backend
    from reptext_tpu_torch.pipelines.txt2img import FluxRepTextPipeline

    set_default_backend("auto")
    c = port_configs(cfg)
    return FluxRepTextPipeline.create(c["flux"], c["controlnet"], c["vae"], pipe_cfg,
                                      params=params, clip_cfg=c["clip"], t5_cfg=c["t5"],
                                      device=device, dtype=DTYPES[cfg["dtype"]])


def attention_entries():
    """The attention kernel entries that count their launches: {K1, K2, K3: entry}."""
    from reptext_tpu_torch.ops import flash_attention as fa

    return {"K1": fa.flash_attention_rope, "K2": fa.flash_attention,
            "K3": fa.flash_attention_streaming}


def launches() -> Dict[str, int]:
    return {k: int(e.launches) for k, e in attention_entries().items()}


def cli_args(request: dict):
    """The CLI's arguments of a request, as a user of the CLI passes them."""
    from reptext_tpu_torch import cli

    argv = ["--text", request["text"], "--position", *map(str, request["position"]),
            "--prompt", request["prompt"], "--steps", str(request["steps"]),
            "--controlnet-step", str(request["controlnet_steps"]),
            "--guidance-scale", str(request["guidance"]), "--seed", str(request["seed"]),
            "--random-weights"]
    return cli.build_parser().parse_args(argv)


def free() -> None:
    """Collect what the caller let go of and return the card's cached blocks."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
