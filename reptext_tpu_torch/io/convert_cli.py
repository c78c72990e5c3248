"""One-command checkpoint conversion: HF snapshots -> the port's --checkpoint-dir.

A copy of ``reptext_tpu/io/convert_cli.py`` for the port. It reads the
published safetensors checkpoints with the port's own reader and writes, per
component, one ``<component>.safetensors`` holding the module's ``state_dict``
in torch layout (``io/checkpoint.py`` describes the directory):

    python -m reptext_tpu_torch.io.convert_cli \\
        --pipeline-dir   ~/ckpts/FLUX.1-dev \\
        --controlnet-dir ~/ckpts/RepText \\
        --inpaint-controlnet-dir ~/ckpts/FLUX.1-dev-Controlnet-Inpainting-Beta \\
        --out ~/ckpts/converted-torch

    python -m reptext_tpu_torch.cli --checkpoint-dir ~/ckpts/converted-torch ...

``--pipeline-dir`` is an HF snapshot of the base pipeline (``transformer/
vae/ text_encoder/ text_encoder_2/`` with config.json and safetensors shards,
plus ``tokenizer/`` and ``tokenizer_2/``, whose files are copied for the
vendored tokenizers); ControlNets are standalone snapshots. Each component's
geometry comes from its ``config.json`` and is recorded in ``configs.json``
in the JAX converter's format. Components are converted one at a time, so
host memory holds one component's state and its stacked blocks at a time
(a full bf16 FLUX.1-dev is ~24 GB). The JAX converter's single-file FLUX,
LoRA baking, IP-Adapter and fp8 options are not ported yet and are refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
from typing import Any, Dict

import torch

from reptext_tpu_torch.configs import CLIPConfig, ControlNetConfig, FluxConfig, T5Config, VAEConfig


def _read_config(component_dir: str) -> Dict[str, Any]:
    path = os.path.join(component_dir, "config.json")
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _replace_known(cfg, hf: Dict[str, Any], mapping: Dict[str, str]):
    """dataclasses.replace(cfg) with every mapped key present in hf."""
    kw = {}
    for ours, theirs in mapping.items():
        if theirs in hf and hf[theirs] is not None:
            v = hf[theirs]
            kw[ours] = tuple(v) if isinstance(v, list) else v
    return dataclasses.replace(cfg, **kw)


_FLUX_MAP = {
    "in_channels": "in_channels",
    "num_layers": "num_layers",
    "num_single_layers": "num_single_layers",
    "attention_head_dim": "attention_head_dim",
    "num_attention_heads": "num_attention_heads",
    "joint_attention_dim": "joint_attention_dim",
    "pooled_projection_dim": "pooled_projection_dim",
    "guidance_embeds": "guidance_embeds",
    "axes_dims_rope": "axes_dims_rope",
}


def flux_config_from_hf(hf: Dict[str, Any]) -> FluxConfig:
    return _replace_known(FluxConfig(), hf, _FLUX_MAP)


def controlnet_config_from_hf(hf: Dict[str, Any]) -> ControlNetConfig:
    cfg = _replace_known(ControlNetConfig(), hf, HF_KEYS[ControlNetConfig])
    # num_mode=None means non-union; only replace when the checkpoint has it
    if hf.get("num_mode") is not None:
        cfg = dataclasses.replace(cfg, num_mode=int(hf["num_mode"]))
    return cfg


_VAE_MAP = {
    "in_channels": "in_channels",
    "out_channels": "out_channels",
    "latent_channels": "latent_channels",
    "block_out_channels": "block_out_channels",
    "layers_per_block": "layers_per_block",
    "norm_num_groups": "norm_num_groups",
    "scaling_factor": "scaling_factor",
    "shift_factor": "shift_factor",
}
_CLIP_MAP = {
    "vocab_size": "vocab_size",
    "hidden_size": "hidden_size",
    "intermediate_size": "intermediate_size",
    "num_layers": "num_hidden_layers",
    "num_heads": "num_attention_heads",
    "max_position_embeddings": "max_position_embeddings",
    "eos_token_id": "eos_token_id",
}
_T5_MAP = {
    "vocab_size": "vocab_size",
    "d_model": "d_model",
    "d_kv": "d_kv",
    "d_ff": "d_ff",
    "num_layers": "num_layers",
    "num_heads": "num_heads",
    "relative_attention_num_buckets": "relative_attention_num_buckets",
    "relative_attention_max_distance": "relative_attention_max_distance",
}
# {our config class: {our field: the HF config.json key}}
HF_KEYS = {FluxConfig: _FLUX_MAP,
           ControlNetConfig: dict(_FLUX_MAP, extra_condition_channels="extra_condition_channels"),
           VAEConfig: _VAE_MAP, CLIPConfig: _CLIP_MAP, T5Config: _T5_MAP}


def vae_config_from_hf(hf: Dict[str, Any]) -> VAEConfig:
    return _replace_known(VAEConfig(), hf, _VAE_MAP)


def clip_config_from_hf(hf: Dict[str, Any]) -> CLIPConfig:
    return _replace_known(CLIPConfig(), hf, _CLIP_MAP)


def t5_config_from_hf(hf: Dict[str, Any]) -> T5Config:
    return _replace_known(T5Config(), hf, _T5_MAP)


def _copy_tokenizers(pipeline_dir: str, out: str) -> list:
    """Copy tokenizer assets the vendored tokenizers read (cli.py::_tokenize)."""
    copied = []
    clip_src = os.path.join(pipeline_dir, "tokenizer")
    if os.path.isdir(clip_src):
        dst = os.path.join(out, "tokenizer")
        os.makedirs(dst, exist_ok=True)
        for fname in ("vocab.json", "merges.txt", "special_tokens_map.json"):
            p = os.path.join(clip_src, fname)
            if os.path.isfile(p):
                shutil.copy2(p, os.path.join(dst, fname))
                copied.append(f"tokenizer/{fname}")
    spm_src = os.path.join(pipeline_dir, "tokenizer_2", "spiece.model")
    if os.path.isfile(spm_src):
        dst = os.path.join(out, "tokenizer_2")
        os.makedirs(dst, exist_ok=True)
        shutil.copy2(spm_src, os.path.join(dst, "spiece.model"))
        copied.append("tokenizer_2/spiece.model")
    return copied


def module_state(name: str, tree, cfg, dtype=None) -> Dict[str, torch.Tensor]:
    """A converted Flax-named tree -> the ``state_dict`` of the component's
    module (torch layout, views where no copy is needed), floating tensors
    cast to ``dtype`` when given; checked name for name and shape for shape
    against the module built on the meta device."""
    from reptext_tpu_torch.io.from_jax import flatten_jax_params
    from reptext_tpu_torch.pipelines.txt2img import MODULES

    flat = flatten_jax_params(tree)
    expect = {k: tuple(p.shape) for k, p in MODULES[name](cfg, device="meta").named_parameters()}
    got = {k: tuple(v.shape) for k, v in flat.items()}
    if got != expect:
        missing, unused = sorted(set(expect) - set(got)), sorted(set(got) - set(expect))
        bad = sorted(k for k in set(got) & set(expect) if got[k] != expect[k])
        raise ValueError(f"[{name}] converted tree does not match the module: missing "
                         f"{missing[:8]}, unused {unused[:8]}, shape mismatches {bad[:8]}")
    if dtype is not None:
        flat = {k: v.to(dtype) if v.is_floating_point() else v for k, v in flat.items()}
    return flat


_STORAGE_DTYPES = {"keep": None, "bf16": torch.bfloat16, "fp32": torch.float32}
_UNPORTED = (("flux_single_file", "--flux-single-file"), ("lora", "--lora"),
             ("lora_scale", "--lora-scale"), ("ip_adapter", "--ip-adapter"),
             ("image_encoder_dir", "--image-encoder-dir"))


def main(argv=None) -> int:
    from reptext_tpu_torch.io import convert as C
    from reptext_tpu_torch.io.checkpoint import _LAYOUT_FILE, LAYOUT_VERSION, component_path
    from reptext_tpu_torch.io.safetensors import save_file

    parser = argparse.ArgumentParser(
        description="Convert HF safetensors checkpoints to a reptext_tpu_torch "
                    "--checkpoint-dir (one safetensors file per module)")
    parser.add_argument("--pipeline-dir", default=None,
                        help="HF FLUX.1 pipeline snapshot (transformer/ vae/ "
                             "text_encoder/ text_encoder_2/ tokenizer*/)")
    parser.add_argument("--controlnet-dir", default=None,
                        help="RepText ControlNet snapshot (config.json + safetensors)")
    parser.add_argument("--inpaint-controlnet-dir", default=None,
                        help="inpainting ControlNet snapshot (alimama beta)")
    parser.add_argument("--flux-dir", default=None,
                        help="override: transformer snapshot dir (else <pipeline-dir>/transformer)")
    parser.add_argument("--vae-dir", default=None)
    parser.add_argument("--clip-dir", default=None)
    parser.add_argument("--t5-dir", default=None)
    parser.add_argument("--dtype", choices=["keep", "bf16", "fp32", "fp8"], default="keep",
                        help="storage dtype: keep = as stored in the checkpoint (FLUX publishes "
                             "bf16), bf16/fp32 = force-cast (fp8: not ported yet)")
    parser.add_argument("--out", required=True,
                        help="output directory (becomes --checkpoint-dir)")
    for dest, flag in _UNPORTED:
        parser.add_argument(flag, dest=dest, action="append", default=None,
                            help="not ported yet")
    args = parser.parse_args(argv)
    for dest, flag in _UNPORTED:
        if getattr(args, dest):
            parser.error(f"{flag} is not ported yet")
    if args.dtype == "fp8":
        parser.error("--dtype fp8 is not ported yet")

    def comp_dir(override, sub):
        if override:
            return override
        if args.pipeline_dir:
            d = os.path.join(args.pipeline_dir, sub)
            return d if os.path.isdir(d) else None
        return None

    plan = []  # (component_name, source_dir, config_fn, convert_fn)
    for name, override, sub, cfg_fn, conv_fn in (
            ("flux", args.flux_dir, "transformer", flux_config_from_hf,
             C.convert_flux_transformer),
            ("vae", args.vae_dir, "vae", vae_config_from_hf, C.convert_vae),
            ("clip", args.clip_dir, "text_encoder", clip_config_from_hf, C.convert_clip),
            ("t5", args.t5_dir, "text_encoder_2", t5_config_from_hf, C.convert_t5)):
        src = comp_dir(override, sub)
        if src:
            plan.append((name, src, cfg_fn, conv_fn))
    if args.controlnet_dir:
        plan.append(("controlnet", args.controlnet_dir, controlnet_config_from_hf,
                     C.convert_controlnet))
    if args.inpaint_controlnet_dir:
        plan.append(("inpaint_controlnet", args.inpaint_controlnet_dir,
                     controlnet_config_from_hf, C.convert_controlnet))
    if not plan:
        parser.error("nothing to convert: pass --pipeline-dir and/or "
                      "--controlnet-dir / component overrides")

    dtype = _STORAGE_DTYPES[args.dtype]
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)
    configs_meta: Dict[str, Any] = {}
    # one component at a time: a full bf16 FLUX.1-dev state is ~24 GB host
    # RAM; converting sequentially keeps peak memory at one component.
    for name, src, cfg_fn, conv_fn in plan:
        hf_cfg = _read_config(src)
        cfg = cfg_fn(hf_cfg)
        if not hf_cfg:
            print(f"[{name}] no config.json in {src}; using library defaults", file=sys.stderr)
        state = C.load_safetensors_state(src, dtype=None)
        n_params = sum(v.numel() for v in state.values())
        flat = module_state(name, conv_fn(state, cfg), cfg, dtype)
        save_file(flat, component_path(out, name),
                  metadata={"format": "pt", "component": name,
                            "layout_version": str(LAYOUT_VERSION)})
        del state, flat
        configs_meta[name] = dataclasses.asdict(cfg)
        print(f"[{name}] {n_params / 1e9:.3f}B params <- {src}")

    copied = _copy_tokenizers(args.pipeline_dir, out) if args.pipeline_dir else []
    for c in copied:
        print(f"[tokenizer] {c}")
    with open(os.path.join(out, _LAYOUT_FILE), "w") as f:
        f.write(f"{LAYOUT_VERSION}\n")
    # record the checkpoint-derived geometry so loaders can rebuild the
    # exact model configs without re-reading the HF snapshots
    with open(os.path.join(out, "configs.json"), "w") as f:
        json.dump(configs_meta, f, indent=1, sort_keys=True)
    print(f"wrote {out} (param layout v{LAYOUT_VERSION}, dtype={args.dtype})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
