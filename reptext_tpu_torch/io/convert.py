"""diffusers / transformers checkpoints -> Flax-named parameter trees, on torch tensors.

A copy of ``reptext_tpu/io/convert.py``'s loader and converters for the
components the port runs (FLUX transformer, RepText and inpaint ControlNets,
VAE, CLIP-L, T5-XXL), on CPU ``torch.Tensor``s where the JAX package has
numpy arrays, so that bf16 checkpoints stay bf16 in host memory. Each
converter returns the same tree as the JAX one, leaf for leaf:

- torch Linear (out, in) -> Dense ``kernel`` (in, out);
- torch Conv2d (out, in, kh, kw) -> Conv ``kernel`` (kh, kw, in, out);
- the RoPE deinterleave permutation folded into the q/k projections and
  their RMS norms (:func:`_lin_rope`);
- the FLUX double and single blocks stacked on a leading layer axis.

Transposes are views, not copies: ``io/from_jax.py::flatten_jax_params``
transposes them back, so carrying a converted tree into the modules or into
the port's checkpoint format copies only what the permutation and the stacks
make. The IP-Adapter's converters (:func:`convert_clip_vision`,
:func:`convert_ip_adapter`, :func:`merge_ip_adapter_into_flux`) are here too.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import torch

from reptext_tpu_torch.configs import CLIPConfig, ControlNetConfig, FluxConfig, T5Config, VAEConfig
from reptext_tpu_torch.io.safetensors import load_file
from reptext_tpu_torch.ops.rope import deinterleave_perm

State = Dict[str, torch.Tensor]


def load_safetensors_state(path: str, dtype: Optional[torch.dtype] = torch.float32) -> State:
    """Load one .safetensors file or every shard in a directory.

    ``dtype=None`` keeps each tensor's stored dtype (published FLUX
    checkpoints are bf16); a dtype casts the floating tensors to it.
    """
    if os.path.isdir(path):
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.endswith(".safetensors"))
    else:
        files = [path]
    state: State = {}
    for f in files:
        state.update(load_file(f, dtype=dtype))
    return state


def _lin(state, name):
    """torch Linear -> {'kernel', 'bias'?}."""
    out = {"kernel": state[f"{name}.weight"].t()}
    if f"{name}.bias" in state:
        out["bias"] = state[f"{name}.bias"]
    return out


def _conv(state, name):
    out = {"kernel": state[f"{name}.weight"].permute(2, 3, 1, 0)}
    if f"{name}.bias" in state:
        out["bias"] = state[f"{name}.bias"]
    return out


def _norm_affine(state, name):
    return {"scale": state[f"{name}.weight"], "bias": state[f"{name}.bias"]}


def _rms(state, name):
    return {"weight": state[f"{name}.weight"]}


def _lin_rope(state, name, head_dim: int):
    """torch q/k Linear with the RoPE deinterleave permutation folded in.

    Attention logits are invariant under a fixed permutation applied to both
    q and k head channels, so converting checkpoints to the framework's
    half-split RoPE layout (ops/rope.py) is pure weight surgery: permute the
    projection's output channels per head (and its bias).
    """
    perm = deinterleave_perm(head_dim)
    w = state[f"{name}.weight"]          # [out, in] torch layout
    out_dim = w.shape[0]
    wp = w.reshape(out_dim // head_dim, head_dim, -1)[:, perm, :].reshape(out_dim, -1)
    out = {"kernel": wp.t()}
    if f"{name}.bias" in state:
        b = state[f"{name}.bias"]
        out["bias"] = b.reshape(-1, head_dim)[:, perm].reshape(-1)
    return out


def _rms_rope(state, name, head_dim: int):
    """Per-head q/k RMSNorm scale, permuted to half-split channel order."""
    return {"weight": state[f"{name}.weight"][deinterleave_perm(head_dim)]}


def _stack(trees: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack a list of identical pytrees along a new leading axis."""
    out: Dict[str, Any] = {}
    for key in trees[0]:
        vals = [t[key] for t in trees]
        if isinstance(vals[0], dict):
            out[key] = _stack(vals)
        else:
            out[key] = torch.stack(vals, dim=0)
    return out


# ---------------------------------------------------------------- FLUX MMDiT


def _double_block(state, prefix: str, head_dim: int = 128) -> Dict[str, Any]:
    a = f"{prefix}.attn"
    return {
        "norm1": {"linear": _lin(state, f"{prefix}.norm1.linear")},
        "norm1_context": {"linear": _lin(state, f"{prefix}.norm1_context.linear")},
        "to_q": _lin_rope(state, f"{a}.to_q", head_dim),
        "to_k": _lin_rope(state, f"{a}.to_k", head_dim),
        "to_v": _lin(state, f"{a}.to_v"),
        "add_q_proj": _lin_rope(state, f"{a}.add_q_proj", head_dim),
        "add_k_proj": _lin_rope(state, f"{a}.add_k_proj", head_dim),
        "add_v_proj": _lin(state, f"{a}.add_v_proj"),
        "norm_q": _rms_rope(state, f"{a}.norm_q", head_dim),
        "norm_k": _rms_rope(state, f"{a}.norm_k", head_dim),
        "norm_added_q": _rms_rope(state, f"{a}.norm_added_q", head_dim),
        "norm_added_k": _rms_rope(state, f"{a}.norm_added_k", head_dim),
        "to_out": _lin(state, f"{a}.to_out.0"),
        "to_add_out": _lin(state, f"{a}.to_add_out"),
        "ff": {
            "in_proj": _lin(state, f"{prefix}.ff.net.0.proj"),
            "out_proj": _lin(state, f"{prefix}.ff.net.2"),
        },
        "ff_context": {
            "in_proj": _lin(state, f"{prefix}.ff_context.net.0.proj"),
            "out_proj": _lin(state, f"{prefix}.ff_context.net.2"),
        },
    }


def _single_block(state, prefix: str, head_dim: int = 128) -> Dict[str, Any]:
    a = f"{prefix}.attn"
    return {
        "norm": {"linear": _lin(state, f"{prefix}.norm.linear")},
        "proj_mlp": _lin(state, f"{prefix}.proj_mlp"),
        "proj_out": _lin(state, f"{prefix}.proj_out"),
        "to_q": _lin_rope(state, f"{a}.to_q", head_dim),
        "to_k": _lin_rope(state, f"{a}.to_k", head_dim),
        "to_v": _lin(state, f"{a}.to_v"),
        "norm_q": _rms_rope(state, f"{a}.norm_q", head_dim),
        "norm_k": _rms_rope(state, f"{a}.norm_k", head_dim),
    }


def _time_text_embed(state, guidance_embeds: bool) -> Dict[str, Any]:
    p = "time_text_embed"
    out = {
        "timestep_embedder": {
            "linear_1": _lin(state, f"{p}.timestep_embedder.linear_1"),
            "linear_2": _lin(state, f"{p}.timestep_embedder.linear_2"),
        },
        "text_embedder": {
            "linear_1": _lin(state, f"{p}.text_embedder.linear_1"),
            "linear_2": _lin(state, f"{p}.text_embedder.linear_2"),
        },
    }
    if guidance_embeds:
        out["guidance_embedder"] = {
            "linear_1": _lin(state, f"{p}.guidance_embedder.linear_1"),
            "linear_2": _lin(state, f"{p}.guidance_embedder.linear_2"),
        }
    return out


def convert_flux_transformer(state: State, cfg: FluxConfig) -> Dict:
    doubles = _stack(
        [_double_block(state, f"transformer_blocks.{i}", cfg.attention_head_dim)
         for i in range(cfg.num_layers)]
    )
    singles = _stack(
        [_single_block(state, f"single_transformer_blocks.{i}", cfg.attention_head_dim)
         for i in range(cfg.num_single_layers)]
    )
    params = {
        "x_embedder": _lin(state, "x_embedder"),
        "context_embedder": _lin(state, "context_embedder"),
        "time_text_embed": _time_text_embed(state, cfg.guidance_embeds),
        "double_blocks": {"block": doubles},
        "single_blocks": {"block": singles},
        "norm_out": {"linear": _lin(state, "norm_out.linear")},
        "proj_out": _lin(state, "proj_out"),
    }
    return {"params": params}


def convert_controlnet(state: State, cfg: ControlNetConfig) -> Dict:
    doubles = [
        {"block": _double_block(state, f"transformer_blocks.{i}", cfg.attention_head_dim),
         "proj": _lin(state, f"controlnet_blocks.{i}")}
        for i in range(cfg.num_layers)
    ]
    singles = [
        {"block": _single_block(state, f"single_transformer_blocks.{i}", cfg.attention_head_dim),
         "proj": _lin(state, f"controlnet_single_blocks.{i}")}
        for i in range(cfg.num_single_layers)
    ]
    params = {
        "x_embedder": _lin(state, "x_embedder"),
        "controlnet_x_embedder": _lin(state, "controlnet_x_embedder"),
        "context_embedder": _lin(state, "context_embedder"),
        "time_text_embed": _time_text_embed(state, cfg.guidance_embeds),
        "double_blocks": _stack(doubles),
        "single_blocks": _stack(singles),
    }
    if cfg.union:
        params["controlnet_mode_embedder"] = {
            "embedding": state["controlnet_mode_embedder.weight"]
        }
    return {"params": params}


# --------------------------------------------------------------------- VAE


def _resnet(state, prefix: str, has_shortcut: bool) -> Dict[str, Any]:
    out = {
        "norm1": {"norm": _norm_affine(state, f"{prefix}.norm1")},
        "conv1": _conv(state, f"{prefix}.conv1"),
        "norm2": {"norm": _norm_affine(state, f"{prefix}.norm2")},
        "conv2": _conv(state, f"{prefix}.conv2"),
    }
    if has_shortcut:
        out["conv_shortcut"] = _conv(state, f"{prefix}.conv_shortcut")
    return out


def _vae_attn(state, prefix: str) -> Dict[str, Any]:
    return {
        "group_norm": {"norm": _norm_affine(state, f"{prefix}.group_norm")},
        "to_q": _lin(state, f"{prefix}.to_q"),
        "to_k": _lin(state, f"{prefix}.to_k"),
        "to_v": _lin(state, f"{prefix}.to_v"),
        "to_out": _lin(state, f"{prefix}.to_out.0"),
    }


def convert_vae(state: State, cfg: VAEConfig) -> Dict:
    ch = cfg.block_out_channels
    enc: Dict[str, Any] = {"conv_in": _conv(state, "encoder.conv_in")}
    for i in range(len(ch)):
        for j in range(cfg.layers_per_block):
            pfx = f"encoder.down_blocks.{i}.resnets.{j}"
            enc[f"down_{i}_block_{j}"] = _resnet(state, pfx, f"{pfx}.conv_shortcut.weight" in state)
        if i < len(ch) - 1:
            enc[f"down_{i}_downsample"] = _conv(
                state, f"encoder.down_blocks.{i}.downsamplers.0.conv"
            )
    enc["mid_block_1"] = _resnet(state, "encoder.mid_block.resnets.0", False)
    enc["mid_attn"] = _vae_attn(state, "encoder.mid_block.attentions.0")
    enc["mid_block_2"] = _resnet(state, "encoder.mid_block.resnets.1", False)
    enc["norm_out"] = {"norm": _norm_affine(state, "encoder.conv_norm_out")}
    enc["conv_out"] = _conv(state, "encoder.conv_out")

    dec: Dict[str, Any] = {"conv_in": _conv(state, "decoder.conv_in")}
    dec["mid_block_1"] = _resnet(state, "decoder.mid_block.resnets.0", False)
    dec["mid_attn"] = _vae_attn(state, "decoder.mid_block.attentions.0")
    dec["mid_block_2"] = _resnet(state, "decoder.mid_block.resnets.1", False)
    for i in range(len(ch)):
        for j in range(cfg.layers_per_block + 1):
            pfx = f"decoder.up_blocks.{i}.resnets.{j}"
            dec[f"up_{i}_block_{j}"] = _resnet(state, pfx, f"{pfx}.conv_shortcut.weight" in state)
        if i < len(ch) - 1:
            dec[f"up_{i}_upsample"] = _conv(state, f"decoder.up_blocks.{i}.upsamplers.0.conv")
    dec["norm_out"] = {"norm": _norm_affine(state, "decoder.conv_norm_out")}
    dec["conv_out"] = _conv(state, "decoder.conv_out")

    return {"params": {"encoder": enc, "decoder": dec}}


# ------------------------------------------------------------------- CLIP/T5


def convert_clip(state: State, cfg: CLIPConfig) -> Dict:
    tm = "text_model"
    params: Dict[str, Any] = {
        "token_embedding": {"embedding": state[f"{tm}.embeddings.token_embedding.weight"]},
        "position_embedding": {
            "embedding": state[f"{tm}.embeddings.position_embedding.weight"]
        },
        "final_layer_norm": _norm_affine(state, f"{tm}.final_layer_norm"),
    }
    for i in range(cfg.num_layers):
        p = f"{tm}.encoder.layers.{i}"
        params[f"layer_{i}"] = {
            "layer_norm1": _norm_affine(state, f"{p}.layer_norm1"),
            "layer_norm2": _norm_affine(state, f"{p}.layer_norm2"),
            "q_proj": _lin(state, f"{p}.self_attn.q_proj"),
            "k_proj": _lin(state, f"{p}.self_attn.k_proj"),
            "v_proj": _lin(state, f"{p}.self_attn.v_proj"),
            "out_proj": _lin(state, f"{p}.self_attn.out_proj"),
            "fc1": _lin(state, f"{p}.mlp.fc1"),
            "fc2": _lin(state, f"{p}.mlp.fc2"),
        }
    return {"params": params}


def convert_clip_vision(state: State, cfg) -> Dict:
    """transformers ``CLIPVisionModelWithProjection`` -> the
    ``nn/clip_vision.py`` tree (the IP-Adapter's image encoder)."""
    vm = "vision_model"
    params: Dict[str, Any] = {
        "class_embedding": state[f"{vm}.embeddings.class_embedding"],
        "patch_embedding": {
            "kernel": state[f"{vm}.embeddings.patch_embedding.weight"].permute(2, 3, 1, 0)},
        "position_embedding": {
            "embedding": state[f"{vm}.embeddings.position_embedding.weight"]},
        # transformers keeps this historical typo in the checkpoint key
        "pre_layrnorm": _norm_affine(state, f"{vm}.pre_layrnorm"),
        "post_layernorm": _norm_affine(state, f"{vm}.post_layernorm"),
        "visual_projection": {"kernel": state["visual_projection.weight"].t()},
    }
    for i in range(cfg.num_layers):
        p = f"{vm}.encoder.layers.{i}"
        params[f"layer_{i}"] = {
            "layer_norm1": _norm_affine(state, f"{p}.layer_norm1"),
            "layer_norm2": _norm_affine(state, f"{p}.layer_norm2"),
            "q_proj": _lin(state, f"{p}.self_attn.q_proj"),
            "k_proj": _lin(state, f"{p}.self_attn.k_proj"),
            "v_proj": _lin(state, f"{p}.self_attn.v_proj"),
            "out_proj": _lin(state, f"{p}.self_attn.out_proj"),
            "fc1": _lin(state, f"{p}.mlp.fc1"),
            "fc2": _lin(state, f"{p}.mlp.fc2"),
        }
    return {"params": params}


def convert_ip_adapter(state: State, num_layers: int, head_dim: int = 128) -> Dict[str, Any]:
    """diffusers FLUX IP-Adapter state dict (``image_proj.proj``,
    ``image_proj.norm``, ``ip_adapter.{i}.to_k_ip``/``to_v_ip``) ->
    ``{"proj": <ImageProjection tree>, "blocks": {"to_k_ip", "to_v_ip"}}``,
    the block leaves stacked [num_layers, ...]. ``to_k_ip`` takes the RoPE
    half-split permutation of the base q/k projections (:func:`_lin_rope`):
    the ip attention reuses the image queries, whose head channels carry it;
    ``to_v_ip`` does not."""
    proj = {"params": {"proj": _lin(state, "image_proj.proj"),
                       "norm": _norm_affine(state, "image_proj.norm")}}
    blocks = _stack([{"to_k_ip": _lin_rope(state, f"ip_adapter.{i}.to_k_ip", head_dim),
                      "to_v_ip": _lin(state, f"ip_adapter.{i}.to_v_ip")}
                     for i in range(num_layers)])
    return {"proj": proj, "blocks": blocks}


def merge_ip_adapter_into_flux(flux_variables: Dict, ip_blocks: Dict) -> Dict:
    """The stacked ``to_k_ip``/``to_v_ip`` inserted into a converted FLUX
    tree (diffusers stores them in the transformer after
    ``load_ip_adapter``); only the dicts along the path are copied. The
    result loads into a ``FluxTransformer2D`` after ``add_ip_adapter``."""
    out = dict(flux_variables)
    out["params"] = dict(out["params"])
    out["params"]["double_blocks"] = dict(out["params"]["double_blocks"])
    block = dict(out["params"]["double_blocks"]["block"])
    block["to_k_ip"] = ip_blocks["to_k_ip"]
    block["to_v_ip"] = ip_blocks["to_v_ip"]
    out["params"]["double_blocks"]["block"] = block
    return out


def convert_t5(state: State, cfg: T5Config) -> Dict:
    params: Dict[str, Any] = {
        "shared": {"embedding": state["shared.weight"]},
        "relative_attention_bias": {
            "embedding": state[
                "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"
            ]
        },
        "final_layer_norm": {"weight": state["encoder.final_layer_norm.weight"]},
    }
    for i in range(cfg.num_layers):
        p = f"encoder.block.{i}"
        params[f"layer_{i}"] = {
            "attn_layer_norm": {"weight": state[f"{p}.layer.0.layer_norm.weight"]},
            "q": _lin(state, f"{p}.layer.0.SelfAttention.q"),
            "k": _lin(state, f"{p}.layer.0.SelfAttention.k"),
            "v": _lin(state, f"{p}.layer.0.SelfAttention.v"),
            "o": _lin(state, f"{p}.layer.0.SelfAttention.o"),
            "ff_layer_norm": {"weight": state[f"{p}.layer.1.layer_norm.weight"]},
            "wi_0": _lin(state, f"{p}.layer.1.DenseReluDense.wi_0"),
            "wi_1": _lin(state, f"{p}.layer.1.DenseReluDense.wi_1"),
            "wo": _lin(state, f"{p}.layer.1.DenseReluDense.wo"),
        }
    return {"params": params}
