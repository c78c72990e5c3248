"""BFL single-file FLUX checkpoints (diffusers' ``FromSingleFileMixin``), on torch tensors.

Counterpart of ``reptext_tpu/io/single_file.py``: a pure key remap from the
Black Forest Labs layout (``flux1-dev.safetensors``, optionally wrapped as
ComfyUI and DDP dumps wrap it) to diffusers naming, after which the port's
FLUX converter (``io/convert.py``) applies. The layout facts it encodes:
fused ``qkv`` rows [q; k; v] and single-block ``linear1`` rows [q; k; v;
mlp]; ``time_in``/``vector_in``/``guidance_in`` MLP embedders; the per-head
norms at ``*.norm.{query,key}_norm.scale``; the final AdaLN's [shift; scale]
halves swapped into diffusers' [scale; shift]. Tensors keep their dtype
(bf16 stays bf16); the splits are copied contiguous.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from reptext_tpu_torch.configs import FluxConfig
from reptext_tpu_torch.io.convert import convert_flux_transformer, load_safetensors_state

State = Dict[str, torch.Tensor]

_WRAPPER_PREFIXES = ("model.diffusion_model.", "module.")


def strip_wrapper_prefixes(state: State) -> State:
    """Remove ComfyUI/DDP-style key wrappers, keeping unwrapped keys as-is."""
    for prefix in _WRAPPER_PREFIXES:
        if any(k.startswith(prefix) for k in state):
            state = {(k[len(prefix):] if k.startswith(prefix) else k): v
                     for k, v in state.items()}
    return state


def is_bfl_flux(state: State) -> bool:
    """True when the state dict uses BFL original naming."""
    return "double_blocks.0.img_attn.qkv.weight" in state


def _swap_scale_shift(w: torch.Tensor) -> torch.Tensor:
    shift, scale = torch.chunk(w, 2, dim=0)
    return torch.cat([scale, shift], dim=0)


def _count(state: State, prefix: str) -> int:
    return 1 + max((int(k.split(".")[1]) for k in state if k.startswith(prefix)), default=-1)


def bfl_flux_to_diffusers(state: State) -> State:
    """Remap a BFL-layout FLUX transformer state dict to diffusers naming
    (torch ``[out, in]`` layout kept); :func:`convert_flux_transformer` does
    the rest."""
    out: State = {}

    def put(dst: str, src: str) -> None:
        out[f"{dst}.weight"] = state[f"{src}.weight"]
        if f"{src}.bias" in state:
            out[f"{dst}.bias"] = state[f"{src}.bias"]

    def split_rows(src: str, dsts, sizes) -> None:
        for dst, piece in zip(dsts, torch.split(state[f"{src}.weight"], sizes, dim=0)):
            out[f"{dst}.weight"] = piece.contiguous()
        if f"{src}.bias" in state:
            for dst, piece in zip(dsts, torch.split(state[f"{src}.bias"], sizes)):
                out[f"{dst}.bias"] = piece.contiguous()

    d = state["img_in.weight"].shape[0]
    put("x_embedder", "img_in")
    put("context_embedder", "txt_in")
    put("time_text_embed.timestep_embedder.linear_1", "time_in.in_layer")
    put("time_text_embed.timestep_embedder.linear_2", "time_in.out_layer")
    put("time_text_embed.text_embedder.linear_1", "vector_in.in_layer")
    put("time_text_embed.text_embedder.linear_2", "vector_in.out_layer")
    if "guidance_in.in_layer.weight" in state:
        put("time_text_embed.guidance_embedder.linear_1", "guidance_in.in_layer")
        put("time_text_embed.guidance_embedder.linear_2", "guidance_in.out_layer")

    for i in range(_count(state, "double_blocks.")):
        s, p = f"double_blocks.{i}", f"transformer_blocks.{i}"
        put(f"{p}.norm1.linear", f"{s}.img_mod.lin")
        put(f"{p}.norm1_context.linear", f"{s}.txt_mod.lin")
        split_rows(f"{s}.img_attn.qkv", [f"{p}.attn.to_q", f"{p}.attn.to_k", f"{p}.attn.to_v"],
                   [d, d, d])
        split_rows(f"{s}.txt_attn.qkv",
                   [f"{p}.attn.add_q_proj", f"{p}.attn.add_k_proj", f"{p}.attn.add_v_proj"],
                   [d, d, d])
        out[f"{p}.attn.norm_q.weight"] = state[f"{s}.img_attn.norm.query_norm.scale"]
        out[f"{p}.attn.norm_k.weight"] = state[f"{s}.img_attn.norm.key_norm.scale"]
        out[f"{p}.attn.norm_added_q.weight"] = state[f"{s}.txt_attn.norm.query_norm.scale"]
        out[f"{p}.attn.norm_added_k.weight"] = state[f"{s}.txt_attn.norm.key_norm.scale"]
        put(f"{p}.attn.to_out.0", f"{s}.img_attn.proj")
        put(f"{p}.attn.to_add_out", f"{s}.txt_attn.proj")
        put(f"{p}.ff.net.0.proj", f"{s}.img_mlp.0")
        put(f"{p}.ff.net.2", f"{s}.img_mlp.2")
        put(f"{p}.ff_context.net.0.proj", f"{s}.txt_mlp.0")
        put(f"{p}.ff_context.net.2", f"{s}.txt_mlp.2")

    for i in range(_count(state, "single_blocks.")):
        s, p = f"single_blocks.{i}", f"single_transformer_blocks.{i}"
        put(f"{p}.norm.linear", f"{s}.modulation.lin")
        mlp_dim = state[f"{s}.linear1.weight"].shape[0] - 3 * d
        split_rows(f"{s}.linear1",
                   [f"{p}.attn.to_q", f"{p}.attn.to_k", f"{p}.attn.to_v", f"{p}.proj_mlp"],
                   [d, d, d, mlp_dim])
        put(f"{p}.proj_out", f"{s}.linear2")
        out[f"{p}.attn.norm_q.weight"] = state[f"{s}.norm.query_norm.scale"]
        out[f"{p}.attn.norm_k.weight"] = state[f"{s}.norm.key_norm.scale"]

    out["norm_out.linear.weight"] = _swap_scale_shift(
        state["final_layer.adaLN_modulation.1.weight"])
    if "final_layer.adaLN_modulation.1.bias" in state:
        out["norm_out.linear.bias"] = _swap_scale_shift(
            state["final_layer.adaLN_modulation.1.bias"])
    put("proj_out", "final_layer.linear")
    return out


def flux_config_from_state(state: State, head_dim: int = 128) -> FluxConfig:
    """FLUX geometry from a diffusers-named state dict's shapes (a single
    file has no config.json; every published FLUX.1 has head dim 128; dev
    has ``guidance_in``, schnell has not)."""
    inner = state["x_embedder.weight"].shape[0]
    return dataclasses.replace(
        FluxConfig(),
        in_channels=state["x_embedder.weight"].shape[1],
        num_layers=_count(state, "transformer_blocks."),
        num_single_layers=_count(state, "single_transformer_blocks."),
        attention_head_dim=head_dim,
        num_attention_heads=inner // head_dim,
        joint_attention_dim=state["context_embedder.weight"].shape[1],
        pooled_projection_dim=state["time_text_embed.text_embedder.linear_1.weight"].shape[1],
        guidance_embeds="time_text_embed.guidance_embedder.linear_1.weight" in state,
    )


def load_flux_single_file(path: str, cfg: Optional[FluxConfig] = None,
                          dtype: Optional[torch.dtype] = torch.float32):
    """A FLUX transformer from one safetensors file in BFL (optionally
    wrapped) or diffusers naming: (the converter's Flax-named tree, its
    config). ``cfg`` None infers the geometry (:func:`flux_config_from_state`);
    ``dtype`` None keeps the stored one."""
    state = strip_wrapper_prefixes(load_safetensors_state(path, dtype))
    if is_bfl_flux(state):
        state = bfl_flux_to_diffusers(state)
    if cfg is None:
        cfg = flux_config_from_state(state)
    return convert_flux_transformer(state, cfg), cfg
