"""Synthetic diffusers / transformers snapshots at any geometry, from a seed.

For the tests and ``chip_smoke.py``: no real checkpoint or tokenizer file is
in the repository. The state dicts carry exactly the key names the published
checkpoints use (FLUX.1-dev transformer and VAE, the Shakker-Labs RepText
ControlNet, CLIP-L, T5-XXL; the names of ``tests/synth_checkpoints.py``),
with random values drawn by a seeded ``torch.Generator`` on any device
(weights N(0, 1/fan_in), biases N(0, 0.02^2), norm scales 1), and are written
as HF-layout snapshot directories (config.json + safetensors) with the
port's writer, so that ``io/convert_cli.py`` reads them as it reads the real
ones. :func:`write_tokenizers` adds a small CLIP byte-BPE vocabulary and a
SentencePiece model for the vendored tokenizers.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import torch

from reptext_tpu_torch.configs import CLIPConfig, ControlNetConfig, FluxConfig, T5Config, VAEConfig
from reptext_tpu_torch.io.safetensors import save_file
from reptext_tpu_torch.text.clip_bpe import bytes_to_unicode

State = Dict[str, torch.Tensor]


class _Draw:
    """Seeded random tensors into a state dict, moved to the CPU in ``dtype``."""

    def __init__(self, seed: int, device, dtype: torch.dtype):
        self.device, self.dtype = torch.device(device), dtype
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state: State = {}

    def normal(self, name: str, shape, std: float):
        x = torch.randn(shape, generator=self.gen, device=self.device, dtype=torch.float32)
        self.state[name] = x.mul_(std).to(self.dtype).cpu()

    def const(self, name: str, shape, value: float):
        self.state[name] = torch.full(shape, value, dtype=self.dtype)

    def lin(self, name: str, i: int, o: int, bias: bool = True):
        self.normal(f"{name}.weight", (o, i), i ** -0.5)
        if bias:
            self.normal(f"{name}.bias", (o,), 0.02)

    def conv(self, name: str, i: int, o: int, k: int = 3):
        self.normal(f"{name}.weight", (o, i, k, k), (i * k * k) ** -0.5)
        self.normal(f"{name}.bias", (o,), 0.02)

    def norm(self, name: str, c: int, bias: bool = True):
        self.const(f"{name}.weight", (c,), 1.0)
        if bias:
            self.const(f"{name}.bias", (c,), 0.0)


def _mmdit_blocks(d: _Draw, num_layers: int, num_single: int, inner: int, head_dim: int,
                  controlnet: bool):
    for i in range(num_layers):
        p = f"transformer_blocks.{i}"
        d.lin(f"{p}.norm1.linear", inner, 6 * inner)
        d.lin(f"{p}.norm1_context.linear", inner, 6 * inner)
        for nm in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj", "add_v_proj"):
            d.lin(f"{p}.attn.{nm}", inner, inner)
        for nm in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
            d.norm(f"{p}.attn.{nm}", head_dim, bias=False)
        d.lin(f"{p}.attn.to_out.0", inner, inner)
        d.lin(f"{p}.attn.to_add_out", inner, inner)
        for ff in ("ff", "ff_context"):
            d.lin(f"{p}.{ff}.net.0.proj", inner, 4 * inner)
            d.lin(f"{p}.{ff}.net.2", 4 * inner, inner)
        if controlnet:
            d.lin(f"controlnet_blocks.{i}", inner, inner)
    for i in range(num_single):
        p = f"single_transformer_blocks.{i}"
        d.lin(f"{p}.norm.linear", inner, 3 * inner)
        d.lin(f"{p}.proj_mlp", inner, 4 * inner)
        d.lin(f"{p}.proj_out", 5 * inner, inner)
        for nm in ("to_q", "to_k", "to_v"):
            d.lin(f"{p}.attn.{nm}", inner, inner)
        for nm in ("norm_q", "norm_k"):
            d.norm(f"{p}.attn.{nm}", head_dim, bias=False)
        if controlnet:
            d.lin(f"controlnet_single_blocks.{i}", inner, inner)


def _time_text_embed(d: _Draw, cfg):
    embs = [("timestep_embedder", cfg.time_embed_dim),
            ("text_embedder", cfg.pooled_projection_dim)]
    if cfg.guidance_embeds:
        embs.insert(1, ("guidance_embedder", cfg.time_embed_dim))
    for emb, width in embs:
        d.lin(f"time_text_embed.{emb}.linear_1", width, cfg.inner_dim)
        d.lin(f"time_text_embed.{emb}.linear_2", cfg.inner_dim, cfg.inner_dim)


def flux_state(cfg: FluxConfig, seed: int = 0, device="cpu",
               dtype: torch.dtype = torch.float32) -> State:
    """diffusers FluxTransformer2DModel state dict."""
    d = _Draw(seed, device, dtype)
    inner = cfg.inner_dim
    d.lin("x_embedder", cfg.in_channels, inner)
    d.lin("context_embedder", cfg.joint_attention_dim, inner)
    _time_text_embed(d, cfg)
    _mmdit_blocks(d, cfg.num_layers, cfg.num_single_layers, inner, cfg.attention_head_dim,
                  controlnet=False)
    d.lin("norm_out.linear", inner, 2 * inner)
    d.lin("proj_out", inner, cfg.out_channels)
    return d.state


def controlnet_state(cfg: ControlNetConfig, seed: int = 1, device="cpu",
                     dtype: torch.dtype = torch.float32) -> State:
    """diffusers FluxControlNetModel state dict (RepText layout, not union)."""
    d = _Draw(seed, device, dtype)
    inner = cfg.inner_dim
    d.lin("x_embedder", cfg.in_channels, inner)
    d.lin("controlnet_x_embedder", cfg.in_channels + cfg.extra_condition_channels, inner)
    d.lin("context_embedder", cfg.joint_attention_dim, inner)
    _time_text_embed(d, cfg)
    _mmdit_blocks(d, cfg.num_layers, cfg.num_single_layers, inner, cfg.attention_head_dim,
                  controlnet=True)
    return d.state


def vae_state(cfg: VAEConfig, seed: int = 2, device="cpu",
              dtype: torch.dtype = torch.float32) -> State:
    """diffusers AutoencoderKL state dict."""
    d = _Draw(seed, device, dtype)
    ch = cfg.block_out_channels

    def resnet(prefix, i, o):
        d.norm(f"{prefix}.norm1", i)
        d.conv(f"{prefix}.conv1", i, o)
        d.norm(f"{prefix}.norm2", o)
        d.conv(f"{prefix}.conv2", o, o)
        if i != o:
            d.conv(f"{prefix}.conv_shortcut", i, o, 1)

    def attn(prefix, c):
        d.norm(f"{prefix}.group_norm", c)
        for nm in ("to_q", "to_k", "to_v", "to_out.0"):
            d.lin(f"{prefix}.{nm}", c, c)

    def mid(side):
        resnet(f"{side}.mid_block.resnets.0", ch[-1], ch[-1])
        attn(f"{side}.mid_block.attentions.0", ch[-1])
        resnet(f"{side}.mid_block.resnets.1", ch[-1], ch[-1])

    d.conv("encoder.conv_in", cfg.in_channels, ch[0])
    in_c = ch[0]
    for i, out_c in enumerate(ch):
        for j in range(cfg.layers_per_block):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", in_c if j == 0 else out_c, out_c)
        if i < len(ch) - 1:
            d.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", out_c, out_c)
        in_c = out_c
    mid("encoder")
    d.norm("encoder.conv_norm_out", ch[-1])
    d.conv("encoder.conv_out", ch[-1], 2 * cfg.latent_channels)

    d.conv("decoder.conv_in", cfg.latent_channels, ch[-1])
    mid("decoder")
    rev = list(reversed(ch))
    in_c = rev[0]
    for i, out_c in enumerate(rev):
        for j in range(cfg.layers_per_block + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", in_c if j == 0 else out_c, out_c)
        if i < len(ch) - 1:
            d.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", out_c, out_c)
        in_c = out_c
    d.norm("decoder.conv_norm_out", ch[0])
    d.conv("decoder.conv_out", ch[0], cfg.out_channels)
    return d.state


def clip_state(cfg: CLIPConfig, seed: int = 3, device="cpu",
               dtype: torch.dtype = torch.float32) -> State:
    """transformers CLIPTextModel state dict."""
    d = _Draw(seed, device, dtype)
    tm, h = "text_model", cfg.hidden_size
    d.normal(f"{tm}.embeddings.token_embedding.weight", (cfg.vocab_size, h), 0.02)
    d.normal(f"{tm}.embeddings.position_embedding.weight", (cfg.max_position_embeddings, h), 0.02)
    for i in range(cfg.num_layers):
        p = f"{tm}.encoder.layers.{i}"
        d.norm(f"{p}.layer_norm1", h)
        d.norm(f"{p}.layer_norm2", h)
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            d.lin(f"{p}.self_attn.{nm}", h, h)
        d.lin(f"{p}.mlp.fc1", h, cfg.intermediate_size)
        d.lin(f"{p}.mlp.fc2", cfg.intermediate_size, h)
    d.norm(f"{tm}.final_layer_norm", h)
    return d.state


def t5_state(cfg: T5Config, seed: int = 4, device="cpu",
             dtype: torch.dtype = torch.float32) -> State:
    """transformers T5EncoderModel state dict (bias-free linears)."""
    d = _Draw(seed, device, dtype)
    dm, inner = cfg.d_model, cfg.num_heads * cfg.d_kv
    d.normal("shared.weight", (cfg.vocab_size, dm), 1.0)
    d.normal("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
             (cfg.relative_attention_num_buckets, cfg.num_heads), 0.02)
    for i in range(cfg.num_layers):
        p = f"encoder.block.{i}"
        d.norm(f"{p}.layer.0.layer_norm", dm, bias=False)
        for nm in ("q", "k", "v"):
            d.lin(f"{p}.layer.0.SelfAttention.{nm}", dm, inner, bias=False)
        d.lin(f"{p}.layer.0.SelfAttention.o", inner, dm, bias=False)
        d.norm(f"{p}.layer.1.layer_norm", dm, bias=False)
        d.lin(f"{p}.layer.1.DenseReluDense.wi_0", dm, cfg.d_ff, bias=False)
        d.lin(f"{p}.layer.1.DenseReluDense.wi_1", dm, cfg.d_ff, bias=False)
        d.lin(f"{p}.layer.1.DenseReluDense.wo", cfg.d_ff, dm, bias=False)
    d.norm("encoder.final_layer_norm", dm, bias=False)
    return d.state


# ------------------------------------------------------ HF snapshot layout


def hf_config(cfg) -> Dict[str, object]:
    """The HF config.json of a component config: the inverse of
    ``io/convert_cli.py``'s ``*_config_from_hf``."""
    from reptext_tpu_torch.io.convert_cli import HF_KEYS

    out = {}
    for ours, theirs in HF_KEYS[type(cfg)].items():
        v = getattr(cfg, ours)
        out[theirs] = list(v) if isinstance(v, tuple) else v
    return out


def write_component(dir_path: str, state: State, config: Dict[str, object],
                    shards: int = 1) -> int:
    """``state`` as config.json + one or more .safetensors shards; the bytes written."""
    os.makedirs(dir_path, exist_ok=True)
    with open(os.path.join(dir_path, "config.json"), "w") as f:
        json.dump(config, f)
    keys = sorted(state)
    per = max(1, -(-len(keys) // shards))
    written = 0
    for s in range(shards):
        chunk = {k: state[k] for k in keys[s * per:(s + 1) * per]}
        if chunk:
            name = ("model.safetensors" if shards == 1
                    else f"model-{s + 1:05d}-of-{shards:05d}.safetensors")
            written += save_file(chunk, os.path.join(dir_path, name))
    return written


def write_pipeline_snapshot(root: str, flux_cfg: FluxConfig, vae_cfg: VAEConfig,
                            clip_cfg: CLIPConfig, t5_cfg: T5Config, seed: int = 0,
                            device="cpu", dtype: torch.dtype = torch.float32,
                            shards: int = 2) -> int:
    """An HF FLUX.1-dev-style snapshot (transformer/ vae/ text_encoder/
    text_encoder_2/, the transformer in ``shards`` files); the bytes written.
    One component's state is in host memory at a time."""
    written = 0
    for sub, fn, cfg, n in (("transformer", flux_state, flux_cfg, shards),
                            ("vae", vae_state, vae_cfg, 1),
                            ("text_encoder", clip_state, clip_cfg, 1),
                            ("text_encoder_2", t5_state, t5_cfg, 1)):
        state = fn(cfg, seed=seed + len(sub), device=device, dtype=dtype)
        written += write_component(os.path.join(root, sub), state, hf_config(cfg), n)
        del state
    return written


def write_controlnet_snapshot(root: str, cfg: ControlNetConfig, seed: int = 1, device="cpu",
                              dtype: torch.dtype = torch.float32) -> int:
    """A Shakker-Labs/RepText-style standalone ControlNet snapshot; the bytes written."""
    state = controlnet_state(cfg, seed=seed, device=device, dtype=dtype)
    return write_component(root, state, dict(hf_config(cfg), num_mode=cfg.num_mode))


# --------------------------------------------------------------- tokenizers


CLIP_MERGES = [("h", "e"), ("l", "l"), ("ll", "o</w>"), ("he", "llo</w>"),
               ("w", "o"), ("r", "l"), ("wo", "rl"), ("worl", "d</w>"), ("1", "2")]


def clip_vocab() -> Dict[str, int]:
    """A small but structurally real CLIP vocabulary: the byte alphabet, its
    end-of-word forms, the merges of ``CLIP_MERGES`` and the two special
    tokens, ``<|endoftext|>`` the largest id."""
    byte_chars = list(bytes_to_unicode().values())
    vocab: Dict[str, int] = {}
    for c in byte_chars:
        vocab[c] = len(vocab)
    for c in byte_chars:
        vocab[c + "</w>"] = len(vocab)
    for a, b in CLIP_MERGES:
        vocab.setdefault(a + b, len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab


def write_clip_tokenizer(path: str) -> Dict[str, int]:
    """:func:`clip_vocab` and ``CLIP_MERGES`` as vocab.json + merges.txt;
    returns the vocabulary."""
    vocab = clip_vocab()
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in CLIP_MERGES))
    return vocab


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def serialize_model_proto(pieces) -> bytes:
    """A minimal SentencePiece ModelProto (field 1: SentencePiece{piece,
    score, type}) plus one unrelated field that a reader must skip."""
    out = bytearray()
    for piece, score, ptype in pieces:
        pb = piece.encode("utf-8")
        body = b"\x0a" + _varint(len(pb)) + pb + b"\x15" + struct.pack("<f", score)
        body += b"\x18" + _varint(ptype)
        out += b"\x0a" + _varint(len(body)) + body
    out += b"\x12" + _varint(3) + b"abc"
    return bytes(out)


def spm_pieces():
    """A small unigram piece table: <pad> 0, </s> 1, <unk> 2, then Latin and
    Arabic pieces."""
    from reptext_tpu_torch.text.spm import CONTROL, NORMAL, UNKNOWN

    pieces = [("<pad>", 0.0, CONTROL), ("</s>", 0.0, CONTROL), ("<unk>", 0.0, UNKNOWN),
              ("▁", -4.0, NORMAL), ("▁hello", -1.5, NORMAL), ("▁world", -1.8, NORMAL),
              ("▁he", -3.0, NORMAL), ("llo", -3.5, NORMAL), ("▁a", -2.5, NORMAL),
              ("▁sign", -2.0, NORMAL), ("▁مرحبا", -1.6, NORMAL), ("▁ال", -2.2, NORMAL)]
    pieces += [(c, -5.0 - 0.01 * i, NORMAL) for i, c in enumerate("abdeghilnorstw'،مرحبالع")]
    return pieces


def write_tokenizers(root: str, pieces=None) -> Dict[str, str]:
    """``root/tokenizer`` (CLIP) and ``root/tokenizer_2/spiece.model`` (T5),
    as an HF pipeline snapshot holds them; {name: path}."""
    write_clip_tokenizer(os.path.join(root, "tokenizer"))
    os.makedirs(os.path.join(root, "tokenizer_2"), exist_ok=True)
    spm = os.path.join(root, "tokenizer_2", "spiece.model")
    with open(spm, "wb") as f:
        f.write(serialize_model_proto(spm_pieces() if pieces is None else pieces))
    return {"tokenizer": os.path.join(root, "tokenizer"), "tokenizer_2": spm}
