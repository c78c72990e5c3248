"""FLUX MMDiT transformer blocks (PyTorch).

Counterpart of ``reptext_tpu/nn/blocks.py``: the double-stream joint block
(AdaLN-Zero per stream, joint attention over [text; image] with RoPE rotated
inside the attention op, gated residuals, per-stream gelu-tanh FF) and the
single-stream block (parallel attention and MLP branches projected out
together). Per-head RMS q/k norm in both. With ``attention_backend`` 'ring'
or 'ulysses' (JAX :131-151, :225-245) a block runs sequence-parallel: text
tokens on every rank, image tokens sharded, q and k rotated with the rank's
tables before the joint ring or Ulysses attention of ``parallel/sequence.py``
over the group of the thread's SP context.

A double block given the IP-Adapter
(:meth:`JointTransformerBlock.add_ip_adapter`) carries its ``to_k_ip`` /
``to_v_ip`` (JAX ``ip_adapter=True``, :61-67, :106-123, :165-166): the image
stream's post-q-norm, RoPE-free queries attend over the projected
image-prompt tokens (no k-norm on those keys) in plain PyTorch, XLA's
``xla_attention`` in the JAX package (no Pallas kernel's counterpart: 4
keys), and the result, times ``ip_scale``, is added after the FF residual.
Under SP the queries are the rank's own image tokens and the ip tokens are
whole on every rank. Given no ``ip_tokens`` such a block skips the path, so
pipelines that share the module and pass none run as before.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from reptext_tpu_torch.nn.layers import (
    AdaLayerNormZero,
    AdaLayerNormZeroSingle,
    FeedForward,
    RMSNorm,
    gelu_tanh,
    modulate,
)
from reptext_tpu_torch.ops.attention import attention
from reptext_tpu_torch.ops.rope import apply_rope_half
from reptext_tpu_torch.parallel.sequence import JOINT_SP_ATTENTION


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H*D] -> [B, H, S, D] (a view)."""
    b, s, hd = x.shape
    return x.view(b, s, num_heads, hd // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] -> [B, S, H*D]."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def sp_joint_attention(backend: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       rope_cos: torch.Tensor, rope_sin: torch.Tensor, s_txt: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The blocks' SP branch on the joint [text; image shard] q, k, v:
    (text output [B, S_txt, H*D], image output shard [B, S_img/n, H*D])."""
    sp_attn = JOINT_SP_ATTENTION.get(backend)
    if sp_attn is None:
        raise ValueError(f"unknown attention_backend {backend!r} (None, ring or ulysses)")
    # rotated here, with the rank's tables, so roped K blocks travel
    q = apply_rope_half(q, rope_cos, rope_sin)
    k = apply_rope_half(k, rope_cos, rope_sin)
    attn_t, attn_i = sp_attn(q[:, :, :s_txt], k[:, :, :s_txt], v[:, :, :s_txt],
                             q[:, :, s_txt:], k[:, :, s_txt:], v[:, :, s_txt:])
    return merge_heads(attn_t), merge_heads(attn_i)


def ip_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``xla_attention``: [B, H, S, D] q over a few keys, fp32 logits and
    softmax, probabilities in v's dtype."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    return torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)


class JointTransformerBlock(nn.Module):
    """Double-stream MMDiT block over (image tokens, text tokens)."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, mlp_ratio: float = 4.0,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inner = num_heads * head_dim
        self.num_heads = num_heads
        self.norm1 = AdaLayerNormZero(dim, **kw)
        self.norm1_context = AdaLayerNormZero(dim, **kw)
        self.to_q = nn.Linear(dim, inner, **kw)
        self.to_k = nn.Linear(dim, inner, **kw)
        self.to_v = nn.Linear(dim, inner, **kw)
        self.add_q_proj = nn.Linear(dim, inner, **kw)
        self.add_k_proj = nn.Linear(dim, inner, **kw)
        self.add_v_proj = nn.Linear(dim, inner, **kw)
        self.norm_q = RMSNorm(head_dim, **kw)
        self.norm_k = RMSNorm(head_dim, **kw)
        self.norm_added_q = RMSNorm(head_dim, **kw)
        self.norm_added_k = RMSNorm(head_dim, **kw)
        self.to_out = nn.Linear(inner, dim, **kw)
        self.to_add_out = nn.Linear(inner, dim, **kw)
        self.ff = FeedForward(dim, mlp_ratio, **kw)
        self.ff_context = FeedForward(dim, mlp_ratio, **kw)

    def add_ip_adapter(self, ip_dim: int) -> None:
        """Graft ``to_k_ip``/``to_v_ip`` ([ip_dim] -> heads x head dim),
        uninitialised, on the block's device and dtype."""
        w = self.to_q.weight
        for name in ("to_k_ip", "to_v_ip"):
            setattr(self, name, nn.Linear(ip_dim, w.shape[0], device="meta", dtype=w.dtype)
                    .to_empty(device=w.device))

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: torch.Tensor,
                temb: torch.Tensor, rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                attention_backend: Optional[str] = None,
                ip_tokens: Optional[torch.Tensor] = None,
                ip_scale: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``ip_tokens`` [B or 1, N_ip, ip_dim] and ``ip_scale`` (a scalar or
        [B] per request): the IP-Adapter's image prompt, on a block that has
        one."""
        h = self.num_heads
        s_txt = encoder_hidden_states.shape[1]
        norm_img, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(hidden_states, temb)
        norm_txt, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(
            encoder_hidden_states, temb)

        q_i = self.norm_q(split_heads(self.to_q(norm_img), h))
        k_i = self.norm_k(split_heads(self.to_k(norm_img), h))
        v_i = split_heads(self.to_v(norm_img), h)
        q_t = self.norm_added_q(split_heads(self.add_q_proj(norm_txt), h))
        k_t = self.norm_added_k(split_heads(self.add_k_proj(norm_txt), h))
        v_t = split_heads(self.add_v_proj(norm_txt), h)

        ip_attn = None
        if ip_tokens is not None and hasattr(self, "to_k_ip"):
            ip_tokens = ip_tokens.to(q_i.dtype)
            k_ip = split_heads(self.to_k_ip(ip_tokens), h)
            v_ip = split_heads(self.to_v_ip(ip_tokens), h)
            if k_ip.shape[0] != q_i.shape[0]:
                k_ip, v_ip = (x.expand(q_i.shape[0], -1, -1, -1) for x in (k_ip, v_ip))
            ip_attn = merge_heads(ip_attention(q_i, k_ip, v_ip))
            scale = torch.as_tensor(1.0 if ip_scale is None else ip_scale, device=ip_attn.device)
            if scale.ndim == 1:        # per-request scale in a served batch
                scale = scale[:, None, None]
            ip_attn = scale.to(ip_attn.dtype) * ip_attn

        # joint sequence [text; image]; RoPE is applied inside attention
        q = torch.cat([q_t, q_i], dim=2)
        k = torch.cat([k_t, k_i], dim=2)
        v = torch.cat([v_t, v_i], dim=2)
        if attention_backend is None:
            attn = merge_heads(attention(q, k, v, rope_cos, rope_sin))
            txt_attn, img_attn = attn[:, :s_txt], attn[:, s_txt:]
        else:
            txt_attn, img_attn = sp_joint_attention(attention_backend, q, k, v, rope_cos,
                                                    rope_sin, s_txt)

        hidden_states = hidden_states + gate_msa[:, None, :] * self.to_out(img_attn)
        ff_out = self.ff(modulate(hidden_states, shift_mlp, scale_mlp))
        hidden_states = hidden_states + gate_mlp[:, None, :] * ff_out
        if ip_attn is not None:
            hidden_states = hidden_states + ip_attn

        encoder_hidden_states = (encoder_hidden_states
                                 + c_gate_msa[:, None, :] * self.to_add_out(txt_attn))
        ff_c = self.ff_context(modulate(encoder_hidden_states, c_shift_mlp, c_scale_mlp))
        encoder_hidden_states = encoder_hidden_states + c_gate_mlp[:, None, :] * ff_c
        return encoder_hidden_states, hidden_states


class SingleTransformerBlock(nn.Module):
    """Single-stream block over the concatenated [text; image] sequence."""

    def __init__(self, dim: int, num_heads: int, head_dim: int, mlp_ratio: float = 4.0,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        inner = num_heads * head_dim
        self.num_heads = num_heads
        self.norm = AdaLayerNormZeroSingle(dim, **kw)
        self.proj_mlp = nn.Linear(dim, int(dim * mlp_ratio), **kw)
        self.to_q = nn.Linear(dim, inner, **kw)
        self.to_k = nn.Linear(dim, inner, **kw)
        self.to_v = nn.Linear(dim, inner, **kw)
        self.norm_q = RMSNorm(head_dim, **kw)
        self.norm_k = RMSNorm(head_dim, **kw)
        self.proj_out = nn.Linear(inner + int(dim * mlp_ratio), dim, **kw)

    def forward(self, hidden_states: torch.Tensor, temb: torch.Tensor,
                rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                attention_backend: Optional[str] = None,
                txt_len: Optional[int] = None) -> torch.Tensor:
        """``txt_len``: the text tokens at the head of the sequence, which
        the SP backends need (they are replicated, the rest is sharded)."""
        h = self.num_heads
        normed, gate = self.norm(hidden_states, temb)
        mlp = gelu_tanh(self.proj_mlp(normed))
        q = self.norm_q(split_heads(self.to_q(normed), h))
        k = self.norm_k(split_heads(self.to_k(normed), h))
        v = split_heads(self.to_v(normed), h)
        if attention_backend is None:
            attn = merge_heads(attention(q, k, v, rope_cos, rope_sin))
        else:
            if txt_len is None:
                raise ValueError(f"attention_backend={attention_backend!r} needs txt_len on "
                                 "the single block")
            attn = torch.cat(sp_joint_attention(attention_backend, q, k, v, rope_cos, rope_sin,
                                                txt_len), dim=1)
        out = self.proj_out(torch.cat([attn, mlp], dim=-1))
        return hidden_states + gate[:, None, :] * out
