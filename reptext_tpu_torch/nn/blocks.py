"""FLUX MMDiT transformer blocks (PyTorch).

Counterpart of ``reptext_tpu/nn/blocks.py``: the double-stream joint block
(AdaLN-Zero per stream, joint attention over [text; image] with RoPE rotated
inside the attention op, gated residuals, per-stream gelu-tanh FF) and the
single-stream block (parallel attention and MLP branches projected out
together). Per-head RMS q/k norm in both. The IP-Adapter and the
sequence-parallel (ring/ulysses) branches are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

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


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, H*D] -> [B, H, S, D] (a view)."""
    b, s, hd = x.shape
    return x.view(b, s, num_heads, hd // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] -> [B, S, H*D]."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


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

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: torch.Tensor,
                temb: torch.Tensor, rope_cos: torch.Tensor, rope_sin: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
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

        # joint sequence [text; image]; RoPE is applied inside attention
        q = torch.cat([q_t, q_i], dim=2)
        k = torch.cat([k_t, k_i], dim=2)
        v = torch.cat([v_t, v_i], dim=2)
        attn = merge_heads(attention(q, k, v, rope_cos, rope_sin))
        txt_attn, img_attn = attn[:, :s_txt], attn[:, s_txt:]

        hidden_states = hidden_states + gate_msa[:, None, :] * self.to_out(img_attn)
        ff_out = self.ff(modulate(hidden_states, shift_mlp, scale_mlp))
        hidden_states = hidden_states + gate_mlp[:, None, :] * ff_out

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
                rope_cos: torch.Tensor, rope_sin: torch.Tensor) -> torch.Tensor:
        h = self.num_heads
        normed, gate = self.norm(hidden_states, temb)
        mlp = gelu_tanh(self.proj_mlp(normed))
        q = self.norm_q(split_heads(self.to_q(normed), h))
        k = self.norm_k(split_heads(self.to_k(normed), h))
        v = split_heads(self.to_v(normed), h)
        attn = merge_heads(attention(q, k, v, rope_cos, rope_sin))
        out = self.proj_out(torch.cat([attn, mlp], dim=-1))
        return hidden_states + gate[:, None, :] * out
