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

Both blocks join their streams ([text; image]) and, in the single block,
their branches ([attention; MLP] for ``proj_out``) in place where
``ops/attention.py::joins_in_place`` says so (K1 runs, no SP backend, no
gradient recorded, and for the double block's text and image segments a text
of whole 128-token tiles): the double block hands K1 the
text and image q, k and v as they are and gets each stream's output dense;
the single block allocates ``proj_out``'s input once, K1 writes the attention
columns and ``ops/gelu.py`` the MLP's. Elsewhere they concatenate, as the JAX
blocks do.

Under tensor parallelism (``parallel/partition.py::shard_module``) a block
is a rank's copy: ``num_heads`` is its share of the heads, its q/k/v, MLP
and FF in-projections are column-parallel and its out-projections
row-parallel (their partial sums reduced inside the layer). The block puts
Megatron's ``f`` (``copy_to_tp``) once before each column-parallel group: the
modulated image stream, the modulated text stream and each FF's input. The
per-head q/k RMSNorm and the RoPE tables are the same on every rank; a
trained norm's weight takes ``f`` too, since each rank's heads give only
part of its gradient (XLA sums a replicated parameter's gradient itself). The ip
path cuts ``k_ip``/``v_ip`` (whole: the JAX rules replicate ``to_k_ip`` and
``to_v_ip``) to the rank's heads and gathers its output over tp.
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
from reptext_tpu_torch.ops.attention import attention, joins_in_place
from reptext_tpu_torch.ops.gelu import gelu_tanh_into
from reptext_tpu_torch.ops.rope import apply_rope_half
from reptext_tpu_torch.parallel.partition import copy_to_tp, gather_from_tp
from reptext_tpu_torch.parallel.sequence import JOINT_SP_ATTENTION


class TensorParallelBlock(nn.Module):
    """What both blocks read of their tensor-parallel copy: the rank and the
    tp group (``tp_size`` 1, the whole block, unless ``shard_module`` made it)."""

    tp_rank, tp_size, tp_group = 0, 1, None

    def tp_enter(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's ``f`` before a column-parallel group."""
        return x if self.tp_size == 1 else copy_to_tp(x, self.tp_group)

    def head_norm(self, norm: RMSNorm, x: torch.Tensor) -> torch.Tensor:
        """A per-head q/k RMSNorm: its weight, shared by every head, meets only
        the rank's heads here, so a trained one takes ``f`` (its gradient
        summed over tp), as a replicated parameter on split activations."""
        if self.tp_size == 1 or not norm.weight.requires_grad:
            return norm(x)
        return norm(x, copy_to_tp(norm.weight, self.tp_group))

    def check_backend(self, attention_backend: Optional[str]) -> None:
        if attention_backend is not None and self.tp_size > 1:
            raise ValueError("a tensor-parallel block runs no sequence-parallel backend "
                             f"({attention_backend!r}): shard one way")


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


class JointTransformerBlock(TensorParallelBlock):
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
        """Graft dense ``to_k_ip``/``to_v_ip`` ([ip_dim] -> heads x head dim),
        uninitialised, on the block's device and dtype (its q projection's
        bias: a ``QuantLinear`` of fp8 storage keeps its bias in the block's
        dtype)."""
        ref = self.to_q.bias
        for name in ("to_k_ip", "to_v_ip"):
            setattr(self, name, nn.Linear(ip_dim, self.to_q.out_features, device="meta",
                                          dtype=ref.dtype).to_empty(device=ref.device))

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: torch.Tensor,
                temb: torch.Tensor, rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                attention_backend: Optional[str] = None,
                ip_tokens: Optional[torch.Tensor] = None,
                ip_scale: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``ip_tokens`` [B or 1, N_ip, ip_dim] and ``ip_scale`` (a scalar or
        [B] per request): the IP-Adapter's image prompt, on a block that has
        one."""
        h = self.num_heads
        self.check_backend(attention_backend)
        s_txt = encoder_hidden_states.shape[1]
        norm_img, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(hidden_states, temb)
        norm_txt, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = self.norm1_context(
            encoder_hidden_states, temb)
        norm_img, norm_txt = self.tp_enter(norm_img), self.tp_enter(norm_txt)

        q_i = self.head_norm(self.norm_q, split_heads(self.to_q(norm_img), h))
        k_i = self.head_norm(self.norm_k, split_heads(self.to_k(norm_img), h))
        v_i = split_heads(self.to_v(norm_img), h)
        q_t = self.head_norm(self.norm_added_q, split_heads(self.add_q_proj(norm_txt), h))
        k_t = self.head_norm(self.norm_added_k, split_heads(self.add_k_proj(norm_txt), h))
        v_t = split_heads(self.add_v_proj(norm_txt), h)

        ip_attn = None
        if ip_tokens is not None and hasattr(self, "to_k_ip"):
            ip_tokens = ip_tokens.to(q_i.dtype)
            heads = slice(self.tp_rank * h, (self.tp_rank + 1) * h)   # this rank's
            k_ip = split_heads(self.to_k_ip(ip_tokens), h * self.tp_size)[:, heads]
            v_ip = split_heads(self.to_v_ip(ip_tokens), h * self.tp_size)[:, heads]
            if k_ip.shape[0] != q_i.shape[0]:
                k_ip, v_ip = (x.expand(q_i.shape[0], -1, -1, -1) for x in (k_ip, v_ip))
            ip_attn = merge_heads(ip_attention(q_i, k_ip, v_ip))
            if self.tp_size > 1:
                ip_attn = gather_from_tp(ip_attn, self.tp_group)
            scale = torch.as_tensor(1.0 if ip_scale is None else ip_scale, device=ip_attn.device)
            if scale.ndim == 1:        # per-request scale in a served batch
                scale = scale[:, None, None]
            ip_attn = scale.to(ip_attn.dtype) * ip_attn

        # joint sequence [text; image]; RoPE is applied inside attention
        if joins_in_place(s_txt + hidden_states.shape[1], attention_backend,
                          q_t, q_i, k_t, k_i, v_t, v_i, s_txt=s_txt):
            # the segments as they are; each stream's output comes back dense
            txt_attn, img_attn = (merge_heads(x) for x in attention(
                (q_t, q_i), (k_t, k_i), (v_t, v_i), rope_cos, rope_sin))
        else:
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
        ff_out = self.ff(self.tp_enter(modulate(hidden_states, shift_mlp, scale_mlp)))
        hidden_states = hidden_states + gate_mlp[:, None, :] * ff_out
        if ip_attn is not None:
            hidden_states = hidden_states + ip_attn

        encoder_hidden_states = (encoder_hidden_states
                                 + c_gate_msa[:, None, :] * self.to_add_out(txt_attn))
        ff_c = self.ff_context(self.tp_enter(modulate(encoder_hidden_states, c_shift_mlp,
                                                      c_scale_mlp)))
        encoder_hidden_states = encoder_hidden_states + c_gate_mlp[:, None, :] * ff_c
        return encoder_hidden_states, hidden_states


class SingleTransformerBlock(TensorParallelBlock):
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
        self.check_backend(attention_backend)
        normed, gate = self.norm(hidden_states, temb)
        normed = self.tp_enter(normed)
        mlp = self.proj_mlp(normed)
        q = self.head_norm(self.norm_q, split_heads(self.to_q(normed), h))
        k = self.head_norm(self.norm_k, split_heads(self.to_k(normed), h))
        v = split_heads(self.to_v(normed), h)
        if joins_in_place(q.shape[2], attention_backend, q, k, v, mlp):
            # proj_out's input, [attention; MLP], filled by its two producers
            inner = h * q.shape[3]
            buf = mlp.new_empty((*mlp.shape[:2], inner + mlp.shape[2]))
            gelu_tanh_into(mlp, buf[..., inner:])
            del mlp
            attention(q, k, v, rope_cos, rope_sin, out=split_heads(buf[..., :inner], h))
            out = self.proj_out(buf)
            return hidden_states + gate[:, None, :] * out
        mlp = gelu_tanh(mlp)
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
