"""T5 v1.1 (gated-gelu) encoder stack (PyTorch): FLUX's sequence prompt embedding.

Counterpart of ``reptext_tpu/nn/t5.py``: RMS-style T5LayerNorm (no mean, no
bias), unscaled attention with one bucketed relative-position bias computed
once and shared by every layer, gated-gelu feedforward. Layers are named
``layer_{i}`` after the Flax tree.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from reptext_tpu_torch.configs import T5Config


class T5LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.pow(2).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight.to(x.dtype)


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional T5 relative-position bucketing."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), val_if_large)


class T5EncoderLayer(nn.Module):
    def __init__(self, cfg: T5Config, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype, bias=False)
        inner = cfg.num_heads * cfg.d_kv
        self.num_heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.attn_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, device, dtype)
        self.q = nn.Linear(cfg.d_model, inner, **kw)
        self.k = nn.Linear(cfg.d_model, inner, **kw)
        self.v = nn.Linear(cfg.d_model, inner, **kw)
        self.o = nn.Linear(inner, cfg.d_model, **kw)
        self.ff_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, device, dtype)
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, **kw)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, **kw)

    def forward(self, x: torch.Tensor, position_bias: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        h = self.attn_layer_norm(x)

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.view(b, s, self.num_heads, self.d_kv).transpose(1, 2)

        q, k, v = heads(self.q(h)), heads(self.k(h)), heads(self.v(h))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) + position_bias
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, -1)
        x = x + self.o(attn)
        h = self.ff_layer_norm(x)
        return x + self.wo(F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h))


class T5Encoder(nn.Module):
    """input_ids [B, S] -> last hidden states [B, S, d_model]."""

    def __init__(self, config: T5Config, device=None, dtype=None):
        super().__init__()
        cfg = config
        self.config = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, device=device, dtype=dtype)
        self.relative_attention_bias = nn.Embedding(
            cfg.relative_attention_num_buckets, cfg.num_heads, device=device, dtype=dtype)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", T5EncoderLayer(cfg, device, dtype))
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon, device, dtype)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = self.shared(input_ids)
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           cfg.relative_attention_num_buckets,
                                           cfg.relative_attention_max_distance)
        bias = self.relative_attention_bias.weight.float()[buckets.long()]  # [S, S, H]
        position_bias = bias.permute(2, 0, 1)[None]                        # [1, H, S, S]
        for i in range(cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, position_bias)
        return self.final_layer_norm(x)
