"""CLIP-L/14 text encoder (PyTorch): the source of FLUX's pooled prompt embedding.

Counterpart of ``reptext_tpu/nn/clip.py``: causal pre-LN transformer with
quick-gelu MLPs and a final LayerNorm; the pooled output is the hidden state
at the EOS position (argmax of the token ids). LayerNorms run in float32.
Layers are named ``layer_{i}`` after the Flax tree.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from reptext_tpu_torch.configs import CLIPConfig


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def layer_norm_f32(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
                        ln.eps).to(x.dtype)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps, **kw)
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps, **kw)
        self.q_proj = nn.Linear(d, d, **kw)
        self.k_proj = nn.Linear(d, d, **kw)
        self.v_proj = nn.Linear(d, d, **kw)
        self.out_proj = nn.Linear(d, d, **kw)
        self.fc1 = nn.Linear(d, cfg.intermediate_size, **kw)
        self.fc2 = nn.Linear(cfg.intermediate_size, d, **kw)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        hd = d // self.num_heads
        h = layer_norm_f32(self.layer_norm1, x)

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.view(b, s, self.num_heads, hd).transpose(1, 2)

        q = heads(self.q_proj(h)) * (hd ** -0.5)
        k, v = heads(self.k_proj(h)), heads(self.v_proj(h))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        logits = logits.masked_fill(~causal_mask, float("-inf"))
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        attn = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, d)
        x = x + self.out_proj(attn)
        h = layer_norm_f32(self.layer_norm2, x)
        return x + self.fc2(quick_gelu(self.fc1(h)))


class CLIPTextEncoder(nn.Module):
    """input_ids [B, S] -> (last_hidden_state [B, S, D], pooled [B, D])."""

    def __init__(self, config: CLIPConfig, device=None, dtype=None):
        super().__init__()
        cfg = config
        kw = dict(device=device, dtype=dtype)
        self.config = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **kw)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size, **kw)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", CLIPEncoderLayer(cfg, **kw))
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, **kw)

    def forward(self, input_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        b, s = input_ids.shape
        if s > cfg.max_position_embeddings:
            raise ValueError(f"sequence length {s} exceeds max_position_embeddings "
                             f"{cfg.max_position_embeddings} for this CLIPConfig")
        pos = torch.arange(s, device=input_ids.device)
        x = self.token_embedding(input_ids) + self.position_embedding(pos)[None]
        causal = torch.ones(s, s, dtype=torch.bool, device=input_ids.device).tril()[None, None]
        for i in range(cfg.num_layers):
            x = getattr(self, f"layer_{i}")(x, causal)
        x = layer_norm_f32(self.final_layer_norm, x)
        eos = input_ids.argmax(dim=-1)
        return x, x[torch.arange(b, device=x.device), eos]
