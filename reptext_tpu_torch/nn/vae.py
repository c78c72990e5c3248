"""FLUX AutoencoderKL (f=8, 16 latent channels) in PyTorch, NCHW.

Counterpart of ``reptext_tpu/nn/vae.py`` (which is NHWC): encoder conv_in ->
4 down stages (resnets, then a stride-2 conv after an asymmetric (0,1) pad)
-> mid (resnet, single-head spatial attention, resnet) -> GroupNorm/silu/
conv_out to 2 * latent moments; the decoder mirrors it with nearest x2
upsampling. GroupNorm runs in float32. Submodule names follow the Flax tree
(``down_{i}_block_{j}``, ``mid_attn``, ``norm1.norm``, ...). Scaling and
shift factors are applied by the pipeline. ``remat`` recomputes each of the
decoder's resnet and attention blocks in the backward pass
(``torch.utils.checkpoint``) when autograd records: a decode with gradients
(the OCR training term) at 1024^2 would otherwise keep every block's
activations, several GiB a block at the last stage.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from reptext_tpu_torch.configs import VAEConfig


class GroupNorm32(nn.Module):
    """GroupNorm computed in float32, cast back (eps 1e-6)."""

    def __init__(self, num_groups: int, channels: int, device=None, dtype=None):
        super().__init__()
        self.norm = nn.GroupNorm(num_groups, channels, eps=1e-6, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.norm
        return F.group_norm(x.float(), n.num_groups, n.weight.float(), n.bias.float(),
                            n.eps).to(x.dtype)


def _conv3(cin: int, cout: int, stride: int = 1, padding: int = 1, device=None, dtype=None):
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=padding, device=device, dtype=dtype)


class ResnetBlock(nn.Module):
    def __init__(self, cin: int, cout: int, groups: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = GroupNorm32(groups, cin, **kw)
        self.conv1 = _conv3(cin, cout, **kw)
        self.norm2 = GroupNorm32(groups, cout, **kw)
        self.conv2 = _conv3(cout, cout, **kw)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1, **kw) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over spatial tokens (plain PyTorch)."""

    query_chunk = 4096

    def __init__(self, channels: int, groups: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.group_norm = GroupNorm32(groups, channels, **kw)
        self.to_q = nn.Linear(channels, channels, **kw)
        self.to_k = nn.Linear(channels, channels, **kw)
        self.to_v = nn.Linear(channels, channels, **kw)
        self.to_out = nn.Linear(channels, channels, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        tokens = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        q, k, v = self.to_q(tokens), self.to_k(tokens), self.to_v(tokens)
        kt = k.float().transpose(1, 2)
        # query chunks bound the fp32 [B, chunk, HW] logits (36864 keys at
        # 1536^2: 5.4 GB a sample unchunked); each row's math is unchanged
        out = torch.cat([
            torch.matmul(torch.softmax(torch.matmul(qc.float(), kt) / (c ** 0.5),
                                       dim=-1).to(v.dtype), v)
            for qc in q.split(self.query_chunk, dim=1)], dim=1)
        out = self.to_out(out)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        ch, g = cfg.block_out_channels, cfg.norm_num_groups
        self.n_stages, self.layers_per_block = len(ch), cfg.layers_per_block
        self.conv_in = _conv3(cfg.in_channels, ch[0], **kw)
        cin = ch[0]
        for i, cout in enumerate(ch):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_block_{j}", ResnetBlock(cin, cout, g, **kw))
                cin = cout
            if i < len(ch) - 1:
                self.add_module(f"down_{i}_downsample", _conv3(cout, cout, 2, 0, **kw))
        self.mid_block_1 = ResnetBlock(ch[-1], ch[-1], g, **kw)
        self.mid_attn = AttnBlock(ch[-1], g, **kw)
        self.mid_block_2 = ResnetBlock(ch[-1], ch[-1], g, **kw)
        self.norm_out = GroupNorm32(g, ch[-1], **kw)
        self.conv_out = _conv3(ch[-1], 2 * cfg.latent_channels, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for i in range(self.n_stages):
            for j in range(self.layers_per_block):
                x = getattr(self, f"down_{i}_block_{j}")(x)
            if i < self.n_stages - 1:
                # asymmetric (0, 1) pad, then a stride-2 conv (diffusers Downsample2D)
                x = getattr(self, f"down_{i}_downsample")(F.pad(x, (0, 1, 0, 1)))
        x = self.mid_block_2(self.mid_attn(self.mid_block_1(x)))
        return self.conv_out(F.silu(self.norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, device=None, dtype=None, remat: bool = False):
        super().__init__()
        self.remat = remat
        kw = dict(device=device, dtype=dtype)
        ch, g = cfg.block_out_channels, cfg.norm_num_groups
        self.n_stages, self.layers_per_block = len(ch), cfg.layers_per_block
        self.conv_in = _conv3(cfg.latent_channels, ch[-1], **kw)
        self.mid_block_1 = ResnetBlock(ch[-1], ch[-1], g, **kw)
        self.mid_attn = AttnBlock(ch[-1], g, **kw)
        self.mid_block_2 = ResnetBlock(ch[-1], ch[-1], g, **kw)
        cin = ch[-1]
        for i, cout in enumerate(reversed(ch)):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_block_{j}", ResnetBlock(cin, cout, g, **kw))
                cin = cout
            if i < len(ch) - 1:
                self.add_module(f"up_{i}_upsample", _conv3(cout, cout, **kw))
        self.norm_out = GroupNorm32(g, ch[0], **kw)
        self.conv_out = _conv3(ch[0], cfg.out_channels, **kw)

    def _run(self, block: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, x, use_reentrant=False)
        return block(x)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(z)
        for block in (self.mid_block_1, self.mid_attn, self.mid_block_2):
            x = self._run(block, x)
        for i in range(self.n_stages):
            for j in range(self.layers_per_block + 1):
                x = self._run(getattr(self, f"up_{i}_block_{j}"), x)
            if i < self.n_stages - 1:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
                x = getattr(self, f"up_{i}_upsample")(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class AutoencoderKL(nn.Module):
    """Encode images to diagonal-Gaussian latents and decode back (NCHW);
    ``remat`` is the decoder's."""

    def __init__(self, config: VAEConfig, device=None, dtype=None, remat: bool = False):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config, device, dtype)
        self.decoder = Decoder(config, device, dtype, remat)

    def encode_moments(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images [B, 3, H, W] in [-1, 1] -> (mean, logvar) each [B, C, H/8, W/8]."""
        dtype = self.encoder.conv_in.weight.dtype
        mean, logvar = self.encoder(images.to(dtype)).chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, images: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A posterior sample (the mean when ``generator`` is None)."""
        mean, logvar = self.encode_moments(images)
        if generator is None:
            return mean
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
        return mean + torch.exp(0.5 * logvar) * noise

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """latents [B, C, H/8, W/8] (unscaled) -> images [B, 3, H, W] in [-1, 1]."""
        return self.decoder(latents.to(self.decoder.conv_in.weight.dtype))
