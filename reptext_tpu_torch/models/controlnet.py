"""RepText FLUX ControlNet (PyTorch).

Counterpart of ``reptext_tpu/models/controlnet.py::RepTextControlNet``: packed
latents plus a packed conditioning tensor (canny + position latents) through
a zero-initialised ``controlnet_x_embedder``, trimmed double/single stacks,
and one zero-initialised ``proj`` head per block whose output is the
residual for the base model, multiplied by ``conditioning_scale``.
``remat`` checkpoints each block and the thread's SP context switches the
blocks to sequence parallelism, as in ``models/flux.py``;
:func:`params_from_transformer` is the warm-start weight surgery. Union mode
is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from reptext_tpu_torch.configs import ControlNetConfig
from reptext_tpu_torch.models.flux import FluxTransformer2D, run_block
from reptext_tpu_torch.nn.blocks import JointTransformerBlock, SingleTransformerBlock
from reptext_tpu_torch.nn.embeddings import CombinedTimestepTextEmbed
from reptext_tpu_torch.ops.rope import rope_cos_sin_half
from reptext_tpu_torch.parallel.sequence import active_backend


class _ControlDoubleLayer(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.block = JointTransformerBlock(cfg.inner_dim, cfg.num_attention_heads,
                                           cfg.attention_head_dim, cfg.mlp_ratio,
                                           device=device, dtype=dtype)
        self.proj = nn.Linear(cfg.inner_dim, cfg.inner_dim, device=device, dtype=dtype)


class _ControlSingleLayer(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.block = SingleTransformerBlock(cfg.inner_dim, cfg.num_attention_heads,
                                            cfg.attention_head_dim, cfg.mlp_ratio,
                                            device=device, dtype=dtype)
        self.proj = nn.Linear(cfg.inner_dim, cfg.inner_dim, device=device, dtype=dtype)


class RepTextControlNet(nn.Module):
    """FLUX-architecture ControlNet emitting per-block injection residuals."""

    # parameters that start at zero (the fresh ControlNet is a no-op)
    zero_init = ("controlnet_x_embedder.weight", ".proj.weight")

    def __init__(self, config: ControlNetConfig, device=None, dtype=None, remat: bool = False):
        super().__init__()
        if config.union:
            raise NotImplementedError("union-mode ControlNet is not ported yet")
        cfg = config
        kw = dict(device=device, dtype=dtype)
        self.config = cfg
        self.remat = remat
        self.x_embedder = nn.Linear(cfg.in_channels, cfg.inner_dim, **kw)
        self.controlnet_x_embedder = nn.Linear(
            cfg.in_channels + cfg.extra_condition_channels, cfg.inner_dim, **kw)
        self.time_text_embed = CombinedTimestepTextEmbed(
            cfg.inner_dim, cfg.pooled_projection_dim, cfg.time_embed_dim,
            cfg.guidance_embeds, **kw)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim, cfg.inner_dim, **kw)
        self.double_blocks = nn.ModuleList(
            _ControlDoubleLayer(cfg, **kw) for _ in range(cfg.num_layers))
        self.single_blocks = nn.ModuleList(
            _ControlSingleLayer(cfg, **kw) for _ in range(cfg.num_single_layers))

    def forward(self, hidden_states: torch.Tensor, controlnet_cond: torch.Tensor,
                encoder_hidden_states: torch.Tensor, pooled_projections: torch.Tensor,
                timestep: torch.Tensor, img_ids: torch.Tensor, txt_ids: torch.Tensor,
                guidance: Optional[torch.Tensor] = None,
                conditioning_scale: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (block_samples [L, B, S_img, D], single_block_samples [L1, B, S_img, D])."""
        cfg = self.config
        dtype = self.x_embedder.weight.dtype
        x = self.x_embedder(hidden_states.to(dtype))
        x = x + self.controlnet_x_embedder(controlnet_cond.to(dtype))
        temb = self.time_text_embed(timestep, pooled_projections, guidance)
        ctx = self.context_embedder(encoder_hidden_states.to(dtype))
        cos, sin = rope_cos_sin_half(torch.cat([txt_ids, img_ids], dim=0),
                                     cfg.axes_dims_rope, cfg.rope_theta)
        backend = active_backend()

        block_samples = []
        for layer in self.double_blocks:
            ctx, x = run_block(layer.block, self.remat, x, ctx, temb, cos, sin,
                               backend)
            block_samples.append(layer.proj(x))

        txt_len = ctx.shape[1]
        joint = torch.cat([ctx, x], dim=1)
        single_samples = []
        for layer in self.single_blocks:
            joint = run_block(layer.block, self.remat, joint, temb, cos, sin,
                              backend, txt_len)
            single_samples.append(layer.proj(joint[:, txt_len:]))

        scale = torch.tensor(conditioning_scale, dtype=dtype, device=x.device)
        return torch.stack(block_samples) * scale, torch.stack(single_samples) * scale


@torch.no_grad()
def params_from_transformer(flux: FluxTransformer2D, controlnet: RepTextControlNet,
                            num_layers: int, num_single_layers: int) -> RepTextControlNet:
    """Warm-start ``controlnet`` from the base transformer, in place.

    Counterpart of the JAX ``params_from_transformer`` (reference
    ``FluxControlNetModel.from_transformer``): copies ``x_embedder``,
    ``context_embedder``, ``time_text_embed`` and the first ``num_layers``
    double / ``num_single_layers`` single blocks from ``flux``; the zero
    ``proj`` heads and ``controlnet_x_embedder`` stay as they are, so the
    ControlNet stays a no-op until trained. Raises when the depth exceeds the
    base's or differs from the ControlNet's own.
    """
    base = (len(flux.double_blocks), len(flux.single_blocks))
    if num_layers > base[0] or num_single_layers > base[1]:
        raise ValueError(f"ControlNet depth ({num_layers} double, {num_single_layers} single) "
                         f"exceeds base transformer depth {base}")
    own = (len(controlnet.double_blocks), len(controlnet.single_blocks))
    if (num_layers, num_single_layers) != own:
        raise ValueError(f"depth ({num_layers}, {num_single_layers}) differs from the "
                         f"ControlNet's {own}")
    pairs = [(getattr(controlnet, n), getattr(flux, n))
             for n in ("x_embedder", "context_embedder", "time_text_embed")]
    pairs += [(controlnet.double_blocks[i].block, flux.double_blocks[i].block)
              for i in range(num_layers)]
    pairs += [(controlnet.single_blocks[i].block, flux.single_blocks[i].block)
              for i in range(num_single_layers)]
    for dst, src in pairs:
        for (name, p), (src_name, q) in zip(dst.named_parameters(), src.named_parameters()):
            if name != src_name or p.shape != q.shape:
                raise ValueError(f"cannot copy {src_name} {tuple(q.shape)} into "
                                 f"{name} {tuple(p.shape)}")
            p.copy_(q)
    return controlnet
