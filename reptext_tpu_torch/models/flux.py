"""FLUX.1 MMDiT diffusion transformer (PyTorch).

Counterpart of ``reptext_tpu/models/flux.py``. The ``nn.scan`` layer stacks
become ``ModuleList``s of ``_DoubleLayer``/``_SingleLayer`` wrappers whose
``block`` attribute mirrors the Flax tree (``double_blocks/block/...``), so
``io/from_jax.py`` slices each stacked leaf along its layer axis.

ControlNet residuals are injected after each block, index-on-read: base layer
i adds ``stack[min(i // ceil(L / n), n - 1)]`` of every [n, B, S_img, D]
residual stack passed (one stack, or a tuple of differently deep stacks).
Double-block residuals go to the image stream, single-block residuals to the
image-token slice of the joint sequence.

The blocks' attention backend (None, or 'ring' / 'ulysses' for the
sequence-parallel blocks) is what the JAX module field
``clone(attention_backend=...)`` switches. Here the module holds no such
field: every forward reads the backend of the thread's SP context
(``parallel/sequence.py::active_backend``), so sharded and unsharded
pipelines share one set of module instances.

``remat=True`` runs each block under ``torch.utils.checkpoint`` (non-reentrant)
when autograd records, the counterpart of ``nn.remat`` on the JAX layer
stacks: a block keeps only its inputs, and its activations are recomputed
(attention forward included) when the backward reaches it.
:meth:`FluxTransformer2D.add_ip_adapter` gives every double block the
IP-Adapter's ``to_k_ip``/``to_v_ip``; ``ip_tokens`` and ``ip_scale`` then
reach them (JAX ``ip_adapter=True``, :200-248).

``weight_quant=True`` builds the block stacks with fp8 weight-only storage
(every Linear of ``double_blocks``/``single_blocks`` a ``QuantLinear``,
``io/quantize.py``; JAX ``weight_quant``, :180-187, 231-234, 265-268): a
layer dequantizes its own weight in its forward. :func:`quantized_copy`
makes such a module from a bf16 one without touching it, over the same
embedders, norms and heads; from a model whose stacks were stored in fp8
and then given dense layers (the IP-Adapter's, attached to an fp8-stored
checkpoint) it quantizes those and keeps the stored ones, as the JAX
``quantize_params`` is idempotent. ``quantized_by_call`` is the JAX
models' ``weight_quant`` flag: set on a model built with
``weight_quant=True`` and on what :func:`quantized_copy` returns, not on one
whose stacks only came from fp8 storage (``pipelines/txt2img.py::
build_module``); once it is set no dense layer may join the stacks.
"""

from __future__ import annotations

import copy
import math
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from reptext_tpu_torch.configs import FluxConfig
from reptext_tpu_torch.nn.blocks import JointTransformerBlock, SingleTransformerBlock
from reptext_tpu_torch.nn.embeddings import CombinedTimestepTextEmbed
from reptext_tpu_torch.nn.layers import AdaLayerNormContinuous, QuantLinear, quantize_linears_
from reptext_tpu_torch.ops.rope import rope_cos_sin_half
from reptext_tpu_torch.parallel.sequence import active_backend

Stacks = Union[None, torch.Tensor, Sequence[torch.Tensor]]


class _DoubleLayer(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.block = JointTransformerBlock(cfg.inner_dim, cfg.num_attention_heads,
                                           cfg.attention_head_dim, cfg.mlp_ratio,
                                           device=device, dtype=dtype)


class _SingleLayer(nn.Module):
    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        self.block = SingleTransformerBlock(cfg.inner_dim, cfg.num_attention_heads,
                                            cfg.attention_head_dim, cfg.mlp_ratio,
                                            device=device, dtype=dtype)


def run_block(block: nn.Module, remat: bool, *args):
    """``block(*args)``, under activation checkpointing when ``remat`` is set
    and autograd is recording."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block, *args, use_reentrant=False)
    return block(*args)


BLOCK_STACKS = ("double_blocks", "single_blocks")


def has_quant_blocks(model: nn.Module) -> bool:
    """Whether ``model``'s block stacks hold fp8 storage (``QuantLinear``s)."""
    return any(isinstance(m, QuantLinear) for name in BLOCK_STACKS
               for m in getattr(model, name).modules())


def _structural_copy(module: nn.Module) -> nn.Module:
    """New module objects all the way down over the same parameter and
    buffer tensors: a change of the copy's structure leaves ``module`` as it is."""
    new = copy.copy(module)
    new._parameters = dict(module._parameters)
    new._buffers = dict(module._buffers)
    new._modules = {k: None if v is None else _structural_copy(v)
                    for k, v in module._modules.items()}
    return new


@torch.no_grad()
def quantized_copy(model: nn.Module) -> nn.Module:
    """``model`` with fp8 weight-only block stacks, as a new module marked
    ``quantized_by_call``: every dense Linear of its ``double_blocks`` and
    ``single_blocks`` quantized (its bias shared), every ``QuantLinear``
    there kept as it is (fp8 storage from a checkpoint, codes and scales bit
    for bit); the embedders, norms and the heads outside the stacks are the
    same module objects. ``model`` itself, which other pipelines may share,
    is not changed, and once nothing holds it its bf16 block weights are
    freed. A model this function made is returned as it is."""
    if model.quantized_by_call:
        return model
    new = copy.copy(model)
    new._parameters = dict(model._parameters)
    new._buffers = dict(model._buffers)
    new._modules = dict(model._modules)
    for name in BLOCK_STACKS:
        new._modules[name] = quantize_linears_(_structural_copy(model._modules[name]))
    new.quantized_by_call = True
    return new


def as_stack_tuple(samples: Stacks) -> Optional[Tuple[torch.Tensor, ...]]:
    if samples is None:
        return None
    if isinstance(samples, (tuple, list)):
        return tuple(samples)
    return (samples,)


def inject_index(n: int, num_layers: int) -> List[int]:
    """Per-base-layer source index into an [n, ...] residual stack
    (diffusers' ceil-interval mapping)."""
    interval = int(math.ceil(num_layers / n))
    return [min(i // interval, n - 1) for i in range(num_layers)]


def read_inject(stacks: Tuple[torch.Tensor, ...], idx: Sequence[int]) -> torch.Tensor:
    """Sum this layer's residual from each stack (index-on-read)."""
    add = stacks[0][idx[0]]
    for stack, i in zip(stacks[1:], idx[1:]):
        add = add + stack[i]
    return add


class FluxTransformer2D(nn.Module):
    """The base FLUX diffusion transformer."""

    def __init__(self, config: FluxConfig, device=None, dtype=None, remat: bool = False,
                 weight_quant: bool = False):
        super().__init__()
        cfg = config
        kw = dict(device=device, dtype=dtype)
        self.config = cfg
        self.remat = remat
        self.x_embedder = nn.Linear(cfg.in_channels, cfg.inner_dim, **kw)
        self.time_text_embed = CombinedTimestepTextEmbed(
            cfg.inner_dim, cfg.pooled_projection_dim, cfg.time_embed_dim,
            cfg.guidance_embeds, **kw)
        self.context_embedder = nn.Linear(cfg.joint_attention_dim, cfg.inner_dim, **kw)
        self.double_blocks = nn.ModuleList(_DoubleLayer(cfg, **kw) for _ in range(cfg.num_layers))
        self.single_blocks = nn.ModuleList(
            _SingleLayer(cfg, **kw) for _ in range(cfg.num_single_layers))
        self.norm_out = AdaLayerNormContinuous(cfg.inner_dim, **kw)
        self.proj_out = nn.Linear(cfg.inner_dim, cfg.out_channels, **kw)
        if weight_quant:
            for name in BLOCK_STACKS:
                quantize_linears_(getattr(self, name))
        self.quantized_by_call = weight_quant

    @property
    def weight_quant(self) -> bool:
        return has_quant_blocks(self)

    @property
    def ip_adapter(self) -> bool:
        """Whether the double blocks carry the IP-Adapter's projections."""
        return hasattr(self.double_blocks[0].block, "to_k_ip")

    def add_ip_adapter(self, ip_dim: int) -> "FluxTransformer2D":
        """Graft uninitialised dense ``to_k_ip``/``to_v_ip`` onto every double
        block, also beside stacks stored in fp8; returns self. A model built
        with ``weight_quant=True`` or made by ``quantized_copy`` refuses: the
        adapter is attached first, then quantized with the stacks."""
        if self.quantized_by_call:
            raise ValueError("attach_ip_adapter() must run BEFORE quantize_weights(); attach "
                             "first, then quantize (the adapter kernels are then quantized "
                             "with the rest of the double-block stack)")
        for layer in self.double_blocks:
            layer.block.add_ip_adapter(ip_dim)
        return self

    def forward(self, hidden_states: torch.Tensor, encoder_hidden_states: torch.Tensor,
                pooled_projections: torch.Tensor, timestep: torch.Tensor,
                img_ids: torch.Tensor, txt_ids: torch.Tensor,
                guidance: Optional[torch.Tensor] = None,
                controlnet_block_samples: Stacks = None,
                controlnet_single_block_samples: Stacks = None,
                ip_tokens: Optional[torch.Tensor] = None,
                ip_scale=None) -> torch.Tensor:
        """``ip_tokens`` [B or 1, N_ip, ip_dim] and ``ip_scale`` (a scalar or
        [B]): the IP-Adapter's image prompt, for a model that has one."""
        cfg = self.config
        if ip_tokens is not None and not self.ip_adapter:
            raise ValueError("ip_tokens given to a FLUX transformer without the IP-Adapter")
        dtype = self.x_embedder.weight.dtype
        x = self.x_embedder(hidden_states.to(dtype))
        temb = self.time_text_embed(timestep, pooled_projections, guidance)
        ctx = self.context_embedder(encoder_hidden_states.to(dtype))
        cos, sin = rope_cos_sin_half(torch.cat([txt_ids, img_ids], dim=0),
                                     cfg.axes_dims_rope, cfg.rope_theta)
        backend = active_backend()

        double_stacks = as_stack_tuple(controlnet_block_samples)
        double_idx = None if double_stacks is None else [
            inject_index(s.shape[0], cfg.num_layers) for s in double_stacks]
        for i, layer in enumerate(self.double_blocks):
            ctx, x = run_block(layer.block, self.remat, x, ctx, temb, cos, sin,
                               backend, ip_tokens, ip_scale)
            if double_stacks is not None:
                x = x + read_inject(double_stacks, [ix[i] for ix in double_idx]).to(x.dtype)

        txt_len = ctx.shape[1]
        joint = torch.cat([ctx, x], dim=1)
        single_stacks = as_stack_tuple(controlnet_single_block_samples)
        single_idx = None if single_stacks is None else [
            inject_index(s.shape[0], cfg.num_single_layers) for s in single_stacks]
        for i, layer in enumerate(self.single_blocks):
            joint = run_block(layer.block, self.remat, joint, temb, cos, sin,
                              backend, txt_len)
            if single_stacks is not None:
                # in place on the block's fresh output tensor: no op saves that
                # tensor for backward (it comes from an add), and a recomputed
                # block makes a new one, so autograd and remat are unaffected
                joint[:, txt_len:] += read_inject(
                    single_stacks, [ix[i] for ix in single_idx]).to(joint.dtype)

        x = self.norm_out(joint[:, txt_len:], temb)
        return self.proj_out(x)
