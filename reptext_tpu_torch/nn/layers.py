"""Normalisation, modulation and MLP building blocks (PyTorch).

Counterpart of ``reptext_tpu/nn/layers.py``. Parameter names follow the Flax
tree (``linear``, ``in_proj``/``out_proj``, ``weight``) so that
``io/from_jax.py`` maps them mechanically. Norms and the AdaLN modulation run
in float32 and cast back to the activation dtype; projections run in the
parameters' dtype (bf16 on the card). :class:`QuantLinear` is the Linear of
fp8 weight-only storage (``io/quantize.py``), and :func:`quantize_linears_`
swaps a module tree's Linears for it.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.nn import functional as F

from reptext_tpu_torch.io.quantize import (
    QUANT_KEY, SCALE_KEY, quantize_kernel, random_q8, random_scale,
)


class RMSNorm(nn.Module):
    """RMS normalisation with a learned scale (per-head q/k norm)."""

    def __init__(self, dim: int, eps: float = 1e-6, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.pow(2).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.weight.float()).to(x.dtype)


def layer_norm_no_affine_f32(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without affine parameters; returns float32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).pow(2).mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps)


def layer_norm_no_affine(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return layer_norm_no_affine_f32(x, eps).to(x.dtype)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """LN(x) * (1 + scale) + shift, in float32, cast to x's dtype.

    shift/scale are [B, dim] and broadcast over the token axis.
    """
    normed = layer_norm_no_affine_f32(x)
    out = normed * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    return out.to(x.dtype)


class AdaLayerNormZero(nn.Module):
    """temb -> (modulated x, gate_msa, shift_mlp, scale_mlp, gate_mlp)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.linear = nn.Linear(dim, 6 * dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, temb: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        emb = self.linear(F.silu(temb))
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = emb.chunk(6, dim=-1)
        return modulate(x, shift_msa, scale_msa), gate_msa, shift_mlp, scale_mlp, gate_mlp


class AdaLayerNormZeroSingle(nn.Module):
    """temb -> (modulated x, gate)."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.linear = nn.Linear(dim, 3 * dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        shift, scale, gate = self.linear(F.silu(temb)).chunk(3, dim=-1)
        return modulate(x, shift, scale), gate


class AdaLayerNormContinuous(nn.Module):
    """Output norm: temb -> (scale, shift); x -> LN(x) * (1 + scale) + shift."""

    def __init__(self, dim: int, device=None, dtype=None):
        super().__init__()
        self.linear = nn.Linear(dim, 2 * dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        scale, shift = self.linear(F.silu(temb)).chunk(2, dim=-1)
        return modulate(x, shift, scale)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class FeedForward(nn.Module):
    """dim -> mult * dim -> dim with gelu-tanh (FLUX feedforward)."""

    def __init__(self, dim: int, mult: float = 4.0, device=None, dtype=None):
        super().__init__()
        inner = int(dim * mult)
        self.in_proj = nn.Linear(dim, inner, device=device, dtype=dtype)
        self.out_proj = nn.Linear(inner, dim, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_proj(gelu_tanh(self.in_proj(x)))


# the storage dtypes of QuantLinear's two tensors, and same-size integer views
# that a module-wide cast leaves alone
_RAW_VIEWS = {QUANT_KEY: (torch.float8_e4m3fn, torch.uint8),
              SCALE_KEY: (torch.bfloat16, torch.int16)}


class QuantLinear(nn.Module):
    """A Linear whose weight is stored as e4m3 codes (``kernel_q8`` [out, in])
    and per-output-channel bf16 scales (``kernel_scale`` [out, 1]), both
    frozen, plus a bias in the module's dtype. The forward dequantizes the
    layer's own weight into the input's dtype, ``q.to(dtype) * scale``, and
    runs ``F.linear``, as the JAX models' dequantization of one scanned layer
    does (``nn.map_variables`` on the layer; XLA does that work there, plain
    PyTorch here). In bf16 that is ``io.quantize.dequantize_kernel``, rounded
    to bf16; in float32 the product is exact, which is what the jitted JAX
    models compute on the CPU (XLA keeps the bf16 product in float32 there:
    ``tests/test_torch_quantize.py`` holds the two equal). A module-wide cast
    (``.to(dtype)``, ``.float()``) moves the codes and scales and casts the
    bias only."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.kernel_q8 = nn.Parameter(torch.empty((out_features, in_features), device=device,
                                                  dtype=torch.float8_e4m3fn),
                                      requires_grad=False)
        self.kernel_scale = nn.Parameter(torch.empty((out_features, 1), device=device,
                                                     dtype=torch.bfloat16), requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(out_features, device=device, dtype=dtype))
                     if bias else None)

    @classmethod
    def from_linear(cls, linear: nn.Linear) -> "QuantLinear":
        """``linear``'s weight quantized (``io.quantize.quantize_kernel``), its
        bias shared; an empty layer when ``linear`` is on the meta device."""
        w = linear.weight
        out = cls(w.shape[1], w.shape[0], linear.bias is not None, device="meta", dtype=w.dtype)
        if w.is_meta:
            return out
        q, scale = quantize_kernel(w.detach())
        out.kernel_q8 = nn.Parameter(q, requires_grad=False)
        out.kernel_scale = nn.Parameter(scale, requires_grad=False)
        out.bias = linear.bias
        return out

    @torch.no_grad()
    def random_init_(self, generator: torch.Generator, zero: bool = False) -> None:
        """Draw the storage directly: random codes and 1 / (448 sqrt(in))
        scales (``io.quantize.random_params_like``'s rule), zero bias; with
        ``zero``, the quantization of a zero weight (codes 0, scale 1e-12)."""
        dev = self.kernel_q8.device
        if zero:
            self.kernel_q8.copy_(torch.zeros(self.kernel_q8.shape, device=dev))
            self.kernel_scale.fill_(1e-12)
        else:
            self.kernel_q8.copy_(random_q8(self.kernel_q8.shape, generator, dev))
            self.kernel_scale.copy_(random_scale(self.kernel_scale.shape, self.in_features, dev))
        if self.bias is not None:
            self.bias.zero_()

    def dequantized(self, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        """The weight [out, in] in ``dtype``: ``q.to(dtype) * scale``, which in
        bf16 is ``io.quantize.dequantize_kernel``."""
        return self.kernel_q8.to(dtype) * self.kernel_scale.to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.dequantized(x.dtype), self.bias)

    def _apply(self, fn, recurse=True):
        stored = {k: self._parameters.pop(k) for k in _RAW_VIEWS}
        try:
            super()._apply(fn, recurse)
        finally:
            for k, p in stored.items():
                dtype, raw = _RAW_VIEWS[k]
                self._parameters[k] = nn.Parameter(fn(p.detach().view(raw)).view(dtype),
                                                   requires_grad=False)
        return self

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features={self.out_features}, "
                f"bias={self.bias is not None}, fp8 e4m3 weight")


def quantize_linears_(module: nn.Module) -> nn.Module:
    """Every ``nn.Linear`` under ``module`` replaced by
    :meth:`QuantLinear.from_linear` of it, in place; returns ``module``."""
    for name, child in list(module.named_children()):
        if isinstance(child, nn.Linear):
            setattr(module, name, QuantLinear.from_linear(child))
        else:
            quantize_linears_(child)
    return module
