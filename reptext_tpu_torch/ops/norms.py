"""The blocks' fp32 row norms: hand-written CUDA kernels and plain twins.

The AdaLN LayerNorm with its modulation (:func:`modulate`: ``LN(x) * (1 +
scale) + shift``, eps 1e-6, cast to x's dtype) and the per-head q/k RMSNorm
(:func:`rms_norm`: ``x * rsqrt(mean(x^2) + eps) * w``) of every FLUX and
ControlNet block. The JAX package leaves both to XLA, which fuses them on the
TPU; no Pallas kernel stands behind them. Eager PyTorch runs each as a chain of
7 to 11 kernels with fp32 temporaries of the whole activation; the kernels in
``csrc/norms.cu`` read x once, do the fp32 arithmetic in registers and write
x's dtype once (see the source note: one template, two epilogues, the
variance two-pass from registers).

A CUDA tensor launches the kernel or the call raises (no fallback); a tensor
on any other device takes the plain version, the composition the port had
before the kernels (:func:`modulate_plain`, :func:`rms_norm_plain`), which the
CPU tests hold against the JAX package. The kernels take x in bf16 or fp32,
the parameters in x's dtype, and any row length up to FLUX's 3072 (the
widest row the port sends) that is a whole number of 16-byte vectors;
modulate's x may be a strided [B, S, D] view with
a unit last stride (``joint[:, txt_len:]``) and its shift and scale [B, D] or
[1, D] views with any batch stride (the ``chunk`` views of the AdaLN
projection); rms_norm's x is any dense tensor with a unit last stride (the
[B, H, S, D] view that ``split_heads`` makes of [B, S, H*D]) and its out has
x's strides. Gradients: on the card each entry is a ``torch.autograd.Function``
whose forward is the kernel and whose backward recomputes the plain version on
the saved inputs and differentiates it (the JAX package has no kernel here,
so no backward kernel is owed).

Each entry counts the kernel launches in ``<entry>.launches``
(``_build.count_launch``) and, under a request's span recorder, its calls in
the recorder's ``norm`` counter (``utils/profiling.py::count_norm_call``),
CPU calls included.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from reptext_tpu_torch.ops._build import count_launch
from reptext_tpu_torch.utils.profiling import count_norm_call

LN_EPS = 1e-6
_DTYPES = (torch.bfloat16, torch.float32)
# The widest row the port sends (FLUX's hidden width); a row's threads: at
# most 128 where 4 vectors a thread allow (see the source note).
_MAX_ROW = 3072
_TARGET_GROUP = 128
_MAX_VPT = 4


# ------------------------------------------------------------ plain versions


def layer_norm_no_affine_f32(x: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm without affine parameters; returns float32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).pow(2).mean(dim=-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps)


def modulate_plain(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """LN(x) * (1 + scale) + shift, in float32, cast to x's dtype; shift and
    scale [B, dim] broadcast over the token axis."""
    normed = layer_norm_no_affine_f32(x)
    out = normed * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    return out.to(x.dtype)


def rms_norm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * weight over the last axis, in float32,
    cast to x's dtype."""
    xf = x.float()
    var = xf.pow(2).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


# ------------------------------------------------------------ kernel wrappers


@functools.lru_cache(maxsize=None)
def plan(d: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """(vectors a row, vectors a thread, threads a row) for rows of ``d``
    elements of ``dtype`` (bf16 or fp32); raises for a row the kernels do not
    take."""
    n = 128 // torch.finfo(dtype).bits
    if d < 1 or d % n:
        raise ValueError(f"row length {d} is not a whole number of 16-byte vectors ({n} {dtype})")
    if d > _MAX_ROW:
        raise ValueError(f"row length {d} exceeds the norm kernels' {_MAX_ROW} elements")
    nv = d // n
    vpt = 1
    while vpt < _MAX_VPT and -(-nv // vpt) > _TARGET_GROUP:
        vpt *= 2
    group = -(-nv // vpt)
    group = 1 << (group - 1).bit_length() if group <= 32 else -(-group // 32) * 32
    return nv, vpt, group


def _check(name: str, t: torch.Tensor, x: torch.Tensor) -> None:
    """The dtype, device and layout the kernels read: x's dtype (bf16 or
    fp32) on x's device, a unit last stride, a 16-byte-aligned base and every
    other stride a whole number of 16 bytes (a dimension of one element has no
    stride to speak of)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if t.dtype != x.dtype:
        raise TypeError(f"{name} is {t.dtype}, x {x.dtype}: the kernels take one dtype")
    if t.device != x.device:
        raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    elem = t.element_size()
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(n > 1 and (s * elem) % 16 for n, s in zip(t.shape[:-1], t.stride()[:-1]))):
        raise ValueError(f"{name} needs a unit last stride, a 16-byte-aligned base and 16-byte "
                         f"strides (strides {t.stride()})")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    from reptext_tpu_torch.ops import _build

    if x.dim() != 3:
        raise ValueError(f"x must be [B, S, D], got shape {tuple(x.shape)}")
    b, s, d = x.shape
    for name, t in (("shift", shift), ("scale", scale)):
        if t.dim() != 2 or t.shape[0] not in (1, b) or t.shape[1] != d:
            raise ValueError(f"{name} must be [{b}, {d}] or [1, {d}], got {tuple(t.shape)}")
    for name, t in (("x", x), ("shift", shift), ("scale", scale)):
        _check(name, t, x)
    nv, vpt, group = plan(d, x.dtype)
    shift, scale = shift.expand(b, d), scale.expand(b, d)
    out = torch.empty((b, s, d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = _build.load().reptext_modulate(
        x.data_ptr(), shift.data_ptr(), scale.data_ptr(), out.data_ptr(), b * s, s,
        x.stride(0), x.stride(1), shift.stride(0), scale.stride(0), nv, group, vpt,
        int(x.dtype == torch.float32), LN_EPS, 1.0 / d, _stream(x))
    if err != 0:
        raise RuntimeError(f"modulate kernel launch failed: cudaError {err}")
    count_launch(modulate)
    return out


def _launch_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    from reptext_tpu_torch.ops import _build

    d = x.shape[-1]
    _check("x", x, x)
    _check("weight", weight, x)
    nv, vpt, group = plan(d, x.dtype)
    if tuple(weight.shape) != (d,):
        raise ValueError(f"weight must be [{d}], got {tuple(weight.shape)}")
    out = torch.empty_like(x)
    # empty_like keeps x's strides exactly when x is dense: then x and out
    # are the same flat rows of d elements
    if out.stride() != x.stride():
        raise ValueError(f"x must be dense with a unit last stride (strides {x.stride()})")
    if out.numel() == 0:
        return out
    err = _build.load().reptext_rms_norm(
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), x.numel() // d, nv, group, vpt,
        int(x.dtype == torch.float32), eps, 1.0 / d, _stream(x))
    if err != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: cudaError {err}")
    count_launch(rms_norm)
    return out


def _plain_grads(plain, ctx, g: torch.Tensor, inputs) -> tuple:
    """The gradients of ``plain(*inputs)`` against the inputs that want one,
    by recomputing it under autograd."""
    need = ctx.needs_input_grad[:len(inputs)]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, need)]
        out = plain(*leaves)
        grads = iter(torch.autograd.grad(out, [t for t, n in zip(leaves, need) if n], g))
    return tuple(next(grads) if n else None for n in need)


class _Modulate(torch.autograd.Function):
    """The kernel forward; the backward differentiates :func:`modulate_plain`."""

    @staticmethod
    def forward(ctx, x, shift, scale):
        ctx.save_for_backward(x, shift, scale)
        return _launch_modulate(x, shift, scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _plain_grads(modulate_plain, ctx, g, ctx.saved_tensors)


class _RMSNorm(torch.autograd.Function):
    """The kernel forward; the backward differentiates :func:`rms_norm_plain`."""

    @staticmethod
    def forward(ctx, x, weight, eps: float):
        ctx.eps = eps
        ctx.save_for_backward(x, weight)
        return _launch_rms_norm(x, weight, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        return (*_plain_grads(lambda a, w: rms_norm_plain(a, w, ctx.eps), ctx, g, (x, weight)),
                None)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """LN(x) * (1 + scale) + shift in float32, cast to x's dtype: the kernel
    on a CUDA tensor, :func:`modulate_plain` elsewhere. x [B, S, dim]; shift
    and scale [B, dim] broadcast over the token axis. ``.launches`` counts the
    kernel's launches."""
    count_norm_call("modulate")
    if x.device.type != "cuda":
        return modulate_plain(x, shift, scale)
    return _Modulate.apply(x, shift, scale)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * weight over the last axis in float32,
    cast to x's dtype: the kernel on a CUDA tensor (out with x's strides),
    :func:`rms_norm_plain` elsewhere. ``.launches`` counts the kernel's
    launches."""
    count_norm_call("rms_norm")
    if x.device.type != "cuda":
        return rms_norm_plain(x, weight, eps)
    return _RMSNorm.apply(x, weight, eps)


modulate.launches = 0
rms_norm.launches = 0
