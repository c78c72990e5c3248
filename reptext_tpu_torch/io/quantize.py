"""Weight-only fp8 storage of the transformer blocks (PyTorch).

Counterpart of ``reptext_tpu/io/quantize.py``. The block stacks of FLUX and
the ControlNets (``double_blocks``/``single_blocks``: more than 99 % of their
bytes) keep every Linear kernel as float8_e4m3fn codes with one bf16 scale
per output channel, half the bytes of bf16; each layer dequantizes its own
weight to bf16 in its forward (``nn/layers.py::QuantLinear``), so at most
one layer's bf16 weight exists at a time and the products, activations,
norms and biases stay as they were. Embedders, heads outside the stacks and
the VAE and text encoders stay bf16.

Format (the JAX package's, so the two stores agree bit for bit): an
eligible ``kernel`` leaf of a Flax-named tree becomes two sibling leaves,

    kernel_q8     [..., in, out]  float8_e4m3fn
    kernel_scale  [..., 1,  out]  bfloat16

and a module's ``QuantLinear`` holds the same two as parameters in torch
layout: ``kernel_q8`` [out, in], ``kernel_scale`` [out, 1]. The rounding is
the JAX function's: the scale is amax / 448 in fp32, at least 1e-12, rounded
to bf16; the codes are w / scale in fp32, cast to e4m3; dequantization is
``q.to(bf16) * scale`` with a bf16 result. That product is not exact in bf16
in general (a 4-bit e4m3 significand times an 8-bit bf16 scale needs up to
12 bits), so it rounds; the port rounds as the JAX function does. The jitted
JAX models on the CPU keep the product in float32 (XLA's excess precision),
so a ``QuantLinear`` dequantizes into its input's dtype: rounded in bf16,
exact in float32.

Leaves may be numpy arrays or torch tensors; quantized leaves come back as
torch tensors (numpy has no e4m3 type without ``ml_dtypes``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

E4M3_MAX = 448.0
QUANT_KEY = "kernel_q8"
SCALE_KEY = "kernel_scale"
# the params subtrees holding the block stacks; everything else stays bf16
DEFAULT_SUBTREES = ("double_blocks", "single_blocks")


def _as_tensor(w) -> torch.Tensor:
    if isinstance(w, torch.Tensor):
        return w
    return torch.from_numpy(np.ascontiguousarray(w, dtype=np.float32))


def quantize_kernel(w, in_axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric e4m3 quantization of one kernel: (codes,
    bf16 scale). ``in_axis`` is the input axis: -1 for a torch Linear weight
    [out, in] (scale [out, 1]), -2 for a Flax kernel [..., in, out] (scale
    [..., 1, out]); leading stacked-layer axes pass through."""
    wf = _as_tensor(w).float()
    amax = wf.abs().amax(dim=in_axis, keepdim=True)
    scale = torch.clamp(amax / E4M3_MAX, min=1e-12).to(torch.bfloat16)
    q = (wf / scale.float()).to(torch.float8_e4m3fn)
    return q, scale


def dequantize_kernel(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q.to(bf16) * scale``, a bf16 kernel in ``q``'s layout."""
    return q.to(torch.bfloat16) * scale.to(torch.bfloat16)


def _is_eligible(key: str, leaf: Any) -> bool:
    dtype = getattr(leaf, "dtype", None)
    floating = (dtype.is_floating_point if isinstance(dtype, torch.dtype)
                else dtype is not None and np.issubdtype(np.dtype(dtype), np.floating))
    return key == "kernel" and len(getattr(leaf, "shape", ())) >= 2 and floating


def _quantize_dict(d: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        if isinstance(v, Mapping):
            out[k] = _quantize_dict(v)
        elif _is_eligible(k, v):
            out[QUANT_KEY], out[SCALE_KEY] = quantize_kernel(v, in_axis=-2)
        else:
            out[k] = v
    return out


def quantize_params(params: Mapping[str, Any],
                    subtrees: Optional[Iterable[str]] = DEFAULT_SUBTREES) -> Dict[str, Any]:
    """The Flax-named tree ``params`` (optionally under ``{"params": ...}``)
    with every ``kernel`` inside the named ``subtrees`` (None: everywhere)
    stored as ``kernel_q8``/``kernel_scale``; other leaves are kept as they
    are. Idempotent: a stored pair is left alone."""
    if set(params) == {"params"}:
        return {"params": quantize_params(params["params"], subtrees)}
    names = None if subtrees is None else tuple(subtrees)
    return {k: _quantize_dict(v) if isinstance(v, Mapping) and (names is None or k in names)
            else v for k, v in params.items()}


def quantize_state(state: Mapping[str, torch.Tensor],
                   subtrees: Iterable[str] = DEFAULT_SUBTREES) -> Dict[str, torch.Tensor]:
    """A module's flat state dict with every Linear weight (``....weight`` of
    two dimensions) under the named block stacks stored as ``kernel_q8`` /
    ``kernel_scale`` in torch layout: the state of the same module built with
    ``weight_quant``. The same bits as :func:`quantize_params` of the Flax
    tree (the amax is over the same elements). Idempotent."""
    prefixes = tuple(f"{name}." for name in subtrees)
    out: Dict[str, torch.Tensor] = {}
    for k, v in state.items():
        if k.startswith(prefixes) and k.endswith(".weight") and v.ndim == 2:
            base = k[: -len("weight")]
            out[base + QUANT_KEY], out[base + SCALE_KEY] = quantize_kernel(v)
        else:
            out[k] = v
    return out


def dequantize_collection(col: Any) -> Any:
    """``kernel`` restored (bf16) from every ``kernel_q8``/``kernel_scale``
    pair of a Flax-named tree; a tree without pairs comes back equal."""
    if not isinstance(col, Mapping):
        return col
    out: Dict[str, Any] = {}
    for k, v in col.items():
        if k == QUANT_KEY:
            out["kernel"] = dequantize_kernel(v, col[SCALE_KEY])
        elif k == SCALE_KEY:
            continue
        else:
            out[k] = dequantize_collection(v)
    return out


def random_q8(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Random e4m3 codes: random bytes viewed as e4m3, the two NaN patterns
    S.1111.111 turned finite by flipping their third exponent bit."""
    bits = torch.randint(0, 256, tuple(shape), generator=generator, device=device,
                         dtype=torch.int16).to(torch.uint8)
    nan = (bits & 0x7F) == 0x7F
    return torch.where(nan, bits ^ 0x20, bits).view(torch.float8_e4m3fn)


def random_scale(shape, fan_in: int, device) -> torch.Tensor:
    """The random codes' scale, 1 / (448 sqrt(fan_in)): the dequantized
    weights are bounded by 1 / sqrt(fan_in), so full-width forwards stay
    finite."""
    return torch.full(tuple(shape), 1.0 / (E4M3_MAX * math.sqrt(fan_in)),
                      dtype=torch.bfloat16, device=device)


def random_params_like(shape_tree: Mapping[str, Any], generator: torch.Generator,
                       device=None, dtype: torch.dtype = torch.bfloat16,
                       subtrees: Optional[Iterable[str]] = DEFAULT_SUBTREES) -> Dict[str, Any]:
    """Random parameters in storage format, from shapes only, drawn on
    ``device`` from ``generator``.

    ``shape_tree`` is a Flax-named tree whose leaves have ``.shape`` (numpy
    or meta tensors, ``jax.eval_shape`` structs). Eligible kernels inside
    ``subtrees`` come out as :func:`random_q8` codes and :func:`random_scale`
    scales, so no bf16 copy of them ever exists; the rest follows the Flax
    initialisers structurally in ``dtype``: zero biases, unit norm scales
    and lecun-normal kernels (std 1 / sqrt(fan_in)).
    """
    device = torch.device(device) if device is not None else generator.device
    names = None if subtrees is None else tuple(subtrees)

    def plain(key: str, shape) -> torch.Tensor:
        if key.endswith("bias"):
            return torch.zeros(shape, dtype=dtype, device=device)
        if key in ("weight", "scale") and len(shape) <= 2:
            return torch.ones(shape, dtype=dtype, device=device)
        if len(shape) >= 2:
            x = torch.randn(shape, generator=generator, device=device)
            return (x / math.sqrt(shape[-2])).to(dtype)
        return torch.zeros(shape, dtype=dtype, device=device)

    def walk(d: Mapping[str, Any], quantize: bool) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in d.items():
            if isinstance(v, Mapping):
                out[k] = walk(v, quantize)
                continue
            shape = tuple(int(s) for s in v.shape)
            if quantize and k == "kernel" and len(shape) >= 2:
                out[QUANT_KEY] = random_q8(shape, generator, device)
                out[SCALE_KEY] = random_scale(shape[:-2] + (1, shape[-1]), shape[-2], device)
            else:
                out[k] = plain(k, shape)
        return out

    if set(shape_tree) == {"params"}:
        return {"params": random_params_like(shape_tree["params"], generator, device, dtype,
                                             subtrees)}
    return {k: walk(v, names is None or k in names) if isinstance(v, Mapping)
            else plain(k, tuple(v.shape)) for k, v in shape_tree.items()}


def _leaves(tree) -> Iterable[Any]:
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def quantized_bytes(params) -> Tuple[int, int]:
    """(bytes as stored, bytes if every leaf were bf16) of a tree, a state
    dict or a module."""
    stored = bf16 = 0
    for leaf in _leaves(params):
        n = int(np.prod(leaf.shape))
        itemsize = (leaf.element_size() if isinstance(leaf, torch.Tensor)
                    else np.dtype(leaf.dtype).itemsize)
        stored += n * itemsize
        bf16 += n * 2
    return stored, bf16


def is_quantized(tree) -> bool:
    """Whether a Flax-named tree, a flat state dict (``...kernel_q8`` keys,
    the converted fp8 checkpoint files) or a module holds fp8 storage."""
    if isinstance(tree, torch.nn.Module):
        return any(name.endswith(QUANT_KEY) for name, _ in tree.named_parameters())
    if not isinstance(tree, Mapping):
        return False
    if any(k == QUANT_KEY or str(k).endswith("." + QUANT_KEY) for k in tree):
        return True
    return any(is_quantized(v) for v in tree.values() if isinstance(v, Mapping))
