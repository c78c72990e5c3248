"""The single blocks' tanh GELU written into ``proj_out``'s input buffer:
a hand-written CUDA kernel and its plain twin.

A single block on the copy-free route (``nn/blocks.py``) allocates one
[B, S, inner + mlp] buffer for ``proj_out``; the attention kernel writes its
output into the first ``inner`` columns and :func:`gelu_tanh_into` writes
``gelu_tanh(proj_mlp(x))`` into the rest. Eager ``F.gelu(x, approximate=
"tanh", out=...)`` would take the strided output off ATen's vectorised path;
the kernel (``csrc/gelu.cu``) reads x and writes the buffer's columns in
16-byte vectors along its row stride, with ATen's arithmetic: on bf16 its
output is ``F.gelu``'s bit for bit (the card tests check every finite bf16
input).

A CUDA tensor launches the kernel or the call raises (no fallback); a tensor
on any other device takes the plain version, ``F.gelu`` copied into the
columns, bit for bit what the block computed before. The route takes no
gradient, so neither does this entry: a call that autograd would record
raises. ``gelu_tanh_into.launches`` counts the kernel's launches
(``_build.count_launch``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reptext_tpu_torch.ops._build import count_launch

_DTYPES = (torch.bfloat16, torch.float32)


def gelu_tanh_plain(x: torch.Tensor) -> torch.Tensor:
    """``F.gelu(x, approximate="tanh")``: the FF's and, before the copy-free
    route, the single block's activation."""
    return F.gelu(x, approximate="tanh")


def _rows(name: str, t: torch.Tensor) -> int:
    """The row stride, in elements, of ``t`` taken as rows of its last dim:
    a unit last stride, leading dims that step by whole rows of one stride (a
    [B, S, n] view whose batch stride is S token strides), a 16-byte-aligned
    base and row stride."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        raise ValueError(f"{name} needs a unit last stride and a 16-byte-aligned base "
                         f"(strides {t.stride()})")
    rows = [(n, s) for n, s in zip(t.shape[:-1], t.stride()[:-1]) if n > 1]
    rs = rows[-1][1] if rows else t.shape[-1]
    want = rs
    for n, s in reversed(rows):
        if s != want:
            raise ValueError(f"{name}'s rows are not evenly strided (strides {t.stride()})")
        want *= n
    if (rs * t.element_size()) % 16:
        raise ValueError(f"{name}'s row stride is not a whole number of 16 bytes "
                         f"(strides {t.stride()})")
    return rs


def _launch(x: torch.Tensor, out: torch.Tensor) -> None:
    from reptext_tpu_torch.ops import _build

    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if out.dtype != x.dtype or out.device != x.device:
        raise ValueError(f"out is {out.dtype} on {out.device}, x {x.dtype} on {x.device}")
    n = 16 // x.element_size()
    if x.shape[-1] % n:
        raise ValueError(f"row length {x.shape[-1]} is not a whole number of 16-byte vectors")
    x_rs, o_rs = _rows("x", x), _rows("out", out)
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    if rows == 0:
        return
    err = _build.load().reptext_gelu_tanh(
        x.data_ptr(), out.data_ptr(), rows, x.shape[-1] // n, x_rs, o_rs,
        int(x.dtype == torch.float32), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gelu kernel launch failed: cudaError {err}")
    count_launch(gelu_tanh_into)


def gelu_tanh_into(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out[...] = gelu_tanh(x)``, ``out`` a view of x's shape (the MLP
    columns of ``proj_out``'s input buffer); returns ``out``. The kernel on a
    CUDA tensor, :func:`gelu_tanh_plain` copied in elsewhere."""
    if tuple(out.shape) != tuple(x.shape):
        raise ValueError(f"out has shape {tuple(out.shape)}, x {tuple(x.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or out.requires_grad):
        raise ValueError("gelu_tanh_into takes no gradient: call it where autograd records "
                         "nothing")
    if x.device.type != "cuda":
        return out.copy_(gelu_tanh_plain(x))
    _launch(x, out)
    return out


gelu_tanh_into.launches = 0
