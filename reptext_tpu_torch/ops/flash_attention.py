"""Joint flash attention, forward and backward: hand-written Hopper kernels and plain twins.

Counterpart of ``reptext_tpu/ops/flash_attention.py``. The CUDA kernel in
``csrc/flash_attention.cu`` replaces the Pallas kernels ``_attn_kernel_rope``
(K1, RoPE fused), ``_attn_kernel`` (K2) and ``_streaming_kernel`` (K3) with
one template (TMA loads, ``wgmma`` products, exp2 on logits in log2 units;
outputs and lse in the Pallas kernels' natural units). Its semantics are the
Pallas kernels' (see the source note):
half-split RoPE with bf16-rounded tables (K1), 1/sqrt(D) folded into q before
the bf16 rounding (K1, K2) or multiplied onto the fp32 logits (K3), fp32
logits clipped to +/-43 with no running max (``REPTEXT_SOFTMAX=online``
selects the running-max form), probabilities rounded to the value dtype for
PV, fp32 accumulation, and division after PV. Every entry returns
``(out, lse)``.

The entries route as ``_flash_attention_impl`` and
``_flash_attention_rope_impl`` do. Without tables: K3 when S exceeds
``_SINGLE_PASS_MAX_SEQ``, else K2. With tables: K1, unless S exceeds it or
``_pick_chunks`` would find a single chunk; then q and k are rotated with the
fp32 tables in plain PyTorch (XLA's part in the JAX package) and take the
route without tables. Only the decision is ported, not the TPU tiling.

The entries are ``torch.autograd.Function``s, the counterparts of the two
``jax.custom_vjp``s. Their backward is K4 (``_dq_kernel``/``_dkv_kernel``,
``csrc/flash_attention_bwd.cu``): it recomputes p from the saved lse of
whichever forward ran, as ``_flash_backward_pallas`` does; the RoPE entry
rotates q and k with the fp32 tables first and un-rotates dq and dk after, as
``_rope_bwd`` does. One call is three launches: a preprocess pass (delta =
sum(dO * O) and lse * log2(e), :func:`backward_preprocess`), one TMA +
``wgmma`` kernel in which a CTA owns 128 keys, streams the queries and makes
all five products from one set of logits (exp2 on log2 units, as the
forward), adding its partial dq into an fp32 buffer, and an epilogue that
scales and rounds dq. The adds of one query tile land in key order behind a
counter per tile, so dq, like dk and dv, repeats bit for bit from run to run,
as the JAX package's backward does.

A CUDA tensor goes to the kernels or the call raises. Only a CPU tensor takes
the plain PyTorch versions beside them, which compute the same things with
the same rounding points; ``chip_smoke.py`` holds the kernels against them on
the card. Each kernel entry counts its launches in ``<entry>.launches``
(``_build.count_launch``: thread-safe).
"""

from __future__ import annotations

import functools
import math
import os
from typing import Optional, Tuple

import torch

from reptext_tpu_torch.ops._build import count_launch
from reptext_tpu_torch.ops.rope import apply_rope_half

LOGIT_CLAMP = 43.0
LOG2E = 1.4426950408889634
_STAT_PAD = 64    # K4's per-query statistics are padded to its 64-query tile
_SUPPORTED_HEAD_DIMS = (128,)   # FLUX's; the kernel is instantiated for these only
# Above this joint length the JAX package takes its streaming kernel (K3).
_SINGLE_PASS_MAX_SEQ = 6144


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _single_chunk(s: int) -> bool:
    """Whether ``_flash_attention_rope_impl`` finds one chunk at length ``s``
    (its default block_q of 512, 256 past 4608 keys, and ``_pick_chunks``'
    3/4/2 candidates): it then rotates outside the kernel."""
    s_pad = _round_up(s, 128)
    block_q = min(256 if s_pad > 4608 else 512, s_pad)
    s_pad = _round_up(s_pad, block_q)
    return not any(s_pad % (c * 128) == 0 and s_pad // c >= 384 for c in (3, 4, 2))


def streams(s: int) -> bool:
    """Whether attention over ``s`` joint tokens takes K3."""
    return s > _SINGLE_PASS_MAX_SEQ


def rope_fused(s: int) -> bool:
    """Whether RoPE attention over ``s`` joint tokens takes K1."""
    return not (streams(s) or _single_chunk(s))


@functools.lru_cache(maxsize=None)
def softmax_mode() -> str:
    """``REPTEXT_SOFTMAX`` (clamped|online), read once per process."""
    mode = os.environ.get("REPTEXT_SOFTMAX", "clamped")
    if mode not in ("clamped", "online"):
        raise ValueError(f"REPTEXT_SOFTMAX must be clamped|online, got {mode}")
    return mode


def _online(online: Optional[bool]) -> bool:
    return softmax_mode() == "online" if online is None else online


# ------------------------------------------------------------ plain versions


def _logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.matmul(q.float(), k.float().transpose(-1, -2))


def _softmax_pv(logits: torch.Tensor, v: torch.Tensor, online: bool,
                out_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 logits over all keys -> (out, lse): clip or row max, exp,
    bf16(p) v, divide after PV; the Pallas chunk loops' result."""
    if online:
        m = logits.amax(dim=-1, keepdim=True)
        e = torch.exp(logits - m)
    else:
        m = torch.zeros((), dtype=torch.float32, device=logits.device)
        e = torch.exp(logits.clamp(-LOGIT_CLAMP, LOGIT_CLAMP))
    denom = e.sum(dim=-1, keepdim=True)
    acc = torch.matmul(e.to(v.dtype).float(), v.float())
    out = (acc / denom).to(out_dtype)
    lse = (m + torch.log(denom)).squeeze(-1)
    return out, lse


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          online: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 in plain PyTorch: [B, H, S, D] x3 -> (out [B, H, S, D], lse [B, H, S])."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs = (q.float() * scale).to(q.dtype)
    return _softmax_pv(_logits(qs, k), v, _online(online), q.dtype)


def flash_attention_streaming_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    online: Optional[bool] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 in plain PyTorch, the twin of ``_streaming_flash``: q and k already
    rotated (nothing folded into q); fp32 logits times 1/sqrt(D)."""
    return _softmax_pv(_logits(q, k) * (1.0 / math.sqrt(q.shape[-1])), v, _online(online),
                       q.dtype)


def flash_attention_rope_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                               online: Optional[bool] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 in plain PyTorch: q/k unrotated in half-split order, [S, D] tables."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    cos_b = rope_cos.to(torch.bfloat16).float()
    sin_b = rope_sin.to(torch.bfloat16).float()
    qs = (apply_rope_half(q.float(), cos_b, sin_b) * scale).to(q.dtype)
    ks = apply_rope_half(k, cos_b, sin_b)
    return _softmax_pv(_logits(qs, ks), v, _online(online), q.dtype)


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                                   online: Optional[bool] = None
                                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 in plain PyTorch: (dq, dk, dv) from q, k (rotated), v, the forward's
    out and lse, and dO, all [B, H, S, D] (lse [B, H, S]).

    Recomputes p = exp(clip(q k^T / sqrt(D)) - lse) (no clip online; beyond
    the clip the gradient passes straight through, as in the Pallas kernels),
    delta = sum_d dO O in fp32, and rounds p and ds to the value dtype before
    their products, as the kernel does. Holds several fp32 [B, H, S, S] tensors.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if not _online(online):
        logits = logits.clamp(-LOGIT_CLAMP, LOGIT_CLAMP)
    p = torch.exp(logits - lse[..., None])
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), dof)
    ds = (p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)).to(q.dtype).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_einsum(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                    do: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fp32 oracle: the exact softmax-attention backward (no clip), the
    twin of ``_flash_backward_einsum``."""
    qf, kf, vf, gf = (x.float() for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale, dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------ kernel wrappers


def _kernel_strides(x: torch.Tensor) -> bool:
    """The layout the kernels take, which is what a TMA tensor map takes: a
    contiguous head dim, every other stride a positive multiple of 8 elements
    (16 bytes; a dimension of one element has no stride to speak of) and a
    16-byte-aligned base."""
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(n == 1 or (s > 0 and s % 8 == 0)
                    for n, s in zip(x.shape[:-1], x.stride()[:-1])))


def _check(name: str, x: torch.Tensor, shape) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype == torch.float16:
        raise TypeError(
            f"{name}: float16 is rejected (exp(+/-{LOGIT_CLAMP}) overflows it "
            "in the max-free softmax); use bfloat16")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be bfloat16, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not _kernel_strides(x):
        raise ValueError(
            f"{name} needs a contiguous head dim, positive 8-element-aligned strides and a "
            f"16-byte-aligned base (strides {x.stride()})")


def _launch(q, k, v, rope_cos, rope_sin, online: bool, streaming: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 (tables given), K2, or K3 (``streaming``) on CUDA tensors."""
    from reptext_tpu_torch.ops import _build

    b, h, s, d = q.shape
    if d not in _SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel {_SUPPORTED_HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(name, x, (b, h, s, d))
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    rope = rope_cos is not None
    if rope and streaming:
        raise ValueError("the streaming kernel takes q and k already rotated")
    if rope:
        for name, t in (("rope_cos", rope_cos), ("rope_sin", rope_sin)):
            if (t.device != q.device or t.dtype != torch.float32
                    or tuple(t.shape) != (s, d) or not t.is_contiguous() or t.data_ptr() % 16):
                raise ValueError(f"{name} must be a contiguous, 16-byte-aligned float32 "
                                 f"[{s}, {d}] tensor on {q.device}")
    lib = _build.load()
    # the kernel rotates k once per call into this scratch (see the source note)
    k_rot = torch.empty((b, h, s, d), dtype=k.dtype, device=k.device) if rope else None
    # out is laid out [B, S, H, D] and returned as a [B, H, S, D] view, so the
    # caller's head merge is a free reshape.
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    if streaming:
        err = lib.reptext_flash_attention_streaming_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h, s, d,
            *strides, 1.0 / math.sqrt(d), int(online), stream)
    else:
        err = lib.reptext_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            rope_cos.data_ptr() if rope else None, rope_sin.data_ptr() if rope else None,
            k_rot.data_ptr() if rope else None, out.data_ptr(), lse.data_ptr(), b, h, s, d,
            *strides, 1.0 / math.sqrt(d), int(rope), int(online), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {err}")
    return out, lse


def backward_preprocess_plain(out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's preprocess pass in plain PyTorch: (delta, lse2), both fp32
    [B, H, S_pad] with S_pad = S rounded up to 64 and zeros past S. delta =
    sum_d dO * O in fp32 (``jnp.sum(g * out)`` in the JAX package), lse2 =
    lse * log2(e): the main kernel's exponential is exp2."""
    pad = (0, _round_up(lse.shape[-1], _STAT_PAD) - lse.shape[-1])
    delta = (do.float() * out.float()).sum(dim=-1)
    return (torch.nn.functional.pad(delta, pad),
            torch.nn.functional.pad(lse * LOG2E, pad))


def backward_preprocess(out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's preprocess pass, one hand-written kernel on CUDA tensors (out and
    dO read once, 16 bytes a thread); see :func:`backward_preprocess_plain`.
    Launches are counted by :func:`flash_attention_backward`, whose first pass
    this is."""
    if out.device.type == "cpu":
        return backward_preprocess_plain(out, lse, do)
    from reptext_tpu_torch.ops import _build

    b, h, s, d = out.shape
    if d not in _SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel {_SUPPORTED_HEAD_DIMS}")
    for name, x in (("out", out), ("do", do)):
        _check(name, x, (b, h, s, d))
        if x.device != out.device:
            raise ValueError(f"{name} is on {x.device}, out on {out.device}")
    if (lse.device != out.device or lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, s)
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 [{b}, {h}, {s}] tensor on {out.device}")
    lib = _build.load()
    s_pad = _round_up(s, _STAT_PAD)
    delta, lse2 = (torch.empty((b, h, s_pad), dtype=torch.float32, device=out.device)
                   for _ in range(2))
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.reptext_flash_attention_bwd_preprocess(
        out.data_ptr(), do.data_ptr(), lse.data_ptr(), lse2.data_ptr(), delta.data_ptr(),
        b, h, s, s_pad, d, *out.stride()[:3], *do.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward preprocess launch failed: cudaError {err}")
    return delta, lse2


def _launch_backward(q, k, v, out, lse, do, online: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    from reptext_tpu_torch.ops import _build

    b, h, s, d = q.shape
    if d not in _SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported by the kernel {_SUPPORTED_HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check(name, x, (b, h, s, d))
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if out.shape != q.shape or out.device != q.device:
        raise ValueError(f"out has shape {tuple(out.shape)} on {out.device}, q "
                         f"{tuple(q.shape)} on {q.device}")
    delta, lse2 = backward_preprocess(out, lse, do)
    lib = _build.load()
    # the key-tile CTAs add their partial dq into an fp32 buffer, in key order
    # behind one int32 counter per (b, h, 64-query tile, channel half); both
    # zeroed by one fill (see the source note)
    n_acc, n_flags = b * h * s * d, b * h * (_round_up(s, _STAT_PAD) // _STAT_PAD) * 2
    scratch = torch.zeros(n_acc + n_flags, dtype=torch.int32, device=q.device)
    dq_acc = scratch[:n_acc].view(torch.float32).view(b, h, s, d)
    dq_flags = scratch[n_acc:]
    dq, dk, dv = (torch.empty((b, h, s, d), dtype=q.dtype, device=q.device) for _ in range(3))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.reptext_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse2.data_ptr(),
        delta.data_ptr(), dq_acc.data_ptr(), dq_flags.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(),
        b, h, s, lse2.shape[-1], d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        1.0 / math.sqrt(d), int(online), stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward kernel launch failed: cudaError {err}")
    return dq, dk, dv


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                             online: Optional[bool] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: (dq, dk, dv) for q, k (rotated), v, out, lse and dO; see
    :func:`flash_attention_backward_plain` for what it computes. ``.launches``
    counts calls that reach the kernels (three launches each)."""
    if q.device.type == "cpu":
        return flash_attention_backward_plain(q, k, v, out, lse, do, online)
    # dO arrives strided (merge_heads' gradient, [B, S, H, D] memory), which
    # the kernels take; any other layout (an expanded sum() gradient) is copied
    do = do if _kernel_strides(do) else do.contiguous()
    result = _launch_backward(q, k, v, out, lse, do, _online(online))
    count_launch(flash_attention_backward)
    return result


def _forward(q, k, v, online: bool, streaming: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 (``streaming``) or K2 on q and k as given; the plain versions on the CPU."""
    if q.device.type == "cpu":
        plain = flash_attention_streaming_plain if streaming else flash_attention_plain
        return plain(q, k, v, online)
    out, lse = _launch(q, k, v, None, None, online, streaming)
    count_launch(flash_attention_streaming if streaming else flash_attention)
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """K2 or K3 (``streaming``) forward, K4 backward."""

    @staticmethod
    def forward(ctx, q, k, v, online: bool, streaming: bool):
        out, lse = _forward(q, k, v, online, streaming)
        ctx.online = online
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_backward(q, k, v, out, lse, g, ctx.online), None, None)


class _FlashAttentionRope(torch.autograd.Function):
    """K1 forward, or (past ``_SINGLE_PASS_MAX_SEQ`` or at one chunk) the fp32
    rotation then K3 or K2; backward as ``_rope_bwd``: rotate q and k with the
    fp32 tables, K4 with the lse of the forward that ran, then rotate dq and
    dk back by -theta (the rotation is orthogonal per channel pair). The
    tables get no (zero) gradient."""

    @staticmethod
    def forward(ctx, q, k, v, rope_cos, rope_sin, online: bool):
        s = q.shape[2]
        if not rope_fused(s):
            out, lse = _forward(apply_rope_half(q, rope_cos, rope_sin),
                                apply_rope_half(k, rope_cos, rope_sin), v, online, streams(s))
        elif q.device.type == "cpu":
            out, lse = flash_attention_rope_plain(q, k, v, rope_cos, rope_sin, online)
        else:
            out, lse = _launch(q, k, v, rope_cos, rope_sin, online)
            count_launch(flash_attention_rope)
        ctx.online = online
        ctx.save_for_backward(q, k, v, rope_cos, rope_sin, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, cos, sin, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            apply_rope_half(q, cos, sin), apply_rope_half(k, cos, sin), v, out, lse, g,
            ctx.online)
        return (apply_rope_half(dq, cos, -sin), apply_rope_half(dk, cos, -sin), dv,
                None, None, None)


def flash_attention_rope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         rope_cos: torch.Tensor, rope_sin: torch.Tensor,
                         online: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE attention, q/k unrotated (half-split): K1, or the rotation then K3
    or K2 (see the module note). Returns (out, lse); gradients flow to q, k
    and v through K4. ``.launches`` counts K1's launches."""
    return _FlashAttentionRope.apply(q, k, v, rope_cos, rope_sin, _online(online))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    online: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention without rotation: K3 past ``_SINGLE_PASS_MAX_SEQ``, else K2.
    Returns (out, lse); gradients through K4. ``.launches`` counts K2's."""
    return _FlashAttention.apply(q, k, v, _online(online), streams(q.shape[2]))


def flash_attention_streaming(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              online: Optional[bool] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 at any length, on q and k already rotated. Returns (out, lse);
    gradients through K4. ``.launches`` counts K3's launches."""
    return _FlashAttention.apply(q, k, v, _online(online), True)


flash_attention_rope.launches = 0
flash_attention.launches = 0
flash_attention_streaming.launches = 0
flash_attention_backward.launches = 0
