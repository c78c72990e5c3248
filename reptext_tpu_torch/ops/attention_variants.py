"""The attention A/B variants: hand-written Hopper kernels and their plain twins.

Counterpart of the three Pallas kernels of the JAX package's attention study:
``benchmarks/exp_softmax_overlap.py::_chunked_kernel`` (online softmax over
``n_chunks`` unrolled key chunks) and ``::_bf16exp_kernel`` (exp at bf16), and
``benchmarks/sweep_attention.py::_exp2_kernel`` (exp2 with log2(e) folded into
the scale). All three are forward variants of one function: non-causal
attention over [B, H, S, D] bf16 q, k, v with 1/sqrt(D) applied to the fp32
logits, probabilities rounded to bf16 for PV, fp32 accumulation, division
after PV, and no lse. They differ only in the exponential and in where they
round.

On a CUDA tensor each entry launches its instantiation of the forward template
in ``csrc/flash_attention.cu`` (``reptext_attention_variant_fwd``; see the
source note) or raises; only a CPU tensor takes the plain version beside it,
which mirrors the Pallas body op for op. ``block_q`` and ``n_chunks`` are the
TPU's tiling: they do not change what the kernel computes (128-query CTAs
streaming 128-key tiles with a running max). Rows are independent, so
``block_q`` changes nothing in the plain versions either; ``n_chunks`` sets
where ``chunked_attn_plain`` rescales. Both are checked as the JAX grid needs
them (``s % block_q == 0``, ``s % n_chunks == 0``): the JAX grid leaves the
rows past a whole number of query blocks unwritten and drops the keys past a
whole number of chunks, which the port does not copy. Each entry counts its
kernel launches in ``<entry>.launches``.
"""

from __future__ import annotations

import math

import torch

LOG2E = 1.4426950408889634
HEAD_DIM = 128            # FLUX's; the kernel is instantiated for it only

# the exponential of each kernel instantiation (``exp_mode`` of the C entry)
_EXP, _EXP2, _EXP2_BF16 = 0, 1, 2


# ------------------------------------------------------------ plain versions


def _logits(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """fp32 q k^T times ``scale`` (an fp32 multiply), [B, H, S, S_k]."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def _pv(e: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """bf16(e) v with fp32 accumulation."""
    return torch.matmul(e.to(v.dtype).float(), v.float())


def chunked_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int = 256,
                       n_chunks: int = 4) -> torch.Tensor:
    """``_chunked_kernel`` in plain PyTorch: per key chunk, fp32 logits times
    1/sqrt(D), the chunk's max, alpha = exp(m - m_new) rescaling the fp32 sum
    and accumulator, e = exp(logits - m_new), acc += bf16(e) v."""
    _check_tiling(q, k, v, block_q, n_chunks)
    scale = 1.0 / math.sqrt(q.shape[-1])
    chunk = k.shape[2] // n_chunks
    m = acc = denom = None
    for ci in range(n_chunks):
        kc, vc = k[:, :, ci * chunk:(ci + 1) * chunk], v[:, :, ci * chunk:(ci + 1) * chunk]
        logits = _logits(q, kc, scale)
        m_c = logits.amax(dim=-1, keepdim=True)
        if m is None:
            m_new = m_c
            e = torch.exp(logits - m_new)
            denom = e.sum(dim=-1, keepdim=True)
            acc = _pv(e, vc)
        else:
            m_new = torch.maximum(m, m_c)
            alpha = torch.exp(m - m_new)
            e = torch.exp(logits - m_new)
            denom = denom * alpha + e.sum(dim=-1, keepdim=True)
            acc = acc * alpha + _pv(e, vc)
        m = m_new
    return (acc / denom).to(q.dtype)


def bf16exp_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       block_q: int = 256) -> torch.Tensor:
    """``_bf16exp_kernel`` in plain PyTorch: the full row max, e =
    bf16(exp(bf16(logits - m))) (exp evaluated in fp32 on the bf16 argument
    and rounded, as XLA computes a bf16 exp), fp32 row sums of e, e v."""
    _check_tiling(q, k, v, block_q)
    logits = _logits(q, k, 1.0 / math.sqrt(q.shape[-1]))
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp((logits - m).to(torch.bfloat16).float()).to(torch.bfloat16)
    denom = e.float().sum(dim=-1, keepdim=True)
    return (_pv(e, v) / denom).to(q.dtype)


def exp2_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_q: int = 256) -> torch.Tensor:
    """``_exp2_kernel`` in plain PyTorch: fp32 logits times 1/sqrt(D) *
    log2(e), the full row max, e = exp2(logits - m), fp32 row sums,
    bf16(e) v."""
    _check_tiling(q, k, v, block_q)
    logits = _logits(q, k, 1.0 / math.sqrt(q.shape[-1]) * LOG2E)
    e = torch.exp2(logits - logits.amax(dim=-1, keepdim=True))
    return (_pv(e, v) / e.sum(dim=-1, keepdim=True)).to(q.dtype)


# ------------------------------------------------------------ kernel wrappers


def _check_tiling(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int,
                  n_chunks: int = 1) -> None:
    """What the kernels and the JAX grid take: bf16, D = 128, contiguous
    [B, H, S, D] q, k, v of one shape on one device, S a whole number of
    query blocks (and of key chunks)."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {x.dtype}")
        if x.dim() != 4 or tuple(x.shape) != tuple(q.shape):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected [B, H, S, D] "
                             f"{tuple(q.shape)}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous (strides {x.stride()})")
    s, d = q.shape[2], q.shape[3]
    if d != HEAD_DIM:
        raise ValueError(f"head dim {d} not supported by the kernel (only {HEAD_DIM})")
    if block_q < 1 or s % block_q:
        raise ValueError(f"S = {s} is not a whole number of block_q = {block_q} query blocks")
    if n_chunks < 1 or s % n_chunks:
        raise ValueError(f"S = {s} is not a whole number of n_chunks = {n_chunks} key chunks")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, exp_mode: int) -> torch.Tensor:
    from reptext_tpu_torch.ops import _build

    if q.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, got {q.device}")
    b, h, s, d = q.shape
    scale = 1.0 / math.sqrt(d) * (1.0 if exp_mode == _EXP else LOG2E)
    lib = _build.load()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.reptext_attention_variant_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, s, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], scale, exp_mode,
        stream)
    if err != 0:
        raise RuntimeError(f"attention variant kernel launch failed: cudaError {err}")
    return out


def chunked_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int = 256,
                 n_chunks: int = 4) -> torch.Tensor:
    """``_chunked_kernel``: attention with the online softmax. On the card the
    128-key tiles of the kernel's ring are its chunks, whatever ``n_chunks``
    says; ``.launches`` counts the kernel's launches."""
    _check_tiling(q, k, v, block_q, n_chunks)
    if q.device.type == "cpu":
        return chunked_attn_plain(q, k, v, block_q, n_chunks)
    out = _launch(q, k, v, _EXP)
    chunked_attn.launches += 1
    return out


def bf16exp_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 block_q: int = 256) -> torch.Tensor:
    """``_bf16exp_kernel``: attention with the exponential at bf16. On the card
    (s - m) * log2(e) is rounded to bf16 and two exponentials go through one
    ``ex2.approx.ftz.bf16x2``; ``.launches`` counts the kernel's launches."""
    _check_tiling(q, k, v, block_q)
    if q.device.type == "cpu":
        return bf16exp_attn_plain(q, k, v, block_q)
    out = _launch(q, k, v, _EXP2_BF16)
    bf16exp_attn.launches += 1
    return out


def exp2_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              block_q: int = 256) -> torch.Tensor:
    """``_exp2_kernel``: attention with exp2 and log2(e) folded into the scale;
    ``.launches`` counts the kernel's launches."""
    _check_tiling(q, k, v, block_q)
    if q.device.type == "cpu":
        return exp2_attn_plain(q, k, v, block_q)
    out = _launch(q, k, v, _EXP2)
    exp2_attn.launches += 1
    return out


chunked_attn.launches = 0
bf16exp_attn.launches = 0
exp2_attn.launches = 0
