"""Kernel names from the profiler's device events: a class for each, and a
readable label for the port's attention kernels (their mangled template
arguments). The benchmark's own copy, so that the classes stay put while the
program's tools change."""

from __future__ import annotations

import functools
import re

ATTENTION, GEMM, ELEMENTWISE = "attention", "gemm", "elementwise"
CLASSES = (ATTENTION, "attention_backward", "convolution", GEMM, "collective", "optimizer",
           ELEMENTWISE)

# the template arguments, mangled (ILi128ELb1E...) or as the profiler prints
# them demangled (<128, true, ...>)
_ARG = r"(?:L[ib](\d+)E|,?\s*(\d+|true|false))"
FWD_RE = r"attn_fwd_kernel(?:I|<)" + _ARG * 7
BWD_RE = r"attn_bwd_kernel(?:I|<)" + _ARG * 3


def _args(m) -> list:
    """The matched template arguments as integers (true 1, false 0)."""
    vals = [a if a is not None else b for a, b in zip(m.groups()[::2], m.groups()[1::2])]
    return [{"true": 1, "false": 0}.get(v, None) if not v.isdigit() else int(v) for v in vals]


# a traced request launches some hundred thousand kernels of a few hundred names
@functools.lru_cache(maxsize=4096)
def kernel_class(name: str) -> str:
    """One of CLASSES: the port's attention forward (and K1's k rotation),
    its backward, cuDNN convolutions, cuBLAS/CUTLASS GEMMs, NCCL, AdamW's
    multi-tensor kernels, and everything else (norms, modulation, casts,
    copies, reductions)."""
    low = name.lower()
    if "attn_fwd_kernel" in name or "rope_rotate_kernel" in name:
        return ATTENTION
    if "attn_bwd_" in name:
        return "attention_backward"
    if any(tag in low for tag in ("conv", "fprop", "dgrad", "wgrad")):
        return "convolution"
    if any(tag in low for tag in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return GEMM
    if "nccl" in low:
        return "collective"
    if "multi_tensor_apply" in name:
        return "optimizer"
    return ELEMENTWISE


def library_label(name: str) -> str:
    """A library kernel's function name and the last functor or op in its
    template arguments (``elementwise_kernel MulFunctor``), else its first 60
    characters."""
    plain = name.replace("(anonymous namespace)::", "")
    head = re.match(r"(?:void\s+)?([\w:]+?)(?:<|\(|$)", plain)
    base = head.group(1).split("::")[-1] if head else ""
    inner = [f for f in re.findall(r"\w*(?:Functor|Ops?\b|Op<|_kernel_cuda)\w*", plain)
             if f != base]
    if not base or base == "void":
        return name[:60]
    return f"{base} {inner[-1].rstrip('<')}"[:60] if inner else base[:60]


@functools.lru_cache(maxsize=4096)
def kernel_label(name: str) -> str:
    """A short readable name: the forward template's instantiation by its
    arguments (K1 / K2-K3 / K5, clamped or online, head dim, fp32 out), the
    backward's main kernel, else the first 60 characters."""
    m = re.search(FWD_RE, name)
    if m is None:
        bwd = re.search(BWD_RE, name)
        if bwd:
            d, online, f32 = _args(bwd)
            return f"K4 main {'online' if online else 'clamped'} D{d}" + (" fp32" if f32 else "")
        other = re.search(r"(rope_rotate_kernel|attn_bwd_\w+?_kernel)", name)
        return other.group(1) if other else library_label(name)
    d, rope, online, _exp, carry, _overlap, f32 = _args(m)
    kind = "K5" if carry else ("K1" if rope else "K2/K3")
    return f"{kind} {'online' if online else 'clamped'} D{d}" + (" fp32" if f32 else "")
