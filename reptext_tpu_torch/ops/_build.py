"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The kernels live in ``reptext_tpu_torch/csrc/*.cu`` behind a plain C
interface. At first use each source is compiled for Hopper (``sm_90a``) by its
own ``nvcc``, all started together, and the objects are linked into one
shared library under ``reptext_tpu_torch/_build/`` (listed in .gitignore),
which is rebuilt whenever a source or header is newer than it. Nothing here
imports torch or touches a GPU, so the module is safe to import anywhere;
building needs ``nvcc`` and raises with its output when a compile fails.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time
from typing import List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libreptext_torch_kernels.so")

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = {"seconds": None, "ptxas": ""}


def count_launch(entry) -> None:
    """``entry.launches += 1`` under a lock: ranks run as threads of one
    process (``parallel/testing.py``) launch concurrently."""
    with _count_lock:
        entry.launches += 1


def sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def headers() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
        cand = os.path.join(home, "bin", "nvcc")
        if os.path.exists(cand):
            nvcc = cand
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")
    return nvcc


def nvcc_command(nvcc: str, src: str, out: str) -> List[str]:
    """The compile line of one source: Hopper sm_90a, C++17, -O3, a
    position-independent object."""
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", out, src]


def link_command(nvcc: str, objs: List[str], out: str) -> List[str]:
    """The link line: the objects into one shared library."""
    return [nvcc, *ARCH_FLAGS, "-shared", "-o", out, *objs]


def _stale(inputs: List[str]) -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in inputs)


def build(force: bool = False) -> str:
    """Compile the .cu sources into LIB_PATH if it is missing or stale."""
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    if not force and not _stale(srcs + headers()):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in srcs]
    t0 = time.perf_counter()
    procs = [(nvcc_command(nvcc, s, o), subprocess.Popen(
        nvcc_command(nvcc, s, o), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for s, o in zip(srcs, objs)]
    logs, failed = [], []
    for cmd, proc in procs:
        out, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = f"{LIB_PATH}.{tag}"
        link = link_command(nvcc, objs, tmp)
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(link)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader never sees half a file
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    build_log["seconds"] = time.perf_counter() - t0
    build_log["ptxas"] = "".join(logs)
    return LIB_PATH


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            c_p, c_i, c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fn = lib.reptext_flash_attention_fwd
            fn.argtypes = ([c_p] * 8 + [c_i] * 4 + [c_ll] * 12
                           + [ctypes.c_float, c_i, c_i, c_p])
            fn.restype = c_i
            fn = lib.reptext_flash_attention_streaming_fwd
            fn.argtypes = [c_p] * 5 + [c_i] * 4 + [c_ll] * 12 + [ctypes.c_float, c_i, c_p]
            fn.restype = c_i
            fn = lib.reptext_attention_variant_fwd
            fn.argtypes = [c_p] * 4 + [c_i] * 4 + [c_ll] * 12 + [ctypes.c_float, c_i, c_p]
            fn.restype = c_i
            fn = lib.reptext_flash_attention_bwd
            fn.argtypes = ([c_p] * 9 + [c_i] * 4 + [c_ll] * 12 + [ctypes.c_float, c_i, c_p])
            fn.restype = c_i
            fn = lib.reptext_ring_attention_step
            fn.argtypes = [c_p] * 7 + [c_i] * 5 + [c_ll] * 12 + [ctypes.c_float, c_i, c_i, c_p]
            fn.restype = c_i
            _lib = lib
        return _lib
