"""Reader and writer of the safetensors format, on torch tensors.

The JAX package reads checkpoints with the ``safetensors`` package
(``reptext_tpu/io/convert.py::load_safetensors_state``), whose numpy
interface needs ``ml_dtypes`` to hold bf16. The port reads and writes the
format itself, so that bf16 stays bf16 with torch alone:

- 8 bytes: the header's length, a little-endian unsigned 64-bit integer;
- the header: JSON ``{name: {"dtype", "shape", "data_offsets": [begin, end]},
  "__metadata__": {str: str}}``, the offsets relative to the data;
- the data: every tensor's raw little-endian bytes, with no gaps.

:func:`load_file` maps the file (copy on write) and returns CPU tensors that
view the mapping, so a tensor's bytes are read when it is first used.
F8_E4M3 and the other fp8 and sub-byte dtypes are refused: fp8 storage is not
ported yet.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Mapping, Optional

import torch

DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "F64": torch.float64, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
_MAX_HEADER = 100 * 2**20


def _header(mm, path: str):
    if len(mm) < 8:
        raise ValueError(f"{path}: {len(mm)} bytes, too short for a safetensors header")
    (n,) = struct.unpack("<Q", mm[:8])
    if n > _MAX_HEADER or 8 + n > len(mm):
        raise ValueError(f"{path}: header length {n} does not fit the file ({len(mm)} bytes)")
    return json.loads(bytes(mm[8:8 + n]).decode("utf-8")), 8 + n


def read_metadata(path: str) -> Dict[str, str]:
    """The ``__metadata__`` of a safetensors file ({} when it has none)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(n).decode("utf-8")).get("__metadata__") or {}


def load_file(path: str, dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of one safetensors file, in the stored dtype unless
    ``dtype`` is given (then floating tensors are cast to it, integer ones kept).

    The tensors view a copy-on-write mapping of the file: nothing is read
    until it is used, and writing to a tensor never reaches the file.
    """
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size == 0:
            raise ValueError(f"{path}: empty file")
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    header, start = _header(mm, path)
    data_len = len(mm) - start
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        code = info["dtype"]
        if code not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {code}, which the port does "
                             "not read (fp8 storage is not ported yet)")
        tdtype, shape = DTYPES[code], [int(s) for s in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        count = 1
        for s in shape:
            count *= s
        itemsize = torch.empty((), dtype=tdtype).element_size()
        if not 0 <= begin <= end <= data_len or end - begin != count * itemsize:
            raise ValueError(f"{path}: tensor {name!r} ({code} {shape}) has data offsets "
                             f"[{begin}, {end}) that do not fit it or the file")
        if count == 0:
            t = torch.empty(shape, dtype=tdtype)
        else:
            t = torch.frombuffer(mm, dtype=tdtype, count=count, offset=start + begin)
            t = t.reshape(shape)
        if dtype is not None and t.is_floating_point() and t.dtype != dtype:
            t = t.to(dtype)
        out[name] = t
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write ``tensors`` (any device, any layout) as one safetensors file; the
    bytes written.

    Tensors are laid out from the widest dtype to the narrowest, then by
    name, so that every offset is a multiple of its tensor's element size, and
    the header is padded with spaces to a multiple of 8 bytes, as the
    ``safetensors`` package writes it. One tensor at a time is made
    contiguous on the CPU.
    """
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no safetensors name here")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            t = tensors[name].detach()
            if t.numel():
                t = t.to("cpu").contiguous().reshape(-1)
                f.write(memoryview(t.view(torch.uint8).numpy()))
    os.replace(tmp, path)
    return 8 + len(raw) + offset
