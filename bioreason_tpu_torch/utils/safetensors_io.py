"""Read and write `.safetensors` files with `torch` and the standard library
only (the port's counterpart of the `safetensors` package, which the JAX
package's `utils/hf_import.py:33` calls).

The format: an 8-byte little-endian header length N, N bytes of JSON
header ({name: {"dtype", "shape", "data_offsets": [begin, end]}}, with an
optional "__metadata__" map of strings), then the raw little-endian data,
each tensor at its offsets from the end of the header.

`load_file` memory-maps the file (a private copy-on-write mapping) and
returns tensors that view the mapping, so nothing is read until a tensor is
touched and a bf16 checkpoint is never widened on the host: BF16 bytes are
viewed as `torch.bfloat16` directly (numpy has no bf16).
"""

from __future__ import annotations

import hashlib
import json
import mmap
import os
import struct
import sys
from typing import Dict, Optional, Tuple

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64, "I32": torch.int32, "U8": torch.uint8, "BOOL": torch.bool}
NAMES = {v: k for k, v in DTYPES.items()}
ALIGN = 8


def _check_host() -> None:
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors data is little-endian; this host is not")


def read_header(path: str) -> Tuple[Dict, int]:
    """(the JSON header, the byte offset where the data starts)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: too short for a safetensors file")
        (n,) = struct.unpack("<Q", head)
        if n > os.path.getsize(path) - 8:
            raise ValueError(f"{path}: header length {n} runs past the end of the file")
        return json.loads(f.read(n)), 8 + n


def header_fingerprint(path: str) -> Dict[str, object]:
    """The file's size and the sha256 of its header bytes: the names, dtypes,
    shapes and offsets of every tensor. Cheap at any size, and a rewritten
    or swapped checkpoint changes it unless every tensor's layout is equal."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        digest = hashlib.sha256(f.read(n)).hexdigest()
    return {"size": os.path.getsize(path), "header_sha256": digest}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of `path`, in header order, on the CPU: each views a
    memory map of the file, in its stored dtype."""
    _check_host()
    header, start = read_header(path)
    header.pop("__metadata__", None)
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    raw = torch.frombuffer(mm, dtype=torch.uint8) if len(mm) else torch.empty(0, dtype=torch.uint8)
    out: Dict[str, torch.Tensor] = {}
    for name, spec in header.items():
        dtype = DTYPES.get(spec["dtype"])
        if dtype is None:
            raise NotImplementedError(f"{path}: {name} has dtype {spec['dtype']}; supported: "
                                      f"{sorted(DTYPES)}")
        begin, end = spec["data_offsets"]
        shape = list(spec["shape"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        numel = 1
        for s in shape:
            numel *= s
        if end - begin != numel * itemsize or start + end > len(mm):
            raise ValueError(f"{path}: {name} offsets {begin}..{end} do not hold {shape} "
                             f"{spec['dtype']}")
        chunk = raw[start + begin:start + end]
        if (start + begin) % itemsize:           # unaligned: copy out of the map
            chunk = chunk.clone()
        out[name] = chunk.view(dtype).reshape(shape)
    return out


def _raw_bytes(t: torch.Tensor) -> memoryview:
    t = t.detach().to("cpu").contiguous()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.view(torch.int16)
    elif t.dtype == torch.bool:
        t = t.view(torch.uint8)
    return memoryview(t.numpy()).cast("B")


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (names to CPU or device tensors of a supported dtype)
    to `path`: the data sorted by dtype width, widest first, then name, so
    every tensor starts aligned to its width; the header padded with spaces
    to 8 bytes."""
    _check_host()
    items = sorted(tensors.items(),
                   key=lambda kv: (-kv[1].element_size(), kv[0]))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in items:
        if t.dtype not in NAMES:
            raise NotImplementedError(f"{name}: dtype {t.dtype} is not supported")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-(8 + len(blob)) % ALIGN)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, t in items:
            if t.numel():
                f.write(_raw_bytes(t))
    os.replace(tmp, path)
