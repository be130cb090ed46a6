"""Build the port's CUDA source with `nvcc` at first use and load it with
ctypes (plain C interface: pointers and the stream as `c_void_p`).

The shared library goes to `bioreason_tpu_torch/build/`, keyed by a hash of
the source and flags, so a fresh checkout builds once and a changed source
builds anew. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels of bioreason_tpu_torch cannot be built")


def load_library(name: str, source: str) -> Tuple[ctypes.CDLL, str]:
    """Compile `source` (a path relative to csrc/) into a shared library
    unless a build of the same content exists, then load it. Returns the
    library and nvcc's output (the ptxas report), empty when no build ran."""
    with _lock:
        if name in _libs:
            return _libs[name], ""
        path = CSRC_DIR / source
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
        so = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
        log = ""
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(path)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, so)
            log = proc.stdout + proc.stderr
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        return lib, log
