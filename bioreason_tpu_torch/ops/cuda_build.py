"""Build the port's CUDA sources with `nvcc` at first use (one nvcc per
source, run together) and load them with ctypes (plain C interface:
pointers and the stream as `c_void_p`).

The shared library goes to `bioreason_tpu_torch/build/`, keyed by a hash of
the flags, the source and every header of csrc/ (`*.cuh`, which the sources
include), so a fresh checkout builds once and a changed source or header
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
_paths: Dict[str, Path] = {}


def cuda_tool(name: str) -> str:
    """A CUDA toolkit program (`nvcc`, `cuobjdump`): PATH, then
    $CUDA_HOME/bin, then /usr/local/cuda/bin."""
    found = shutil.which(name)
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", name)
    if os.path.exists(path):
        return path
    raise RuntimeError(f"{name} not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels of bioreason_tpu_torch cannot be built")


def library_file(name: str, source: str, csrc_dir: Path = CSRC_DIR,
                 build_dir: Path = BUILD_DIR) -> Path:
    """Where the build of `source` (relative to `csrc_dir`) lives: its name
    holds a hash of the nvcc flags, the source and every `*.cuh` header in
    `csrc_dir`, in name order."""
    path = csrc_dir / source
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(path.name.encode())
    digest.update(path.read_bytes())
    for header in sorted(csrc_dir.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    return build_dir / f"lib{name}-{digest.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    """The shared library file loaded under `name` (after load_libraries)."""
    return _paths[name]


def load_libraries(sources: Dict[str, str]) -> Dict[str, Tuple[ctypes.CDLL, str]]:
    """Compile each `name: source` (a path relative to csrc/) into a shared
    library unless a build of the same content exists, then load it. The
    builds that are needed run together, one nvcc per source. Returns
    name -> (library, nvcc's output: the ptxas report, empty when no build
    ran)."""
    with _lock:
        out, builds = {}, {}
        for name, source in sources.items():
            if name in _libs:
                out[name] = (_libs[name], "")
                continue
            path = CSRC_DIR / source
            so = library_file(name, source)
            tmp, proc = so.with_name(f"{so.name}.{os.getpid()}.tmp"), None
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                proc = subprocess.Popen([cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(path)],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True)
            builds[name] = (so, tmp, proc)
        failed = []
        for name, (so, tmp, proc) in builds.items():
            log = ""
            if proc is not None:
                log = proc.communicate()[0]
                if proc.returncode != 0:
                    failed.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
                    continue
                os.replace(tmp, so)
            _libs[name] = ctypes.CDLL(str(so))
            _paths[name] = so
            out[name] = (_libs[name], log)
        if failed:
            raise RuntimeError("\n".join(failed))
        return out
