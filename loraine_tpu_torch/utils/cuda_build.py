"""Build a CUDA source of `loraine_tpu_torch/csrc/` with nvcc and load it
with ctypes. No JAX counterpart (Pallas kernels compile inside JAX).

A library is built at first use, from the checkout's sources only, into
``build/loraine_tpu_torch/`` at the root of the checkout, for ``sm_90a``
(Hopper). The file name carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. A build
failure raises with nvcc's output. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

__all__ = ["load_library", "build_libraries", "BUILD_DIR", "NVCC_FLAGS"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "loraine_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _target(name: str) -> Path:
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_libraries(*names: str) -> None:
    """Build every missing ``csrc/<name>.cu`` at once, one nvcc process per
    source, all started together; raises with nvcc's output on a failure."""
    procs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs.append((cmd, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for cmd, tmp, out, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stdout}\n{stderr}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` as a shared library."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    build_libraries(name)
    lib = ctypes.CDLL(str(_target(name)))
    _LOADED[name] = lib
    return lib
