"""Builds the port's CUDA kernels and loads them with ctypes.

All sources under ``visualbert_torch/csrc/`` are compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface (no PyTorch
headers, so a build takes seconds, not minutes), at first use, into
``visualbert_torch/_build/<hash of sources and flags>/``. A missing ``nvcc``
or a failed build raises; nothing falls back to another implementation.

Every C entry point returns ``cudaGetLastError()`` after its launches;
:meth:`KernelLibrary.check` raises on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]
LIB_NAME = "libvisualbert_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_SIGNATURES = {
    "vb_dropout_mask": [_P, ctypes.c_longlong, _I, _U, _U, _F, _P],
    "vb_attn_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _U, _U, _F, _I, _P],
    "vb_attn_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _U, _U, _F, _I, _P],
    "vb_attn_smem_bytes": [_I],
}


class KernelLibrary:
    """The loaded library plus how it was obtained (path, build seconds,
    compiler log with ptxas register and spill counts)."""

    def __init__(self, path: Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.log = log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_size_t if name == "vb_attn_smem_bytes" else ctypes.c_int
        self.lib.vb_error_string.argtypes = [_I]
        self.lib.vb_error_string.restype = ctypes.c_char_p

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def check(self, code: int, what: str) -> None:
        """Raise when a C entry point returned a CUDA error."""
        if code != 0:
            msg = self.lib.vb_error_string(code).decode()
            raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


_lock = threading.Lock()
_library: Optional[KernelLibrary] = None


def sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of visualbert_torch are built from "
        "visualbert_torch/csrc at first use and need the CUDA toolkit"
    )


def build(out_dir: Path) -> KernelLibrary:
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sources() if p.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    (out_dir / "build.log").write_text(log)
    os.replace(tmp, out_dir / LIB_NAME)  # atomic: concurrent builders agree
    return KernelLibrary(out_dir / LIB_NAME, seconds, log)


def library() -> KernelLibrary:
    """The kernel library, built on first call in this checkout."""
    global _library
    with _lock:
        if _library is None:
            out_dir = BUILD_ROOT / source_hash()
            path = out_dir / LIB_NAME
            if path.exists():
                log_path = out_dir / "build.log"
                _library = KernelLibrary(path, 0.0, log_path.read_text() if log_path.exists() else "")
            else:
                _library = build(out_dir)
        return _library


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
