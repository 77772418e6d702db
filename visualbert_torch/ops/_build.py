"""Builds the port's CUDA kernels and loads them with ctypes.

All sources under ``visualbert_torch/csrc/`` are compiled by ``nvcc`` for
``sm_90a`` (one ``nvcc`` per ``.cu`` file, all started together) and linked
into one shared library with a plain C interface (no PyTorch headers, so a
build takes seconds, not minutes), at first use, into
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
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]
LIB_NAME = "libvisualbert_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_SIGNATURES = {  # every C entry point of the sources: its argument types
    "vb_error_string": [_I],
    "vb_dropout_info": [_I, _I, _I],
    "vb_dropout_mask": [_P, ctypes.c_longlong, _I, _U, _U, _F, _P],
    "vb_dropout_fwd": [_P, _P, _P, ctypes.c_longlong, _I, _U, _U, _F, _P],
    "vb_dropout_bwd": [_P, _P, _P, ctypes.c_longlong, _I, _U, _U, _F, _P],
    "vb_attn_packed_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _U, _U, _F, _I, _P],
    "vb_attn_packed_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _U, _F, _I, _P],
    "vb_attn_packed_smem_bytes": [_I],
    "vb_attn_packed_info": [_I, _I, _I],
    "vb_attn_packed_x_smem_bytes": [_I, _I],
    "vb_attn_packed_x_info": [_I, _I, _I, _I, _I],
    "vb_attn_packed_x_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _U, _U, _F, _I, _I, _I, _F, _P],
    "vb_attn_packed_x_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _U, _F, _I, _I, _I, _F, _P],
    "vb_attn_packed_x_probe": [_P, _P, _P, _P, _P, _I, _I, _P],
    "vb_attn_packed_x_bias_rows": [_I, _I],
    "vb_attn_f32_info": [_I, _I, _I],
    "vb_attn_f32_geometry": [_I],
    "vb_attn_f32_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _U, _U, _F, _I, _F, _P],
    "vb_attn_f32_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _U, _U, _F, _I, _F, _P],
    "vb_attn_hm_smem_bytes": [_I],
    "vb_attn_hm_info": [_I, _I, _I],
    "vb_attn_hm_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _U, _U, _F, _I, _P],
    "vb_attn_hm_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _U, _F, _I, _P],
    "vb_attn_sp_smem_bytes": [_I],
    "vb_attn_sp_info": [_I, _I, _I],
    "vb_attn_sp_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _U, _F, _I, _P],
    "vb_attn_sp_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _U, _U, _F, _I, _P],
    "vb_attn_hm_x_smem_bytes": [_I, _I],
    "vb_attn_hm_x_info": [_I, _I, _I, _I, _I],
    "vb_attn_hm_x_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _U, _U, _F, _I, _I, _I, _F, _P],
    "vb_attn_hm_x_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _U, _F, _I, _I, _I, _F, _P],
    "vb_attn_sp_x_smem_bytes": [_I, _I],
    "vb_attn_sp_x_info": [_I, _I, _I, _I, _I],
    "vb_attn_sp_x_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _U, _F, _I, _I, _I, _F, _P],
    "vb_attn_sp_x_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _U, _U, _F, _I, _I, _I, _F, _P],
    "vb_attn_f32_sp_info": [_I, _I, _I],
    "vb_attn_f32_hm_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _U, _U, _F, _I, _F, _P],
    "vb_attn_f32_hm_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _U, _U, _F, _I, _F, _P],
    "vb_attn_f32_sp_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _U, _F, _I, _F, _P],
    "vb_attn_f32_sp_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _U, _F, _I, _F, _P],
    "vb_attn_exp_smem_bytes": [_I],
    "vb_attn_exp_info": [_I, _I, _I, _I, _I],
    "vb_attn_exp_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _U, _U, _F, _I, _P],
    "vb_attn_exp_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _U, _U, _F, _I, _P],
    "vb_xent_geometry": [_I, _I],
    "vb_xent_info": [_I, _I, _I],
    "vb_xent_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "vb_xent_dx": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "vb_xent_de": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "vb_xent_f16_info": [_I, _I, _I],
    "vb_xent_f16_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "vb_xent_f16_dx": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "vb_xent_f16_de": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "vb_xent_wide_geometry": [_I],
    "vb_xent_wide_info": [_I, _I, _I],
    "vb_xent_wide_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "vb_xent_wide_dx": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "vb_xent_wide_de": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "vb_xent_f16_wide_geometry": [_I],
    "vb_xent_f16_wide_info": [_I, _I, _I],
    "vb_xent_f16_wide_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "vb_xent_f16_wide_dx": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "vb_xent_f16_wide_de": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "vb_xent_f32_geometry": [_I],
    "vb_xent_f32_info": [_I, _I, _I],
    "vb_xent_f32_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "vb_xent_f32_dx": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "vb_xent_f32_de": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "vb_ln_geometry": [_I],
    "vb_ln_info": [_I, _I, _I, _I],
    "vb_ln_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _U, _U, _F, _P],
    "vb_ln_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _U, _F, _P],
}


def restype(name: str):
    """The return type of C entry point ``name``: a CUDA error code for a
    launch or a query, a byte count for a shared-memory size."""
    if name == "vb_error_string":
        return ctypes.c_char_p
    return ctypes.c_size_t if name.endswith("_smem_bytes") else ctypes.c_int


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
            fn.restype = restype(name)

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


def _run_all(cmds):
    """Run the commands at once; returns [(cmd, returncode, output)] in order."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs = [p.communicate()[0] for _, p in procs]  # drains each pipe: no writer blocks for long
    return [(cmd, p.returncode, out) for (cmd, p), out in zip(procs, outs)]


def build(out_dir: Path) -> KernelLibrary:
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out_dir))  # private to this build
    try:
        cu = [p for p in sources() if p.suffix == ".cu"]
        objs = [str(work / f"{p.stem}.o") for p in cu]
        t0 = time.perf_counter()
        results = _run_all([[nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(p), "-o", o]
                            for p, o in zip(cu, objs)])
        if all(rc == 0 for _, rc, _ in results):
            results += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(work / LIB_NAME), *objs]])
        seconds = time.perf_counter() - t0
        log = "".join(out for _, _, out in results)
        for cmd, rc, out in results:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
        (out_dir / "build.log").write_text(log)
        os.replace(work / LIB_NAME, out_dir / LIB_NAME)  # atomic: concurrent builds agree
    finally:
        shutil.rmtree(work, ignore_errors=True)
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


def sm_count(device) -> int:
    """The card's SM count (the grids that fill the card are planned from it)."""
    import torch

    return torch.cuda.get_device_properties(device).multi_processor_count
