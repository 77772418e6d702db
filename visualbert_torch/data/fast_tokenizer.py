"""ctypes binding of the native C++ WordPiece tokenizer
(``visualbert_torch/csrc/wordpiece.cpp``; counterpart of
``visualbert_tpu/data/fast_tokenizer.py``).

The C++ path is byte-exact with the Python tokenizer for ASCII text;
strings holding a non-ASCII character (accents, CJK) go to the Python
implementation, so every result equals ``BertTokenizer``'s. The shared
library is built with g++ at first use into
``visualbert_torch/_build/wordpiece-<hash of the source and flags>/``. A
missing g++ or a failed build raises with g++'s log; the JAX package falls
back to the Python tokenizer there without a word.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from visualbert_torch.data.tokenization import BertTokenizer

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "wordpiece.cpp"
BUILD_ROOT = _PKG / "_build"
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
LIB_NAME = "libwordpiece.so"

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / f"wordpiece-{h}" / LIB_NAME


def build(path: Path) -> Path:
    """Compile SOURCE with g++ into ``path`` (atomically: concurrent builds
    agree); raises with g++'s output when it fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native tokenizer is built from visualbert_torch/csrc/wordpiece.cpp "
                           "at first use")
    path.parent.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=path.parent))
    try:
        cmd = [gxx, *FLAGS, "-o", str(work / LIB_NAME), str(SOURCE)]
        done = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"g++ failed ({done.returncode}):\n{' '.join(cmd)}\n{done.stdout}")
        os.replace(work / LIB_NAME, path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return path


def load() -> ctypes.CDLL:
    """The native library, built on first call in this checkout."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            lib = ctypes.CDLL(str(path if path.exists() else build(path)))
            lib.wp_create.restype = ctypes.c_void_p
            lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.wp_free.argtypes = [ctypes.c_void_p]
            lib.wp_encode.restype = ctypes.c_int64
            lib.wp_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
            lib.wp_encode_batch.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                                            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                                            ctypes.POINTER(ctypes.c_int32)]
            _lib = lib
        return _lib


class FastBertTokenizer(BertTokenizer):
    """``BertTokenizer`` (lower-casing) with the native encode path for ASCII
    text. The C++ path needs dense ids 0..n-1; a vocabulary with sparse ids
    uses the Python path throughout, as the JAX package's does."""

    def __init__(self, vocab: Dict[str, int]):
        super().__init__(vocab)
        self._native = None
        ordered = sorted(vocab.items(), key=lambda kv: kv[1])
        if [i for _, i in ordered] == list(range(len(ordered))):
            lib = load()
            blob = ("\n".join(t for t, _ in ordered) + "\n").encode("utf-8")
            self._native = (lib, ctypes.c_void_p(lib.wp_create(blob, len(blob))))

    def __del__(self):
        native = getattr(self, "_native", None)
        if native is not None:
            lib, handle = native
            lib.wp_free(handle)

    @property
    def native_available(self) -> bool:
        return self._native is not None

    def encode(self, text: str) -> List[int]:
        if self._native is not None and text.isascii():
            lib, handle = self._native
            raw = text.encode("ascii")
            max_out = max(len(raw) * 2, 16)
            out = (ctypes.c_int32 * max_out)()
            n = lib.wp_encode(handle, raw, len(raw), out, max_out)
            return list(out[:n])
        return super().encode(text)

    def tokenize(self, text: str) -> List[str]:
        if self._native is not None and text.isascii():
            return self.convert_ids_to_tokens(self.encode(text))
        return super().tokenize(text)

    def encode_batch(self, texts: List[str], max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        """([n, max_len] int32 ids, 0-padded; [n] int32 lengths), through one
        native call when every text is ASCII."""
        out = np.zeros((len(texts), max_len), np.int32)
        lens = np.zeros(len(texts), np.int32)
        if self._native is not None and all(t.isascii() for t in texts):
            lib, handle = self._native
            blob = "".join(texts).encode("ascii")
            offsets = np.zeros(len(texts) + 1, np.int64)
            np.cumsum([len(t) for t in texts], out=offsets[1:])
            lib.wp_encode_batch(handle, blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(texts),
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_len,
                                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            return out, lens
        for i, t in enumerate(texts):
            ids = super().encode(t)[:max_len]
            out[i, : len(ids)] = ids
            lens[i] = len(ids)
        return out, lens
