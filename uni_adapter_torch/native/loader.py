"""ctypes bindings of the native .npy reader `npy_loader.cpp` (a copy of
`uni_adapter_tpu/native/`'s): mmap'd archives read a sample at a time,
and a background prefetch ring.

The library is built with `g++` at first use, never at import, into
`build/uni_adapter_torch/` at the root of the checkout (as the CUDA
kernels are, `ops/build.py`), under a name keyed on a hash of the source
and the flags.  This is host I/O, not a device kernel: where the build
fails, or a file will not open, reads go through a numpy memmap, as in the
JAX package, and the fallback is logged.  `native_available()` says which
path a process took.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "npy_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "uni_adapter_torch"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libnpy_loader-{digest[:16]}.so"


def _build(out: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp), "-lpthread"],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, out)    # atomic: a concurrent loader sees all or none


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ua_open.restype = ctypes.c_void_p
    lib.ua_open.argtypes = [ctypes.c_char_p]
    lib.ua_ndim.restype = ctypes.c_int
    lib.ua_ndim.argtypes = [ctypes.c_void_p]
    lib.ua_shape.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.ua_read_f32.restype = ctypes.c_int64
    lib.ua_read_f32.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_float)]
    lib.ua_read_i64.restype = ctypes.c_int64
    lib.ua_read_i64.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_int64)]
    lib.ua_close.argtypes = [ctypes.c_void_p]
    lib.ua_prefetch_start.restype = ctypes.c_void_p
    lib.ua_prefetch_start.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ua_prefetch_stop.argtypes = [ctypes.c_void_p]
    return lib


def _ensure_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None (logged once) where
    it cannot be built or loaded."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        out = library_path()
        try:
            if not out.exists():
                _build(out)
            _lib = _bind(ctypes.CDLL(str(out)))
        except Exception as e:
            logging.info("native npy loader unavailable (%s); reading with "
                         "numpy", e)
            _build_failed = True
        return _lib


def native_available() -> bool:
    """Whether the native reader is built and loaded (building it if not)."""
    return _ensure_lib() is not None


class NativeNpy:
    """An mmap'd .npy reader with an optional background prefetch ring:
    `read_f32(i)` returns sample i (the trailing dims) as float32,
    `read_i64(i)` as int64.  Reads through a numpy memmap where the native
    path is out (`native` says which)."""

    def __init__(self, path: str, prefetch: int = 0):
        self.path = path
        self._lib = _ensure_lib()
        self._h = None
        self._pf = None
        if self._lib is not None:
            self._h = self._lib.ua_open(path.encode())
            if not self._h:
                logging.info("native npy loader cannot open %s; reading "
                             "with numpy", path)
                self._lib = None
        if self._lib is not None:
            nd = self._lib.ua_ndim(self._h)
            buf = (ctypes.c_int64 * nd)()
            self._lib.ua_shape(self._h, buf)
            self.shape = tuple(buf[:nd])
            if prefetch > 1:
                self._pf = self._lib.ua_prefetch_start(self._h, prefetch)
        else:
            self._np = np.load(path, mmap_mode="r")
            self.shape = tuple(self._np.shape)
        self._sample_elems = (int(np.prod(self.shape[1:]))
                              if len(self.shape) > 1 else 1)

    @property
    def native(self) -> bool:
        return self._lib is not None

    def __len__(self) -> int:
        return self.shape[0]

    def read_f32(self, i: int) -> np.ndarray:
        if self._lib is not None:
            out = np.empty(self._sample_elems, np.float32)
            n = self._lib.ua_read_f32(
                self._h, i, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
            if n < 0:
                raise ValueError(f"read failed at {i}")
            return out.reshape(self.shape[1:])
        return np.asarray(self._np[i], np.float32)

    def read_i64(self, i: int) -> np.ndarray:
        if self._lib is not None:
            out = np.empty(self._sample_elems, np.int64)
            n = self._lib.ua_read_i64(
                self._h, i, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            if n < 0:
                raise ValueError(f"read failed at {i}")
            return (out.reshape(self.shape[1:]) if len(self.shape) > 1
                    else out[0])
        return np.asarray(self._np[i], np.int64)

    def close(self) -> None:
        if self._lib is not None and self._h:
            if self._pf:
                self._lib.ua_prefetch_stop(self._pf)
                self._pf = None
            self._lib.ua_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
