"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` exports a plain C interface and is compiled by
`nvcc` for `sm_90a` into `build/uni_adapter_torch/lib<name>-<hash>.so` at
the root of the checkout, then loaded with `ctypes`.  The hash covers the
source, the shared headers (`csrc/*.cuh`) and the flags, so an edited
source or header rebuilds and an unchanged one is reused.  Nothing here runs at import: a kernel is built at its first
launch, or ahead of time by `build_all` (which starts one `nvcc` per
source, all at once).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "uni_adapter_torch"
SOURCES = ("fps", "knn", "eva_attn_block", "ballquery", "eva_attention",
           "attention_heads", "knn_gather", "fps_grid", "attention_fp32")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start_build(name: str):
    """Start `nvcc` for one source; returns (process, tmp path, final path)
    or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)        # atomic: a concurrent loader sees all or none
    return log


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every source in parallel; returns nvcc's output per source
    (the `-Xptxas -v` register and shared-memory report)."""
    jobs = {n: _start_build(n) for n in names}
    return {n: _finish_build(n, job) for n, job in jobs.items()
            if job is not None}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    job = _start_build(name)
    if job is not None:
        _finish_build(name, job)
    return ctypes.CDLL(str(library_path(name)))


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on `t`'s device, as a pointer for ctypes."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise on a nonzero `cudaGetLastError()` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError_t {rc})")


def require_cuda(t: torch.Tensor, dtype: torch.dtype, ndim: int,
                 what: str, contiguous: bool = True) -> None:
    """Checks shared by the kernel wrappers, before any pointer is passed."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def kernel_for(what: str, kernels: dict, dtype: torch.dtype):
    """The launcher in `kernels` ({dtype: wrapper}) for tensors of `dtype`
    on the card; a dtype with no kernel raises, naming it."""
    if dtype not in kernels:
        raise ValueError(f"{what}: no CUDA kernel for {dtype} (the card's "
                         f"kernels take {', '.join(map(str, kernels))})")
    return kernels[dtype]
