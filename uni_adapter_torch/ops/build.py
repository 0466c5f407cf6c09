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
import types
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "uni_adapter_torch"
SOURCES = ("fps", "knn", "eva_attn_block", "ballquery", "eva_attention",
           "attention_heads", "knn_gather", "fps_grid", "attention_fp32",
           "eva_attn_block_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Launches of `attn_f32_tc_kernel` (`csrc/attention_core_f32_tc.cuh`),
#: the split-TF32 kernel behind the three fp32 attention entries: each
#: entry reports whether its launch ran it, and its wrapper adds that here.
attn_f32_tc = types.SimpleNamespace(launches=0)


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


def _nvcc_job(src: Path, out: Path) -> subprocess.Popen:
    """Start `nvcc` on `src` into the library `out`; its output piped."""
    return subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _start_build(name: str):
    """Start `nvcc` for one source; returns (process, tmp path, final path)
    or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    return _nvcc_job(CSRC / f"{name}.cu", tmp), tmp, out


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


def build_variants(variants: dict, subdir: str) -> dict:
    """Build sources of `csrc/` with extra `#define`s, for the scripts that
    time candidate configurations.  `variants` maps a key to (source,
    defines), the source a name under `csrc/` or the Path of a .cu file
    elsewhere (another checkout's, to time it in the same run); each is a
    file under BUILD_DIR / `subdir` that holds the defines and includes
    the source, every `nvcc` started at once.  Returns {key: (loaded
    library, nvcc's output)}; a failed build raises with its output once
    every build has ended."""
    out_dir = BUILD_DIR / subdir
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (key, (source, defines)) in enumerate(variants.items()):
        path = (source.resolve() if isinstance(source, Path)
                else CSRC / f"{source}.cu")
        name = path.stem
        src, out = out_dir / f"{name}-{i}.cu", out_dir / f"lib{name}-{i}.so"
        src.write_text(defines + f'#include "{path}"\n')
        jobs[key] = out, _nvcc_job(src, out)
    logs = {key: proc.communicate()[0] for key, (_, proc) in jobs.items()}
    for key, (out, proc) in jobs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {out.name}:\n{logs[key]}")
    return {key: (ctypes.CDLL(str(out)), logs[key])
            for key, (out, _) in jobs.items()}


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


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record an op on `tensors`: grad mode is on
    and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def require_no_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raise where a kernel with no backward is asked for a value that
    autograd would differentiate: its result would carry no gradient, and
    the caller's backward would drop that part of it without a word."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward, and an input requires "
            "grad with grad mode on; run it under torch.no_grad() or on "
            "tensors that do not require grad")


def kernel_for(what: str, kernels: dict, dtype: torch.dtype):
    """The launcher in `kernels` ({dtype: wrapper}) for tensors of `dtype`
    on the card; a dtype with no kernel raises, naming it."""
    if dtype not in kernels:
        raise ValueError(f"{what}: no CUDA kernel for {dtype} (the card's "
                         f"kernels take {', '.join(map(str, kernels))})")
    return kernels[dtype]
