"""Tracing and timing (mirror of `uni_adapter_tpu/utils/profiling.py`'s
`trace` and `fetch_synced_time`).

  * `trace(log_dir)`: a `torch.profiler` session around a block, of the
    host and, where PyTorch was built with CUDA, the device; it writes a
    Chrome trace (`chrome://tracing`, Perfetto) into `log_dir`.  Two
    profiler sessions cannot nest: a block already under one must not
    open `trace`.
  * `fetch_synced_time(fn, ...)`: wall time of `fn` between two device
    synchronisations (`torch.cuda.synchronize`), after one untimed call.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def fetch_synced_time(fn: Callable, *args, repeats: int = 1, **kwargs):
    """Run fn once untimed, then `repeats` times between two device
    synchronisations.  Returns (the last output, seconds a call)."""
    out = fn(*args, **kwargs)
    _sync()
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn(*args, **kwargs)
    _sync()
    return out, (time.perf_counter() - t0) / repeats


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU and CUDA activities, those this PyTorch
    supports) and write its Chrome trace to
    `log_dir/trace_<pid>_<time>.json`; yields the profiler."""
    wanted = {torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA}
    acts = [a for a in torch.profiler.supported_activities() if a in wanted]
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.strftime('%Y%m%d-%H%M%S')}"
        f".json"))
