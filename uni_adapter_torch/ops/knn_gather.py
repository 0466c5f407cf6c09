"""k-nearest neighbours with the neighbours' values gathered in the same
launch, for clouds of any size: the Hopper kernel `csrc/knn_gather.cu` and
its plain PyTorch version.

Replaces `uni_adapter_tpu/ops/knn_pallas.py::knn_gather_pallas`.  The
selection is `knn.knn_plain`'s (the same fp32 expansion, ascending
distance, ties to the lowest index, from `csrc/knn_core.cuh` on the card)
and every selected neighbour's `values[b, idx, :C]` is copied exactly.
`geometry.group_points` takes this route for clouds above
`knn.MAX_POINTS`, and `knn.knn` takes it with C = 0 there.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from uni_adapter_torch.ops import build
from uni_adapter_torch.ops.knn import knn_plain

#: Most neighbours a query takes: four (distance, index) pairs per lane.
MAX_K = 128
#: Most value channels gathered.
MAX_CHANNELS = 8


def _values(xyz: torch.Tensor, values: Optional[torch.Tensor]):
    """`values` as (B, N, C) float32; None is C = 0."""
    if values is None:
        return xyz.new_empty((*xyz.shape[:2], 0), dtype=torch.float32)
    return values.to(torch.float32)


def knn_gather_plain(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
                     values: Optional[torch.Tensor] = None):
    """The plain version: `knn_plain`, then an exact gather.

    Returns (idx (B, S, k) int64, gathered (B, S, k, C) float32)."""
    values = _values(xyz, values)
    idx = knn_plain(k, xyz, new_xyz)
    B, S, _ = idx.shape
    C = values.shape[-1]
    flat = idx.reshape(B, S * k, 1).expand(-1, -1, C)
    return idx, torch.gather(values, 1, flat).reshape(B, S, k, C)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a library built from `csrc/knn_gather.cu`."""
    lib.uat_knn_gather.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.uat_knn_gather.restype = ctypes.c_int
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(build.load("knn_gather"))


def knn_gather_cuda(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
                    values: torch.Tensor):
    """Launch `csrc/knn_gather.cu` on contiguous float32 CUDA tensors:
    xyz (B, N, 3), new_xyz (B, S, 3), values (B, N, C) with C ≤ 8."""
    build.require_cuda(xyz, torch.float32, 3, "knn_gather xyz")
    build.require_cuda(new_xyz, torch.float32, 3, "knn_gather new_xyz")
    build.require_cuda(values, torch.float32, 3, "knn_gather values")
    B, N, Cx = xyz.shape
    Bq, S, Cq = new_xyz.shape
    Bv, Nv, C = values.shape
    if ((Cx, Cq) != (3, 3) or Bq != B or (Bv, Nv) != (B, N)
            or not xyz.device == new_xyz.device == values.device):
        raise ValueError(f"knn_gather: mismatched inputs {tuple(xyz.shape)}, "
                         f"{tuple(new_xyz.shape)}, {tuple(values.shape)}")
    if not 0 < k <= min(N, MAX_K) or C > MAX_CHANNELS:
        raise ValueError(f"knn_gather: unsupported k={k}, C={C} for N={N} "
                         f"(needs k ≤ min(N, {MAX_K}), C ≤ {MAX_CHANNELS})")
    build.require_no_grad("knn_gather", values)   # indices need no gradient
    idx = torch.empty(B, S, k, dtype=torch.int64, device=xyz.device)
    gathered = torch.empty(B, S, k, C, dtype=torch.float32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        rc = _lib().uat_knn_gather(
            xyz.data_ptr(), new_xyz.data_ptr(), values.data_ptr(),
            idx.data_ptr(), gathered.data_ptr(), B, N, S, k, C,
            build.stream_of(xyz))
    build.check(rc, "knn_gather")
    knn_gather.launches += 1
    return idx, gathered


def knn_gather(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
               values: Optional[torch.Tensor] = None):
    """k nearest neighbours of each query among `xyz`, and their values.

    Args:
      xyz: (B, N, 3) points; new_xyz: (B, S, 3) queries; values: (B, N, C)
        features to gather, C ≤ 8 (None: the indices alone).
    Returns:
      (idx (B, S, k) int64, gathered (B, S, k, C) float32).  CUDA tensors
      run the Hopper kernel, CPU tensors `knn_gather_plain`.
    """
    if xyz.is_cuda:
        return knn_gather_cuda(k, xyz.to(torch.float32).contiguous(),
                               new_xyz.to(torch.float32).contiguous(),
                               _values(xyz, values).contiguous())
    return knn_gather_plain(k, xyz, new_xyz, values)


knn_gather.launches = 0
