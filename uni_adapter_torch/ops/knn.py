"""k-nearest neighbours: the Hopper kernel `csrc/knn.cu` and its plain
PyTorch version.

Replaces `uni_adapter_tpu/ops/knn_pallas.py::knn_pallas`.  The distance
is the kernel's expansion d = (|q|² + |x|²) − 2·(q·x), every term in fp32
(the JAX kernel's cross term runs at `Precision.HIGHEST`; here neither
version uses a matrix product, so TF32 cannot enter), and the k nearest
come back in ascending distance with ties to the lowest index.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from uni_adapter_torch.ops import build

#: Largest cloud the kernel takes: 64 distances in registers per lane.
#: Larger clouds go to `csrc/knn_gather.cu`, which streams the cloud.
MAX_POINTS = 2048


def sqdist(xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """(B, S, N) squared distances in the kernel's order of operations."""
    q = new_xyz.to(torch.float32)
    x = xyz.to(torch.float32)
    qx, qy, qz = q[..., 0:1], q[..., 1:2], q[..., 2:3]          # (B, S, 1)
    xx, xy, xz = (x[..., i][:, None, :] for i in range(3))      # (B, 1, N)
    q2 = qx * qx + qy * qy + qz * qz
    x2 = xx * xx + xy * xy + xz * xz
    cross = qx * xx + qy * xy + qz * xz
    return (q2 + x2) - 2.0 * cross


def knn_plain(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """The plain version: (B, S, k) int64 indices, ascending distance.

    A stable sort keeps equal distances in index order (`torch.topk`
    promises no order on ties)."""
    return torch.sort(sqdist(xyz, new_xyz), dim=-1, stable=True).indices[..., :k]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a library built from `csrc/knn.cu`."""
    lib.uat_knn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_void_p]
    lib.uat_knn.restype = ctypes.c_int
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(build.load("knn"))


def knn_cuda(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/knn.cu` on contiguous float32 CUDA tensors."""
    build.require_cuda(xyz, torch.float32, 3, "knn xyz")
    build.require_cuda(new_xyz, torch.float32, 3, "knn new_xyz")
    B, N, C = xyz.shape
    Bq, S, Cq = new_xyz.shape
    if (C, Cq) != (3, 3) or Bq != B or xyz.device != new_xyz.device:
        raise ValueError(f"knn: mismatched inputs {tuple(xyz.shape)}, "
                         f"{tuple(new_xyz.shape)}")
    if not 0 < N <= MAX_POINTS or not 0 < k <= N:
        raise ValueError(f"knn: unsupported N={N}, k={k} (needs "
                         f"N ≤ {MAX_POINTS}, k ≤ N)")
    out = torch.empty(B, S, k, dtype=torch.int64, device=xyz.device)
    with torch.cuda.device(xyz.device):
        rc = _lib().uat_knn(xyz.data_ptr(), new_xyz.data_ptr(),
                            out.data_ptr(), B, N, S, k, build.stream_of(xyz))
    build.check(rc, "knn")
    knn.launches += 1
    return out


def knn(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """k nearest neighbours of each query among `xyz`.

    Args:
      xyz: (B, N, 3) points; new_xyz: (B, S, 3) queries.
    Returns:
      (B, S, k) int64 indices.  CUDA tensors run `csrc/knn.cu` up to
      MAX_POINTS points and `csrc/knn_gather.cu` (no values) above; CPU
      tensors run `knn_plain`.
    """
    if not xyz.is_cuda:
        return knn_plain(k, xyz, new_xyz)
    if xyz.shape[1] > MAX_POINTS:
        # knn_gather imports this module: imported here, not at the top
        from uni_adapter_torch.ops.knn_gather import knn_gather
        return knn_gather(k, xyz, new_xyz)[0]
    return knn_cuda(k, xyz.to(torch.float32).contiguous(),
                    new_xyz.to(torch.float32).contiguous())


knn.launches = 0
