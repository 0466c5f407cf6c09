"""Ball query: the Hopper kernel `csrc/ballquery.cu` and its plain PyTorch
version.

Replaces `uni_adapter_tpu/ops/ballquery_pallas.py::query_ball_pallas`.
The distance is `knn.sqdist`'s expansion d = (|q|² + |x|²) − 2·(q·x) in
fp32; a point is in the ball when d ≤ r², with r² rounded to fp32 as the
Pallas kernel takes it.  Each query gets the first `nsample` in-ball
indices in ascending index order (the reference sorts indices, not
distances); unfilled slots take the first in-ball index, and an empty
ball gives N−1 in every slot.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from uni_adapter_torch.ops import build
from uni_adapter_torch.ops.knn import sqdist


@functools.cache
def squared_radius(radius: float) -> float:
    """r² in fp32, as the Pallas kernel holds it (kept per radius: the
    wrapper asks for it at every launch)."""
    return torch.tensor(float(radius) * float(radius),
                        dtype=torch.float32).item()


def query_ball_plain(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """The plain version: (B, S, nsample) int64 indices."""
    N = xyz.shape[1]
    d = sqdist(xyz, new_xyz)                                    # (B, S, N)
    lane = torch.arange(N, device=xyz.device).expand_as(d)
    key = torch.where(d <= squared_radius(radius), lane, N)
    idx = torch.sort(key, dim=-1).values[..., :nsample]
    idx = torch.where(idx == N, idx[..., :1], idx)
    return torch.clamp(idx, max=N - 1)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a library built from `csrc/ballquery.cu`."""
    lib.uat_ballquery.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]
    lib.uat_ballquery.restype = ctypes.c_int
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(build.load("ballquery"))


def query_ball_cuda(radius: float, nsample: int, xyz: torch.Tensor,
                    new_xyz: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/ballquery.cu` on contiguous float32 CUDA tensors."""
    build.require_cuda(xyz, torch.float32, 3, "ballquery xyz")
    build.require_cuda(new_xyz, torch.float32, 3, "ballquery new_xyz")
    B, N, C = xyz.shape
    Bq, S, Cq = new_xyz.shape
    if (C, Cq) != (3, 3) or Bq != B or xyz.device != new_xyz.device:
        raise ValueError(f"ballquery: mismatched inputs {tuple(xyz.shape)}, "
                         f"{tuple(new_xyz.shape)}")
    if not 0 < nsample <= N or S == 0:
        raise ValueError(f"ballquery: unsupported nsample={nsample} for "
                         f"N={N}, S={S} (needs 0 < nsample ≤ N, S > 0)")
    out = torch.empty(B, S, nsample, dtype=torch.int64, device=xyz.device)
    with torch.cuda.device(xyz.device):
        rc = _lib().uat_ballquery(xyz.data_ptr(), new_xyz.data_ptr(),
                                  out.data_ptr(), B, N, S, nsample,
                                  squared_radius(radius),
                                  build.stream_of(xyz))
    build.check(rc, "ballquery")
    query_ball.launches += 1
    return out


def query_ball(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """Up to `nsample` points of `xyz` within `radius` of each query.

    Args:
      xyz: (B, N, 3) points; new_xyz: (B, S, 3) queries.
    Returns:
      (B, S, nsample) int64 indices.  CUDA tensors run the Hopper kernel,
      CPU tensors `query_ball_plain`.
    """
    if xyz.is_cuda:
        return query_ball_cuda(radius, nsample,
                               xyz.to(torch.float32).contiguous(),
                               new_xyz.to(torch.float32).contiguous())
    return query_ball_plain(radius, nsample, xyz, new_xyz)


query_ball.launches = 0
