"""Farthest point sampling: the Hopper kernel `csrc/fps.cu` and its plain
PyTorch version.

Replaces `uni_adapter_tpu/ops/fps_pallas.py::fps_pallas_batched`.  The
contract is the Pallas kernel's, not the XLA twin's
(`geometry.farthest_point_sample`): the first centre is index 0, the
running minimum distance uses the direct form (x−cx)² + (y−cy)² + (z−cz)²
summed left to right, and the next centre is the first index attaining
the maximum.  The XLA twin expands |x|² − 2x·c + |c|², whose chain can
part from the kernel's on near-ties; the port follows the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from uni_adapter_torch.ops import build

#: Largest cloud `csrc/fps.cu` takes: 256 threads × 32 points in
#: registers.  Larger clouds go to `csrc/fps_grid.cu`.
MAX_POINTS = 8192


def fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """The plain version: (B, N, 3) float32 -> (B, npoint) int64 indices."""
    B, N, _ = xyz.shape
    xyz = xyz.to(torch.float32)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rows = torch.arange(B, device=xyz.device)
    dist = torch.full((B, N), float("inf"), device=xyz.device)
    farthest = torch.zeros(B, dtype=torch.int64, device=xyz.device)
    out = torch.empty(B, npoint, dtype=torch.int64, device=xyz.device)
    for i in range(npoint):
        out[:, i] = farthest
        c = xyz[rows, farthest]                                 # (B, 3)
        d = ((x - c[:, 0:1]) ** 2 + (y - c[:, 1:2]) ** 2
             + (z - c[:, 2:3]) ** 2)
        dist = torch.minimum(dist, d)
        farthest = torch.argmax(dist, dim=1)    # first max, as jnp.argmax
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("fps")
    lib.uat_fps.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.uat_fps.restype = ctypes.c_int
    return lib


def fps_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Launch `csrc/fps.cu` on a contiguous (B, N, 3) float32 CUDA tensor."""
    build.require_cuda(xyz, torch.float32, 3, "fps xyz")
    B, N, C = xyz.shape
    if C != 3 or not 0 < N <= MAX_POINTS or not 0 < npoint <= N:
        raise ValueError(f"fps: unsupported shape {tuple(xyz.shape)} → "
                         f"{npoint} (needs C=3, N ≤ {MAX_POINTS}, "
                         f"npoint ≤ N)")
    out = torch.empty(B, npoint, dtype=torch.int64, device=xyz.device)
    with torch.cuda.device(xyz.device):
        rc = _lib().uat_fps(xyz.data_ptr(), out.data_ptr(), B, N, npoint,
                            build.stream_of(xyz))
    build.check(rc, "fps")
    farthest_point_sample.launches += 1
    return out


@functools.cache
def _grid_lib() -> ctypes.CDLL:
    lib = build.load("fps_grid")
    lib.uat_fps_grid.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p]
    lib.uat_fps_grid.restype = ctypes.c_int
    lib.uat_fps_grid_shared_points.argtypes = []
    lib.uat_fps_grid_shared_points.restype = ctypes.c_int
    return lib


def fps_grid_shared_points(device: torch.device) -> int:
    """Largest N that `csrc/fps_grid.cu` holds in shared memory on
    `device`; above it the running minimum lives in device memory."""
    with torch.cuda.device(device):
        return _grid_lib().uat_fps_grid_shared_points()


def fps_grid_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Launch `csrc/fps_grid.cu` (any N) on a contiguous (B, N, 3) float32
    CUDA tensor."""
    build.require_cuda(xyz, torch.float32, 3, "fps_grid xyz")
    B, N, C = xyz.shape
    if C != 3 or not 0 < npoint <= N:
        raise ValueError(f"fps_grid: unsupported shape {tuple(xyz.shape)} → "
                         f"{npoint} (needs C=3, npoint ≤ N)")
    out = torch.empty(B, npoint, dtype=torch.int64, device=xyz.device)
    scratch = None
    if N > fps_grid_shared_points(xyz.device):
        scratch = torch.empty(B, N, dtype=torch.float32, device=xyz.device)
    with torch.cuda.device(xyz.device):
        rc = _grid_lib().uat_fps_grid(
            xyz.data_ptr(), None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), B, N, npoint, build.stream_of(xyz))
    build.check(rc, "fps_grid")
    fps_grid_cuda.launches += 1
    return out


fps_grid_cuda.launches = 0


def farthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) points -> (B, npoint) int64 centre indices.

    A CUDA tensor runs `csrc/fps.cu` up to MAX_POINTS points and
    `csrc/fps_grid.cu` above; a CPU tensor runs `fps_plain`.
    """
    if not xyz.is_cuda:
        return fps_plain(xyz, npoint)
    xyz = xyz.to(torch.float32).contiguous()
    if xyz.shape[1] > MAX_POINTS:
        return fps_grid_cuda(xyz, npoint)
    return fps_cuda(xyz, npoint)


farthest_point_sample.launches = 0
