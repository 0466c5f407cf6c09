"""Farthest point sampling: the Hopper kernels `csrc/fps.cu` (a block
per cloud, up to MAX_POINTS points) and `csrc/fps_grid.cu` (a cluster of
blocks per cloud, any N), and their plain PyTorch version.

Replaces `uni_adapter_tpu/ops/fps_pallas.py::fps_pallas_batched` and
`fps_pallas`.  The contract is the Pallas kernels', not the XLA twin's
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

#: Largest cloud `csrc/fps.cu` takes (its largest size class: one block
#: of 8 warps × 16 points in registers, and a 16-byte-a-point copy of the
#: cloud in shared memory).  Larger clouds go to `csrc/fps_grid.cu`, as
#: fast or faster there (`scripts/fps_configs.py`).
MAX_POINTS = 4096


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


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument types of a built `csrc/fps.cu`."""
    lib.uat_fps.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.uat_fps.restype = ctypes.c_int
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(build.load("fps"))


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


def _bind_grid(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument types of a built `csrc/fps_grid.cu`."""
    lib.uat_fps_grid.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p]
    lib.uat_fps_grid.restype = ctypes.c_int
    lib.uat_fps_grid_register_points.argtypes = []
    lib.uat_fps_grid_register_points.restype = ctypes.c_int
    lib.uat_fps_grid_plan.argtypes = [ctypes.c_int] + [
        ctypes.POINTER(ctypes.c_int)] * 3
    lib.uat_fps_grid_plan.restype = ctypes.c_int
    return lib


@functools.cache
def _grid_lib() -> ctypes.CDLL:
    return _bind_grid(build.load("fps_grid"))


def fps_grid_register_points() -> int:
    """Largest N that `csrc/fps_grid.cu` holds in a cluster's registers;
    above it the running minimum lives in device memory."""
    return _grid_lib().uat_fps_grid_register_points()


def fps_grid_plan(N: int) -> tuple[int, int, int]:
    """The launch `csrc/fps_grid.cu` makes for an N-point cloud: (blocks in
    a cloud's cluster, threads a block, points a thread in registers, 0
    for the device-memory branch)."""
    got = [ctypes.c_int() for _ in range(3)]
    rc = _grid_lib().uat_fps_grid_plan(N, *map(ctypes.byref, got))
    build.check(rc, "fps_grid plan")
    return tuple(v.value for v in got)


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
    if N > fps_grid_register_points():
        scratch = torch.empty(B, N, dtype=torch.int32, device=xyz.device)
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
