"""Point-cloud grouping (mirror of `uni_adapter_tpu/ops/geometry.py` on its
kernel branches: FPS centres from `fps_pallas_batched`, neighbourhoods from
`knn_pallas` or `query_ball_pallas` then an exact gather, or from
`knn_gather_pallas` with the gather fused).

The cloud's size picks the kernel: `group_points` takes `knn` + gather up
to `knn.MAX_POINTS` points and one `knn_gather` launch above, and FPS picks
its own kernel the same way (`fps.farthest_point_sample`).  The two routes
give bitwise-identical outputs, as the JAX package's two routes do.

The JAX package's XLA twins that `ops/pointnet.py` uses are here under
their names: `square_distance` and `knn_point` (plain PyTorch, fp32),
`index_points_matmul` (its one-hot product is an exact gather:
`index_points`), `farthest_point_sample` and `query_ball_point` (the FPS
and ball-query kernels on the card, their plain versions on the CPU)."""
from __future__ import annotations

from typing import Optional

import torch

from uni_adapter_torch.ops.ballquery import query_ball
from uni_adapter_torch.ops.fps import farthest_point_sample
from uni_adapter_torch.ops.knn import MAX_POINTS, knn
from uni_adapter_torch.ops.knn_gather import knn_gather

#: The ball query under the JAX twin's name.
query_ball_point = query_ball


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Exact gather: points (B, N, C), idx (B, ...) -> (B, ..., C)."""
    B, _, C = points.shape
    flat = idx.reshape(B, -1, 1).expand(-1, -1, C)
    return torch.gather(points, 1, flat).reshape(*idx.shape, C)


#: The JAX twin's one-hot product gathers exactly: the same values.
index_points_matmul = index_points


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances |s|² + |d|² − 2·s·d in fp32: src
    (B, N, C), dst (B, M, C) -> (B, N, M)."""
    src, dst = src.to(torch.float32), dst.to(torch.float32)
    cross = torch.matmul(src, dst.transpose(1, 2))
    return ((src ** 2).sum(dim=-1)[:, :, None]
            + (dst ** 2).sum(dim=-1)[:, None, :] - 2.0 * cross)


def knn_point(k: int, xyz: torch.Tensor,
              new_xyz: torch.Tensor) -> torch.Tensor:
    """The k nearest points of `xyz` (B, N, C) to each query of `new_xyz`
    (B, S, C), nearest first, ties to the lower index (as `lax.top_k`):
    (B, S, k) int64."""
    sqd = square_distance(new_xyz, xyz)
    return torch.sort(sqd, dim=-1, stable=True).indices[..., :k]


def group_points(xyz: torch.Tensor, color: Optional[torch.Tensor],
                 num_group: int, group_size: int):
    """FPS centres + kNN neighbourhoods, centre-relative coordinates (the
    Uni3D grouping with color, ULIP-2's without).

    Args:
      xyz: (B, N, 3); color: (B, N, 3) or None.
    Returns:
      neighborhood (B, G, M, 3), center (B, G, 3), and features
      (B, G, M, 6) = [rel-xyz ‖ color], or None without color.
    """
    fps_idx = farthest_point_sample(xyz, num_group)               # (B, G)
    center = index_points(xyz, fps_idx)                           # (B, G, 3)
    values = xyz if color is None else torch.cat([xyz, color], dim=-1)
    if xyz.shape[1] > MAX_POINTS:
        _, joined = knn_gather(group_size, xyz, center, values)
    else:
        joined = index_points(values, knn(group_size, xyz, center))
    neighborhood = joined[..., :3] - center[:, :, None, :]        # (B, G, M, 3)
    if color is None:
        return neighborhood, center, None
    features = torch.cat([neighborhood, joined[..., 3:]], dim=-1)
    return neighborhood, center, features


def sample_and_group(npoint: int, radius: float, nsample: int,
                     xyz: torch.Tensor, points: torch.Tensor):
    """PointNet++ set-abstraction grouping: FPS centres + ball query.

    Args:
      xyz: (B, N, 3); points: (B, N, D) per-point features.
    Returns:
      new_xyz (B, npoint, 3) centres, and new_points (B, npoint, nsample,
      3 + D) = [rel-xyz ‖ points].
    """
    new_xyz = index_points(xyz, farthest_point_sample(xyz, npoint))
    idx = query_ball(radius, nsample, xyz, new_xyz)
    joined = index_points(torch.cat([xyz, points], dim=-1), idx)
    grouped_xyz = joined[..., :3] - new_xyz[:, :, None, :]
    return new_xyz, torch.cat([grouped_xyz, joined[..., 3:]], dim=-1)
