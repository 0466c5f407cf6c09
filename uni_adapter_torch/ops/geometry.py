"""Point-cloud grouping for the Uni3D encoder (mirror of
`uni_adapter_tpu/ops/geometry.py::group_points` on its kernel branches:
FPS centres from `fps_pallas_batched`, neighbourhoods from `knn_pallas`,
then an exact gather)."""
from __future__ import annotations

import torch

from uni_adapter_torch.ops.fps import farthest_point_sample
from uni_adapter_torch.ops.knn import knn


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Exact gather: points (B, N, C), idx (B, ...) -> (B, ..., C)."""
    B, _, C = points.shape
    flat = idx.reshape(B, -1, 1).expand(-1, -1, C)
    return torch.gather(points, 1, flat).reshape(*idx.shape, C)


def group_points(xyz: torch.Tensor, color: torch.Tensor, num_group: int,
                 group_size: int):
    """FPS centres + kNN neighbourhoods, centre-relative coordinates.

    Args:
      xyz: (B, N, 3); color: (B, N, 3).
    Returns:
      neighborhood (B, G, M, 3), center (B, G, 3), and features
      (B, G, M, 6) = [rel-xyz ‖ color].
    """
    fps_idx = farthest_point_sample(xyz, num_group)               # (B, G)
    center = index_points(xyz, fps_idx)                           # (B, G, 3)
    idx = knn(group_size, xyz, center)                            # (B, G, M)
    joined = index_points(torch.cat([xyz, color], dim=-1), idx)
    neighborhood = joined[..., :3] - center[:, :, None, :]
    features = torch.cat([neighborhood, joined[..., 3:]], dim=-1)
    return neighborhood, center, features
