"""PointNet++ multi-scale set abstraction and feature propagation (mirror
of `uni_adapter_tpu/ops/pointnet.py`; the single-scale abstraction is
`models/ppta.SetAbstraction`).

Each Conv(k=1) + BatchNorm stack is per-point `Dense` + `BatchNormInference`
+ ReLU, named as the flax tree (`conv{i}.{j}` / `bn{i}.{j}` for scale i,
layer j; `conv{j}` / `bn{j}`), so `weights.from_jax_params` maps the JAX
parameters, BatchNorm's running statistics included.  FPS and the ball
query are the Hopper kernels on CUDA tensors (`csrc/fps.cu` up to 4096
points, `csrc/fps_grid.cu` above; `csrc/ballquery.cu`) and their plain
versions on CPU tensors.  Unlike the PPTA's, these modules default to
fp32, as the JAX ones do.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from uni_adapter_torch.models.common import BatchNormInference, Dense
from uni_adapter_torch.ops.geometry import (farthest_point_sample,
                                            index_points, knn_point,
                                            query_ball_point,
                                            square_distance)


def _mlp_stack(x: torch.Tensor, convs, bns) -> torch.Tensor:
    for conv, bn in zip(convs, bns):
        x = torch.relu(bn(conv(x)))
    return x


class PointNetSetAbstractionMsg(nn.Module):
    """Multi-scale grouping: FPS centres once, a ball query at each radius,
    a shared MLP a scale, the max-pooled features of the scales joined.

    Args:
      in_channels: the width of `points` (0 when `points` is None).
    """

    def __init__(self, npoint: int, radius_list: Sequence[float],
                 nsample_list: Sequence[int], in_channels: int,
                 mlp_list: Sequence[Sequence[int]],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.npoint, self.dtype = npoint, dtype
        self.radius_list, self.nsample_list = radius_list, nsample_list
        for i, mlp in enumerate(mlp_list):
            chans = (in_channels + 3, *mlp)
            self.add_module(f"conv{i}", nn.ModuleList(
                Dense(a, b) for a, b in zip(chans, chans[1:])))
            self.add_module(f"bn{i}", nn.ModuleList(
                BatchNormInference(b) for b in mlp))

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor]):
        """xyz (B, N, 3), points (B, N, D) or None -> new_xyz (B, S, 3) and
        the joined features (B, S, Σ last widths)."""
        new_xyz = index_points(xyz, farthest_point_sample(xyz, self.npoint))
        outs = []
        for i, (radius, nsample) in enumerate(zip(self.radius_list,
                                                  self.nsample_list)):
            idx = query_ball_point(radius, nsample, xyz, new_xyz)
            grouped = index_points(xyz, idx) - new_xyz[:, :, None, :]
            if points is not None:
                grouped = torch.cat([index_points(points, idx), grouped],
                                    dim=-1)
            x = _mlp_stack(grouped.to(self.dtype), getattr(self, f"conv{i}"),
                           getattr(self, f"bn{i}"))
            outs.append(x.amax(dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


class PointNetFeaturePropagation(nn.Module):
    """Feature propagation: inverse-distance-weighted interpolation from
    the 3 nearest coarse points, joined to the skip features, then a
    shared MLP.

    Args:
      in_channels: the width of the joined input (skip + coarse).
    """

    def __init__(self, in_channels: int, mlp: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        chans = (in_channels, *mlp)
        for j, (a, b) in enumerate(zip(chans, chans[1:])):
            self.add_module(f"conv{j}", Dense(a, b))
            self.add_module(f"bn{j}", BatchNormInference(b))
        self.n_layers = len(mlp)

    def forward(self, xyz1: torch.Tensor, xyz2: torch.Tensor,
                points1: Optional[torch.Tensor],
                points2: torch.Tensor) -> torch.Tensor:
        """xyz1 (B, N, 3) fine, xyz2 (B, S, 3) coarse, points1 (B, N, D1)
        or None, points2 (B, S, D2) -> (B, N, last width)."""
        B, N, _ = xyz1.shape
        if xyz2.shape[1] == 1:
            interp = points2.expand(B, N, points2.shape[-1])
        else:
            idx3 = knn_point(3, xyz2, xyz1)                     # (B, N, 3)
            d3 = torch.gather(square_distance(xyz1, xyz2), -1, idx3)
            w = 1.0 / (d3 + 1e-8)
            w = w / w.sum(dim=2, keepdim=True)
            interp = (index_points(points2, idx3) * w[..., None]).sum(dim=2)
        x = interp if points1 is None else torch.cat([points1, interp],
                                                     dim=-1)
        return _mlp_stack(
            x.to(self.dtype),
            [getattr(self, f"conv{j}") for j in range(self.n_layers)],
            [getattr(self, f"bn{j}") for j in range(self.n_layers)])
