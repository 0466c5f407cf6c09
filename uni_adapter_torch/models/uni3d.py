"""Uni3D: point-cloud encoder with an EVA02 trunk (mirror of
`uni_adapter_tpu/models/uni3d.py`).

    (B, N, 6) xyz‖color
      → group: FPS centres + kNN neighbourhoods (ops/geometry.py)
      → mini-PointNet per group → encoder2trans
      → [CLS ‖ tokens] + [cls_pos ‖ pos-embed MLP(centres)], added once
      → EVA02 blocks → norm(CLS) → fc_norm → trans2embed → (B, embed) fp32
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from uni_adapter_torch.models.common import (LN, BatchNormInference, Dense,
                                             EvaBlock, gelu_exact)
from uni_adapter_torch.ops.geometry import group_points


class MiniPointNet(nn.Module):
    """Group-feature encoder: per-point MLP 6→128→256, group max-pool,
    concat, 512→512→encoder_channel, max-pool."""

    def __init__(self, encoder_channel: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Dense(6, 128)
        self.bn1 = BatchNormInference(128)
        self.conv2 = Dense(128, 256)
        self.conv3 = Dense(512, 512)
        self.bn2 = BatchNormInference(512)
        self.conv4 = Dense(512, encoder_channel)

    def forward(self, point_groups: torch.Tensor) -> torch.Tensor:
        if point_groups.shape[-1] != 6:
            raise ValueError(f"MiniPointNet takes xyz‖color groups, got "
                             f"{point_groups.shape[-1]} channels")
        x = point_groups.to(self.dtype)
        x = torch.relu(self.bn1(self.conv1(x)))
        x = self.conv2(x)                                     # (B, G, M, 256)
        g = x.amax(dim=2, keepdim=True)
        x = torch.cat([g.expand_as(x), x], dim=-1)
        x = torch.relu(self.bn2(self.conv3(x)))
        return self.conv4(x).amax(dim=2)                      # (B, G, C')


class PosEmbedMLP(nn.Module):
    """3 → 128 → width GELU MLP on the group centres."""

    def __init__(self, width: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Dense(3, 128)
        self.fc2 = Dense(128, width)

    def forward(self, center: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_exact(self.fc1(center.to(self.dtype))))


class PointcloudEncoder(nn.Module):
    """Uni3D point encoder."""

    def __init__(self, trans_dim: int = 1024, embed_dim: int = 1024,
                 num_group: int = 512, group_size: int = 64,
                 encoder_dim: int = 512, depth: int = 24,
                 num_heads: int = 16, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.num_group, self.group_size = num_group, group_size
        self.encoder = MiniPointNet(encoder_dim, dtype=dtype)
        self.encoder2trans = Dense(encoder_dim, trans_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, trans_dim))
        self.cls_pos = nn.Parameter(torch.zeros(1, 1, trans_dim))
        self.pos_embed = PosEmbedMLP(trans_dim, dtype=dtype)
        self.blocks = nn.ModuleList(
            EvaBlock(trans_dim, num_heads) for _ in range(depth))
        self.norm = LN(trans_dim)
        self.fc_norm = LN(trans_dim)
        self.trans2embed = Dense(trans_dim, embed_dim)

    def forward(self, xyz: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
        _, center, features = group_points(xyz, color, self.num_group,
                                           self.group_size)
        tokens = self.encoder2trans(self.encoder(features))
        B, _, W = tokens.shape
        x = torch.cat([self.cls_token.to(self.dtype).expand(B, 1, W), tokens],
                      dim=1)
        pos = torch.cat([self.cls_pos.to(self.dtype).expand(B, 1, W),
                         self.pos_embed(center)], dim=1)
        x = x + pos                    # added once, before the blocks
        for blk in self.blocks:
            x = blk(x)
        x = self.fc_norm(self.norm(x[:, 0, :]))
        return self.trans2embed(x)


class Uni3D(nn.Module):
    """Splits (B, N, 6) into xyz and color and encodes; features in fp32."""

    def __init__(self, trans_dim: int = 1024, embed_dim: int = 1024,
                 num_group: int = 512, group_size: int = 64,
                 encoder_dim: int = 512, depth: int = 24, num_heads: int = 16,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.point_encoder = PointcloudEncoder(
            trans_dim, embed_dim, num_group, group_size, encoder_dim, depth,
            num_heads, dtype=dtype)

    def forward(self, pc: torch.Tensor) -> torch.Tensor:
        return self.point_encoder(pc[:, :, :3], pc[:, :, 3:]).to(torch.float32)


def create_uni3d(cfg, device: torch.device | str,
                 dtype: Optional[torch.dtype] = None, seed: int = 0,
                 state_dict: Optional[dict] = None) -> Uni3D:
    """Build Uni3D from a ModelConfig on `device`, frozen and in eval mode.

    The weights are `state_dict` (e.g. from `weights.from_jax_params`) or,
    without one, random from `seed`: dense kernels lecun-normal as flax
    draws them, cls_pos standard normal, the rest at the flax defaults.
    Dense layers are stored in the compute dtype; LayerNorm and BatchNorm
    parameters stay fp32.
    """
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    with torch.device(device):
        model = Uni3D(cfg.pc_feat_dim, cfg.embed_dim, cfg.num_group,
                      cfg.group_size, cfg.pc_encoder_dim, cfg.eva_depth,
                      cfg.eva_heads, dtype=dtype)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        for m in model.modules():
            if isinstance(m, Dense):
                m.reset_parameters(gen)
        nn.init.normal_(model.point_encoder.cls_pos, generator=gen)
    for m in model.modules():
        if isinstance(m, Dense):
            m.to(dtype)
    return model.eval().requires_grad_(False)
