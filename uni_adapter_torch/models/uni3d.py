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
                                             EvaBlock, finish_model,
                                             gelu_exact)
from uni_adapter_torch.ops.geometry import group_points


class MiniPointNet(nn.Module):
    """Group-feature encoder: per-point MLP in_channels→128→256, group
    max-pool, concat, 512→512→encoder_channel, max-pool.  `in_channels` is
    6 for Uni3D's rel-xyz ‖ color groups, 3 for ULIP-2's rel-xyz."""

    def __init__(self, encoder_channel: int, in_channels: int = 6,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.in_channels = in_channels
        self.conv1 = Dense(in_channels, 128)
        self.bn1 = BatchNormInference(128)
        self.conv2 = Dense(128, 256)
        self.conv3 = Dense(512, 512)
        self.bn2 = BatchNormInference(512)
        self.conv4 = Dense(512, encoder_channel)

    def forward(self, point_groups: torch.Tensor) -> torch.Tensor:
        if point_groups.shape[-1] != self.in_channels:
            raise ValueError(f"MiniPointNet(in_channels={self.in_channels}) "
                             f"fed {point_groups.shape[-1]}-channel groups")
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
                 num_heads: int = 16, dtype: torch.dtype = torch.bfloat16,
                 quantize: bool = False):
        super().__init__()
        self.dtype = dtype
        self.num_group, self.group_size = num_group, group_size
        self.encoder = MiniPointNet(encoder_dim, dtype=dtype)
        self.encoder2trans = Dense(encoder_dim, trans_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, trans_dim))
        self.cls_pos = nn.Parameter(torch.zeros(1, 1, trans_dim))
        self.pos_embed = PosEmbedMLP(trans_dim, dtype=dtype)
        self.blocks = nn.ModuleList(
            EvaBlock(trans_dim, num_heads, quantize=quantize)
            for _ in range(depth))
        self.norm = LN(trans_dim)
        self.fc_norm = LN(trans_dim)
        self.trans2embed = Dense(trans_dim, embed_dim)

    def embed(self, xyz: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
        """The tokens the blocks take: [CLS ‖ groups] + positions."""
        _, center, features = group_points(xyz, color, self.num_group,
                                           self.group_size)
        tokens = self.encoder2trans(self.encoder(features))
        B, _, W = tokens.shape
        x = torch.cat([self.cls_token.to(self.dtype).expand(B, 1, W), tokens],
                      dim=1)
        pos = torch.cat([self.cls_pos.to(self.dtype).expand(B, 1, W),
                         self.pos_embed(center)], dim=1)
        return x + pos                 # added once, before the blocks

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return self.trans2embed(self.fc_norm(self.norm(x[:, 0, :])))

    def forward(self, xyz: torch.Tensor, color: torch.Tensor,
                return_attn: bool = False):
        """(B, embed) features; with `return_attn` also the (B, H, N, N)
        fp32 attention map of every block, in block order."""
        x = self.embed(xyz, color)
        maps = []
        for blk in self.blocks:
            x = blk(x, return_attn=return_attn)
            if return_attn:
                x, attn = x
                maps.append(attn)
        x = self.head(x)
        return (x, maps) if return_attn else x

    def forward_parts(self, xyz: torch.Tensor, color: torch.Tensor):
        """Parts: `forward`'s features, the blocks' collectives yielded
        (a tensor-parallel shard's, `models/common.py`)."""
        x = self.embed(xyz, color)
        for blk in self.blocks:
            x = yield from blk.parts(x)
        return self.head(x)


class Uni3D(nn.Module):
    """Splits (B, N, 6) into xyz and color and encodes; features in fp32
    (with `return_attn`, and the blocks' attention maps).  `quantize`:
    the EVA trunk's dense layers are int8 `QuantDense` (its attention then
    the JAX transposed branch, on the card `ops.attention_heads`)."""

    def __init__(self, trans_dim: int = 1024, embed_dim: int = 1024,
                 num_group: int = 512, group_size: int = 64,
                 encoder_dim: int = 512, depth: int = 24, num_heads: int = 16,
                 dtype: torch.dtype = torch.bfloat16, quantize: bool = False):
        super().__init__()
        self.point_encoder = PointcloudEncoder(
            trans_dim, embed_dim, num_group, group_size, encoder_dim, depth,
            num_heads, dtype=dtype, quantize=quantize)

    def forward(self, pc: torch.Tensor, return_attn: bool = False):
        out = self.point_encoder(pc[:, :, :3], pc[:, :, 3:],
                                 return_attn=return_attn)
        if return_attn:
            return out[0].to(torch.float32), out[1]
        return out.to(torch.float32)

    def forward_parts(self, pc: torch.Tensor):
        """Parts: `forward(pc)`, the trunk's collectives yielded."""
        out = yield from self.point_encoder.forward_parts(pc[:, :, :3],
                                                          pc[:, :, 3:])
        return out.to(torch.float32)


def create_uni3d(cfg, device: torch.device | str,
                 dtype: Optional[torch.dtype] = None, seed: int = 0,
                 state_dict: Optional[dict] = None,
                 trainable: bool = False) -> Uni3D:
    """Build Uni3D from a ModelConfig on `device`, frozen and in eval mode
    (with `trainable`, every parameter requiring grad: the trainer's fp32
    model).

    The weights are `state_dict` or random from `seed`, as
    `common.finish_model` draws them (cls_pos standard normal); every
    Dense layer is stored in the compute dtype (a `QuantDense` of the
    int8 trunk, `cfg.quantize_int8`, in fp32).
    """
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    with torch.device(device):
        model = Uni3D(cfg.pc_feat_dim, cfg.embed_dim, cfg.num_group,
                      cfg.group_size, cfg.pc_encoder_dim, cfg.eva_depth,
                      cfg.eva_heads, dtype=dtype,
                      quantize=cfg.quantize_int8)
    return finish_model(
        model, device, dtype, seed, state_dict,
        lambda gen: nn.init.normal_(model.point_encoder.cls_pos,
                                    generator=gen), trainable=trainable)
