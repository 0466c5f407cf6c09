"""ULIP-2's Point-BERT encoder (mirror of `uni_adapter_tpu/models/
pointbert.py`).

    (B, N, 3) xyz
      → group: FPS 512 centres + kNN-32, centre-relative xyz
        (ops/geometry.py, no color)
      → 3-channel mini-PointNet → reduce_dim → width 384
      → [CLS ‖ tokens]; 12 pre-norm ViT blocks, the positional embedding
        re-added before EVERY block (a Point-BERT idiosyncrasy, kept)
      → final LayerNorm → concat[CLS, max over tokens] (768-d)
      → @ pc_projection, an fp32 product → 512-d CLIP space
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from uni_adapter_torch.models.common import (LN, Dense, ViTBlock,
                                             finish_model)
from uni_adapter_torch.models.uni3d import MiniPointNet, PosEmbedMLP
from uni_adapter_torch.ops.geometry import group_points


class PointTransformer(nn.Module):
    """The Point-BERT trunk; returns concat[CLS, max over tokens]."""

    def __init__(self, trans_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, num_group: int = 512,
                 group_size: int = 32, encoder_dim: int = 256,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.num_group, self.group_size = num_group, group_size
        self.encoder = MiniPointNet(encoder_dim, in_channels=3, dtype=dtype)
        self.reduce_dim = Dense(encoder_dim, trans_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, trans_dim))
        self.cls_pos = nn.Parameter(torch.zeros(1, 1, trans_dim))
        self.pos_embed = PosEmbedMLP(trans_dim, dtype=dtype)
        self.blocks = nn.ModuleList(
            ViTBlock(trans_dim, num_heads) for _ in range(depth))
        self.norm = LN(trans_dim)

    def embed(self, pts: torch.Tensor):
        """The tokens [CLS ‖ groups] and the positions added at every
        block."""
        neighborhood, center, _ = group_points(pts, None, self.num_group,
                                               self.group_size)
        tokens = self.reduce_dim(self.encoder(neighborhood))
        B, _, W = tokens.shape
        x = torch.cat([self.cls_token.to(self.dtype).expand(B, 1, W), tokens],
                      dim=1)
        pos = torch.cat([self.cls_pos.to(self.dtype).expand(B, 1, W),
                         self.pos_embed(center)], dim=1)
        return x, pos

    def head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(x)
        return torch.cat([x[:, 0], x[:, 1:].amax(dim=1)], dim=-1)

    def forward(self, pts: torch.Tensor, return_attn: bool = False):
        """concat[CLS, max] features; with `return_attn` also every block's
        (B, H, N, N) fp32 attention map."""
        x, pos = self.embed(pts)
        maps = []
        for blk in self.blocks:
            x = blk(x + pos, return_attn=return_attn)   # pos at every block
            if return_attn:
                x, attn = x
                maps.append(attn)
        feat = self.head(x)
        return (feat, maps) if return_attn else feat

    def forward_parts(self, pts: torch.Tensor):
        """Parts: `forward`'s features, the blocks' collectives yielded."""
        x, pos = self.embed(pts)
        for blk in self.blocks:
            x = yield from blk.parts(x + pos)
        return self.head(x)


class ULIP(nn.Module):
    """Point-BERT features @ pc_projection, an fp32 product; takes (B, N, 3)
    xyz and returns (B, embed_dim) fp32 (with `return_attn`, and the
    blocks' attention maps)."""

    def __init__(self, trans_dim: int = 384, depth: int = 12,
                 num_heads: int = 6, num_group: int = 512,
                 group_size: int = 32, encoder_dim: int = 256,
                 embed_dim: int = 512, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.point_encoder = PointTransformer(trans_dim, depth, num_heads,
                                              num_group, group_size,
                                              encoder_dim, dtype=dtype)
        self.pc_projection = nn.Parameter(torch.zeros(2 * trans_dim,
                                                      embed_dim))

    def forward(self, pc: torch.Tensor, return_attn: bool = False):
        out = self.point_encoder(pc, return_attn=return_attn)
        feat, maps = out if return_attn else (out, None)
        proj = torch.matmul(feat.to(torch.float32), self.pc_projection)
        return (proj, maps) if return_attn else proj

    def forward_parts(self, pc: torch.Tensor):
        """Parts: `forward(pc)`, the trunk's collectives yielded."""
        feat = yield from self.point_encoder.forward_parts(pc)
        return torch.matmul(feat.to(torch.float32), self.pc_projection)


def create_ulip(cfg, device: torch.device | str,
                dtype: Optional[torch.dtype] = None, seed: int = 0,
                state_dict: Optional[dict] = None) -> ULIP:
    """Build ULIP-2 from a ModelConfig (`ulip_*` fields, `num_group`) on
    `device`, frozen, in eval mode.

    The weights are `state_dict` or random from `seed`, as
    `common.finish_model` draws them (cls_pos standard normal,
    pc_projection normal with std 0.02, cls_token zero); Dense layers are
    stored in the compute dtype, pc_projection stays fp32.
    """
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    with torch.device(device):
        model = ULIP(cfg.ulip_trans_dim, cfg.ulip_depth, cfg.ulip_heads,
                     cfg.num_group, cfg.ulip_group_size, cfg.ulip_encoder_dim,
                     cfg.ulip_embed_dim, dtype=dtype)

    def init_bare(gen: torch.Generator) -> None:
        nn.init.normal_(model.point_encoder.cls_pos, generator=gen)
        nn.init.normal_(model.pc_projection, std=0.02, generator=gen)

    return finish_model(model, device, dtype, seed, state_dict, init_bare)
