"""OpenShape's PointPatchTransformer (PPTA) (mirror of
`uni_adapter_tpu/models/ppta.py`).

    (B, N, 3) xyz, (B, N, 6) xyz‖color
      → set abstraction: FPS `patches` centres + ball query (radius prad,
        nsamp points), rel-xyz ‖ xyz ‖ color, shared MLP [64, 64, sa_dim],
        max-pool                                  (ops/geometry.py)
      → lift Dense(3 + sa_dim → dim) + LayerNorm on centre ‖ features
      → [CLS ‖ tokens] → `depth` pre-norm ViT blocks (heads of width 64),
        with `rel_pe` each biased by `RelPE` of the centroid deltas
      → `cache_type` 'global': CLS → proj, an fp32 Dense to the CLIP text
        width (the TTA path); 'local': the k-means centres of the patch
        tokens → proj; 'hierarchical': both

The biased attention runs in plain PyTorch on the card too, as the JAX
package never sends it to a kernel; k-means is `utils/kmeans.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from uni_adapter_torch.models.common import (LN, BatchNormInference, Dense,
                                             Mlp, ViTAttention, finish_model)
from uni_adapter_torch.ops.geometry import sample_and_group
from uni_adapter_torch.utils import kmeans


#: Every preset's head width: attention runs at width 64·heads, which
#: need not be the model width.
DIM_HEAD = 64


@dataclasses.dataclass(frozen=True)
class PPTAPreset:
    dim: int
    depth: int
    heads: int
    mlp_dim: int
    sa_dim: int
    patches: int
    prad: float
    nsamp: int


#: The reference's scaling table: vit-L = scaling 3, vit-G = scaling 4.
PRESETS = {
    1: PPTAPreset(256, 6, 4, 1024, 96, 64, 0.4, 256),
    2: PPTAPreset(512, 6, 8, 1024, 128, 64, 0.4, 256),
    3: PPTAPreset(512, 12, 8, 1024, 128, 128, 0.35, 128),   # vit-L
    4: PPTAPreset(512, 12, 8, 512 * 3, 256, 384, 0.2, 64),  # vit-G
    5: PPTAPreset(768, 12, 12, 768 * 3, 256, 512, 0.2, 64),
    6: PPTAPreset(768, 24, 12, 768 * 4, 256, 512, 0.2, 64),
}


class SetAbstraction(nn.Module):
    """PointNet++ set abstraction, single scale: per-point Dense + BatchNorm
    + ReLU layers over each ball, then a max-pool over the ball."""

    def __init__(self, npoint: int, radius: float, nsample: int,
                 in_channels: int, mlp: tuple,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.dtype = dtype
        chans = (in_channels, *mlp)
        for i, (cin, cout) in enumerate(zip(chans, chans[1:])):
            self.add_module(f"conv{i}", Dense(cin, cout))
            self.add_module(f"bn{i}", BatchNormInference(cout))
        self.n_layers = len(mlp)

    def forward(self, xyz: torch.Tensor, points: torch.Tensor):
        new_xyz, new_points = sample_and_group(self.npoint, self.radius,
                                               self.nsample, xyz, points)
        x = new_points.to(self.dtype)                          # (B, S, n, C)
        for i in range(self.n_layers):
            x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x))
            x = torch.relu(x)
        return new_xyz, x.amax(dim=2)                   # (B, S, 3), (B, S, C')


class RelPE(nn.Module):
    """The relative position bias: Dense 3 → 64, ReLU, Dense 64 → 1 on the
    (B, N, N, 3) centroid deltas, in the compute dtype; returns the
    (B, 1, N, N) fp32 bias."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Dense(3, 64)
        self.fc2 = Dense(64, 1)

    def forward(self, centroid_delta: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.fc1(centroid_delta.to(self.dtype)))
        return self.fc2(x).permute(0, 3, 1, 2).to(torch.float32)


class PPTABlockPair(nn.Module):
    """Pre-norm attention (biased by `RelPE` with `rel_pe`) + pre-norm
    feed-forward."""

    def __init__(self, dim: int, heads: int, mlp_dim: int,
                 rel_pe: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.pe = RelPE(dtype) if rel_pe else None
        self.attn_norm = LN(dim)
        self.attn = ViTAttention(dim, heads, inner_dim=DIM_HEAD * heads)
        self.ff_norm = LN(dim)
        self.ff = Mlp(dim, mlp_dim)

    def forward(self, x: torch.Tensor, centroid_delta: torch.Tensor,
                return_attn: bool = False):
        bias = None if self.pe is None else self.pe(centroid_delta)
        a = self.attn(self.attn_norm(x), attn_bias=bias,
                      return_attn=return_attn)
        attn = None
        if return_attn:
            a, attn = a
        x = x + a
        x = x + self.ff(self.ff_norm(x))
        return (x, attn) if return_attn else x

    def parts(self, x: torch.Tensor, centroid_delta: torch.Tensor):
        """Parts: `forward`, with a tensor-parallel shard's two sums
        yielded."""
        bias = None if self.pe is None else self.pe(centroid_delta)
        x = x + (yield from self.attn.parts(self.attn_norm(x),
                                            attn_bias=bias))
        return x + (yield from self.ff.parts(self.ff_norm(x)))


class PointPatchTransformer(nn.Module):
    """The PPTA trunk: the CLS token out (and the patch tokens)."""

    def __init__(self, preset: PPTAPreset,
                 dtype: torch.dtype = torch.bfloat16, rel_pe: bool = False):
        super().__init__()
        p = preset
        self.dtype = dtype
        self.rel_pe = rel_pe
        # the set abstraction sees rel-xyz ‖ the per-point xyz ‖ color
        self.sa = SetAbstraction(p.patches, p.prad, p.nsamp, 3 + 6,
                                 (64, 64, p.sa_dim), dtype=dtype)
        self.lift = Dense(3 + p.sa_dim, p.dim)
        self.lift_norm = LN(p.dim)
        self.cls_token = nn.Parameter(torch.zeros(p.dim))
        self.layers = nn.ModuleList(
            PPTABlockPair(p.dim, p.heads, p.mlp_dim, rel_pe, dtype)
            for _ in range(p.depth))

    def forward(self, xyz: torch.Tensor, features: torch.Tensor,
                return_tokens: bool = False, return_attn: bool = False):
        """The CLS token, with `return_tokens` (CLS, patch tokens); with
        `return_attn` also every layer's (B, H, N, N) fp32 attention
        map."""
        x, delta = self.embed(xyz, features)
        maps = []
        for layer in self.layers:
            x = layer(x, delta, return_attn=return_attn)
            if return_attn:
                x, attn = x
                maps.append(attn)
        out = (x[:, 0], x[:, 1:]) if return_tokens else x[:, 0]
        return (out, maps) if return_attn else out

    def embed(self, xyz: torch.Tensor, features: torch.Tensor):
        """The tokens [CLS ‖ patches] and, with `rel_pe`, the (B, S+1, S+1,
        3) centroid deltas."""
        centroids, feat = self.sa(xyz, features)
        x = self.lift_norm(self.lift(
            torch.cat([centroids.to(self.dtype), feat], dim=-1)))
        B, _, W = x.shape
        x = torch.cat([self.cls_token.to(self.dtype).expand(B, 1, W), x],
                      dim=1)
        delta = None
        if self.rel_pe:
            # the CLS token's centroid is 0
            c = torch.cat([centroids.new_zeros(B, 1, 3), centroids], dim=1)
            delta = c[:, :, None, :] - c[:, None, :, :]  # (B, S+1, S+1, 3)
        return x, delta

    def forward_parts(self, xyz: torch.Tensor, features: torch.Tensor,
                      return_tokens: bool = False):
        """Parts: `forward`'s output, the layers' collectives yielded."""
        x, delta = self.embed(xyz, features)
        for layer in self.layers:
            x = yield from layer.parts(x, delta)
        return (x[:, 0], x[:, 1:]) if return_tokens else x[:, 0]


class Projected(nn.Module):
    """PPTA + the CLIP-space projection `proj`, an fp32 Dense.  Takes (xyz
    (B, N, 3), features (B, N, 6)).  `cache_type` 'global' returns the
    projected CLS token (B, out_channel), with `return_attn` also the
    layers' attention maps; 'local' the projected k-means centres of all
    B·S patch tokens together (n_cluster, out_channel); 'hierarchical'
    both."""

    def __init__(self, preset: PPTAPreset, out_channel: int = 1280,
                 dtype: torch.dtype = torch.bfloat16,
                 cache_type: str = "global", rel_pe: bool = False,
                 n_cluster: int = 5):
        super().__init__()
        self.cache_type, self.n_cluster = cache_type, n_cluster
        self.ppat = PointPatchTransformer(preset, dtype=dtype, rel_pe=rel_pe)
        self.proj = Dense(preset.dim, out_channel)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor,
                return_attn: bool = False):
        want_tokens = self.cache_type != "global"
        if return_attn and want_tokens:
            raise ValueError("return_attn is supported for "
                             "cache_type='global' (the TTA/extraction path)")
        out = self.ppat(xyz, features, return_tokens=want_tokens,
                        return_attn=return_attn)
        if return_attn:
            return self.proj(out[0].to(torch.float32)), out[1]
        return self._project(out)

    def forward_parts(self, xyz: torch.Tensor, features: torch.Tensor):
        """Parts: `forward(xyz, features)`, the trunk's collectives
        yielded."""
        out = yield from self.ppat.forward_parts(
            xyz, features, return_tokens=self.cache_type != "global")
        return self._project(out)

    def _project(self, out):
        """The CLIP-space output of the trunk's CLS token (and patch
        tokens) by `cache_type`."""
        if self.cache_type == "global":
            return self.proj(out.to(torch.float32))
        cls_token, patch_tokens = out
        centers = self.proj(kmeans.cluster_patches(
            patch_tokens.to(torch.float32), self.n_cluster))
        if self.cache_type == "local":
            return centers
        return self.proj(cls_token.to(torch.float32)), centers


def create_openshape(cfg, device: torch.device | str,
                     dtype: Optional[torch.dtype] = None, seed: int = 0,
                     state_dict: Optional[dict] = None,
                     preset: Optional[PPTAPreset] = None,
                     **kwargs) -> Projected:
    """Build OpenShape from a ModelConfig on `device`, frozen, in eval mode:
    `vitg14` → scaling 4 into the 1280-d bigG text space (`oshape_clip_dim`),
    `vitl14` → scaling 3 into the 768-d L text space.  `preset` replaces
    the scaling's (to cut depth or width); `kwargs` go to `Projected`
    (`cache_type`, `rel_pe`, `n_cluster`; the JAX package's
    `create_openshape` builds the defaults).

    The weights are `state_dict` or random from `seed`, as
    `common.finish_model` draws them (cls_token standard normal); Dense
    layers are stored in the compute dtype, except `proj`, which stays
    fp32 as in the JAX package.
    """
    dtype = dtype or getattr(torch, cfg.compute_dtype)
    vitg = cfg.oshape_version == "vitg14"
    preset = preset or PRESETS[4 if vitg else 3]
    with torch.device(device):
        model = Projected(preset, cfg.oshape_clip_dim if vitg else 768,
                          dtype=dtype, **kwargs)
    return finish_model(
        model, device, dtype, seed, state_dict,
        lambda gen: nn.init.normal_(model.ppat.cls_token, generator=gen),
        keep_fp32=(model.proj,))
