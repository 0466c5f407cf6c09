"""Logit fusion of the DOTA family and of the prototype cache (mirror of
`uni_adapter_tpu/adapt/fusion.py`)."""
from __future__ import annotations

import torch

from uni_adapter_torch.utils.math import entropy, softmax_entropy


def dota_fusion_weight(rho: float, eta: float, c_mean: torch.Tensor,
                       batch: float) -> torch.Tensor:
    """w = min(ρ·mean(c)/B, η); `batch` is the batch the fit consumed.
    S streams: `c_mean` is (S,), each stream's own mean over (K, M), and
    `batch` each stream's own B (not S·B)."""
    return torch.clamp(rho * c_mean / batch, max=eta)


def fuse_dota(clip_logits: torch.Tensor, dota_logits: torch.Tensor,
              weight: torch.Tensor) -> torch.Tensor:
    """Plain DOTA's fusion clip + w·dota (the reference's usage comment's;
    its own driver never assigns the result).  Logits ([S,] B, K),
    `weight` () or S streams' (S,)."""
    return clip_logits + weight[..., None, None] * dota_logits


def fuse_mode_dota(clip_logits: torch.Tensor, dota_logits: torch.Tensor,
                   weight: torch.Tensor,
                   fix_normalization: bool = False) -> torch.Tensor:
    """Inverse-entropy fusion.

    By default the reference's double normalisation is kept: w_clip is
    normalised first and w_dota then divides by the already-normalised
    w_clip, so the two weights do not sum to 1.  `fix_normalization`
    takes the convex combination instead.  Logits are ([S,] B, K), and
    `weight` is () or S streams' (S,).
    """
    scaled_dota = weight[..., None, None] * dota_logits
    w_clip = 1.0 / (softmax_entropy(clip_logits) + 1e-3)
    w_dota = 1.0 / (softmax_entropy(scaled_dota) + 1e-3)
    if fix_normalization:
        total = w_clip + w_dota
        w_clip, w_dota = w_clip / total, w_dota / total
    else:
        w_clip = w_clip / (w_clip + w_dota)
        w_dota = w_dota / (w_clip + w_dota)
    return w_clip[..., None] * clip_logits + w_dota[..., None] * scaled_dota


def fuse_cache(clip_logits: torch.Tensor, cache_logits: torch.Tensor,
               logit_scale: float = 100.0) -> torch.Tensor:
    """Cache-path fusion: (1/H₁)·softmax(clip/scale) + (1/H₂)·softmax(cache),
    each H the entropy of its softmaxed distribution (no epsilon).  The
    divisor undoes the scale that produced `clip_logits`.  ([S,] B, K)."""
    prob1 = torch.softmax(clip_logits / logit_scale, dim=-1)
    prob2 = torch.softmax(cache_logits, dim=-1)
    return ((1.0 / entropy(prob1))[..., None] * prob1
            + (1.0 / entropy(prob2))[..., None] * prob2)
