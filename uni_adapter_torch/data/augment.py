"""Point-cloud augmentation and cropping helpers (mirror of
`uni_adapter_tpu/data/augment.py`): seeded per-process generators,
directional cropping and the standard jitter / scale / translate /
rotate augmentations.

Each random function takes a `torch.Generator` and draws its random
tensor apart from the transform: the keyword (`center`, `noise`, `scale`,
`shift`, `theta`) that holds the draw, when given, replaces it, so a test
can hold the transform on the JAX package's draw (the two libraries'
generators give different numbers from one seed).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def worker_seed(base_seed: int, rank: int = 0,
                device="cpu") -> torch.Generator:
    """A deterministic generator for process `rank` of a run seeded with
    `base_seed` (the reference seeds each worker with seed + rank)."""
    seed = int(np.random.SeedSequence([base_seed, rank]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _normal(generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=like.device,
                       dtype=like.dtype)


def _uniform(generator, shape, like: torch.Tensor, lo: float,
             hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=like.device,
                   dtype=like.dtype)
    return lo + (hi - lo) * u


def separate_point_cloud(xyz: torch.Tensor, num_crop: int,
                         generator: Optional[torch.Generator] = None,
                         fixed_center: Optional[torch.Tensor] = None,
                         center: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split each cloud into (kept, cropped) around a direction: the
    `num_crop` points nearest it are cropped.  The direction is
    `fixed_center` for every cloud, else `center` (B, 1, 3) as drawn,
    else a standard normal draw from `generator`, normalised.

    Returns kept (B, N − num_crop, 3) and cropped (B, num_crop, 3)."""
    B = xyz.shape[0]
    if fixed_center is not None:
        center = fixed_center.reshape(1, 1, 3).expand(B, 1, 3)
    else:
        if center is None:
            center = _normal(generator, (B, 1, 3), xyz)
        center = center / (torch.linalg.vector_norm(center, dim=-1,
                                                    keepdim=True) + 1e-12)
    dist = torch.linalg.vector_norm(xyz - center, dim=-1)       # (B, N)
    order = torch.argsort(dist, dim=-1, stable=True)            # near → far

    def take(idx):
        return torch.take_along_dim(xyz, idx[..., None], dim=1)

    return take(order[:, num_crop:]), take(order[:, :num_crop])


def jitter_points(xyz: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  std: float = 0.01, clip: float = 0.05,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Clipped Gaussian jitter; `noise` is the standard normal draw."""
    if noise is None:
        noise = _normal(generator, xyz.shape, xyz)
    return xyz + torch.clamp(std * noise, -clip, clip)


def random_scale(xyz: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 lo: float = 0.8, hi: float = 1.25,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-cloud uniform scaling; `scale` (B, 1, 1) is the draw."""
    if scale is None:
        scale = _uniform(generator, (xyz.shape[0], 1, 1), xyz, lo, hi)
    return xyz * scale


def random_translate(xyz: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     shift: float = 0.1,
                     offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-cloud uniform translation; `offset` (B, 1, 3) is the draw."""
    if offset is None:
        offset = _uniform(generator, (xyz.shape[0], 1, 3), xyz, -shift,
                          shift)
    return xyz + offset


def random_rotate_z(xyz: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    theta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Random rotation about the gravity axis; `theta` (B,) is the draw,
    uniform in [0, 2π)."""
    if theta is None:
        theta = _uniform(generator, (xyz.shape[0],), xyz, 0.0, 2 * np.pi)
    c, s = torch.cos(theta), torch.sin(theta)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([c, -s, zeros, s, c, zeros, zeros, zeros, ones],
                      dim=-1).reshape(-1, 3, 3)
    return torch.einsum("bnc,bcd->bnd", xyz, rot)


def normalize_cloud(xyz: torch.Tensor) -> torch.Tensor:
    """Centre each cloud and scale it into the unit sphere."""
    centered = xyz - xyz.mean(dim=1, keepdim=True)
    scale = torch.linalg.vector_norm(centered, dim=-1, keepdim=True).amax(
        dim=1, keepdim=True)
    return centered / (scale + 1e-12)
