"""K-means (Lloyd's algorithm) for OpenShape's `local` and `hierarchical`
cache types (mirror of `uni_adapter_tpu/utils/kmeans.py`).

Greedy farthest seeding from a first index, then a fixed 25 Lloyd
rounds, in fp32 with the squared distances expanded as |x|² + |c|² −
2·x·c (TF32 off, as the JAX package's `Precision.HIGHEST`).  Ties go to
the first index, as `jnp.argmin` / `jnp.argmax` take them.  The first
index is drawn from a CPU generator seeded 1 (the JAX package draws it
from its fixed PRNGKey(1)): the same features give the same centres at
every call and on either device.  The tests hand the port JAX's index.
JAX clusters all the tokens of a batch as one set, and so does the port.
"""
from __future__ import annotations

from typing import Optional

import torch


def _pairwise_sq(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return ((x * x).sum(dim=1)[:, None] + (c * c).sum(dim=1)[None, :]
            - 2.0 * torch.matmul(x, c.T))


def kmeans(features: torch.Tensor, n_clusters: int,
           first: Optional[int] = None, n_iter: int = 25):
    """Cluster (N, D) features into `n_clusters` centres.

    Args:
      first: the first seed's index; without it, drawn uniformly from a
        CPU generator seeded 1.
    Returns:
      centers (n_clusters, D) fp32 and the assignment (N,) int64.
    """
    x = features.to(torch.float32)
    n = x.shape[0]
    if first is None:
        first = int(torch.randint(
            n, (), generator=torch.Generator().manual_seed(1)))
    c = x[first]
    seeds = [c]
    dist = torch.full((n,), float("inf"), device=x.device)
    for _ in range(n_clusters - 1):
        dist = torch.minimum(dist, ((x - c[None]) ** 2).sum(dim=1))
        c = x[torch.argmax(dist)]
        seeds.append(c)
    centers = torch.stack(seeds)
    for _ in range(n_iter):
        assign = torch.argmin(_pairwise_sq(x, centers), dim=1)
        onehot = torch.nn.functional.one_hot(assign, n_clusters).to(x.dtype)
        counts = onehot.sum(dim=0)
        sums = torch.matmul(onehot.T, x)
        centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp(counts, min=1.0)[:, None],
                              centers)
    return centers, torch.argmin(_pairwise_sq(x, centers), dim=1)


def cluster_patches(local_patches: torch.Tensor, n_cluster: int,
                    first: Optional[int] = None) -> torch.Tensor:
    """Patch tokens (..., D), all of them as one set, -> (n_cluster, D)
    centres."""
    x = local_patches.reshape(-1, local_patches.shape[-1])
    return kmeans(x, n_cluster, first=first)[0]
