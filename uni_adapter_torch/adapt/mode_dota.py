"""MODE-DOTA: streaming per-class diagonal Gaussian mixture (mirror of
`uni_adapter_tpu/adapt/mode_dota.py`).

Every contraction is fp32 without TF32 (the JAX package runs them at
`Precision.HIGHEST`); the entry points turn TF32 off for the process.

Every function but `init` also takes S independent streams at once (the
JAX package's `jax.vmap` over the state): a leading stream axis on every
tensor of the state and on `x` and `gamma_class`, written out as batched
`torch.matmul` products.  S streams' `init` is S single-stream ones
stacked (`engine.init_states_streams`): the init draws no randomness.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_VAR_FLOOR = 1e-8


class ModeDotaState(NamedTuple):
    """One stream's mixture; S streams' carry a leading (S,) axis on each
    tensor but the count `t`, which has one only where the streams'
    counts differ."""
    mu: torch.Tensor            # ([S,] K, M, D) mode means
    var: torch.Tensor           # ([S,] K, M, D) diagonal variances
    pi: torch.Tensor            # ([S,] K, M) mixture weights
    c: torch.Tensor             # ([S,] K, M) soft counts
    class_counts: torch.Tensor  # ([S,] K)
    t: torch.Tensor             # () or ([S],) int32: samples seen


def resolve_sigma_init(sigma_cfg: float, input_dim: int) -> float:
    """A config sigma ≥ 0.1 is read as a full-covariance-scale mistake and
    replaced by 1/D (the per-dimension variance of unit-norm embeddings)."""
    return 1.0 / input_dim if sigma_cfg >= 0.1 else sigma_cfg


def init(epsilon: float, sigma: float, input_dim: int, num_classes: int,
         clip_weights: torch.Tensor, num_modes: int = 4) -> ModeDotaState:
    """Initialise the mixture.

    Args:
      clip_weights: (D, K) L2-normalised text anchors.

    Means = class centre + an offset δ·(m+1) along axis m % D with
    δ = 0.1·sigma_init; variances sigma_init·(1 + 0.05·m); π uniform;
    soft counts 1/M.
    """
    del epsilon
    K, M, D = num_classes, num_modes, input_dim
    dev = clip_weights.device
    sigma_init = resolve_sigma_init(sigma, D)
    centers = clip_weights.T.to(torch.float32)                  # (K, D)
    mode_ids = torch.arange(M, device=dev)
    offsets = torch.zeros(M, D, device=dev)
    offsets[mode_ids, mode_ids % D] = sigma_init * 0.1 * (mode_ids + 1.0)
    mu = centers[:, None, :] + offsets[None, :, :]
    scale_m = 1.0 + 0.05 * torch.arange(M, dtype=torch.float32, device=dev)
    var = torch.clamp(torch.full((K, M, D), sigma_init, device=dev)
                      * scale_m[None, :, None], min=_VAR_FLOOR)
    return ModeDotaState(
        mu=mu, var=var,
        pi=torch.full((K, M), 1.0 / M, device=dev),
        c=torch.full((K, M), 1.0 / M, device=dev),
        class_counts=torch.zeros(K, device=dev),
        t=torch.zeros((), dtype=torch.int32, device=dev))


def regularized_var(state: ModeDotaState, epsilon: float) -> torch.Tensor:
    """var + ε, floored."""
    return torch.clamp(state.var + epsilon, min=_VAR_FLOOR)


def log_likelihood(x: torch.Tensor, mu: torch.Tensor,
                   var: torch.Tensor) -> torch.Tensor:
    """Diagonal Gaussian log-likelihood without the D·log 2π constant,
    through the two-matmul expansion
        Σ_d (x−μ)²/v = Σ_d x²·(1/v) − 2·Σ_d x·(μ/v) + Σ_d μ²/v.

    Args:
      x: ([S,] B, D); mu, var: ([S,] K, M, D).
    Returns:
      ([S,] B, K, M).
    """
    *lead, K, M, D = mu.shape
    x = x.to(torch.float32)
    inv_v = (1.0 / var).reshape(*lead, K * M, D)
    mu_over_v = (mu / var).reshape(*lead, K * M, D)
    quad_const = torch.sum(mu * mu / var, dim=-1)                # ([S,] K, M)
    log_det = torch.sum(torch.log(var), dim=-1)
    x_sq_term = torch.matmul(x * x, inv_v.transpose(-1, -2))     # (.., B, KM)
    cross_term = torch.matmul(x, mu_over_v.transpose(-1, -2))
    maha = ((x_sq_term - 2.0 * cross_term).reshape(*x_sq_term.shape[:-1], K, M)
            + quad_const[..., None, :, :])
    return -0.5 * (log_det[..., None, :, :] + maha)


def fit_stats(state: ModeDotaState, x: torch.Tensor,
              gamma_class: torch.Tensor, epsilon: float) -> tuple:
    """The E-step and the batch's additive sufficient statistics (Σγ, Σγx,
    Σγx², the class sums): what a data-parallel step sums over its ranks
    before `fit_merge`."""
    x = x.to(torch.float32)
    gamma_class = gamma_class.to(torch.float32)
    *lead, K, M, D = state.mu.shape
    log_lik = log_likelihood(x, state.mu, regularized_var(state, epsilon))
    log_joint = torch.log(state.pi + 1e-10)[..., None, :, :] + log_lik
    log_r = log_joint - torch.logsumexp(log_joint, dim=-1, keepdim=True)
    gamma = gamma_class[..., None] * torch.exp(log_r)            # (.., B, K, M)
    sum_gamma = gamma.sum(dim=-3)                                # ([S,] K, M)
    gamma_perm = gamma.movedim(-3, -1).reshape(*lead, K * M, -1)  # (.., KM, B)
    weighted_x = torch.matmul(gamma_perm, x).reshape(*lead, K, M, D)
    weighted_x_sq = torch.matmul(gamma_perm, x * x).reshape(*lead, K, M, D)
    return sum_gamma, weighted_x, weighted_x_sq, gamma_class.sum(dim=-2)


def fit_merge(state: ModeDotaState, stats: tuple, n: int) -> ModeDotaState:
    """The streaming M-step on `fit_stats`'s statistics of `n` samples."""
    sum_gamma, weighted_x, weighted_x_sq, class_sum = stats
    c_new = state.c + sum_gamma
    mu_new = (state.c[..., None] * state.mu + weighted_x) / (
        c_new[..., None] + 1e-10)
    # Σ_b γ (x−μ_old)² = Σγx² − 2μ_old·Σγx + Σγ·μ_old²
    wsq = (weighted_x_sq - 2.0 * state.mu * weighted_x
           + sum_gamma[..., None] * state.mu ** 2)
    var = torch.clamp((state.c[..., None] * state.var + wsq)
                      / (c_new[..., None] + 1e-10), min=_VAR_FLOOR)
    pi_new = c_new / (c_new.sum(dim=-1, keepdim=True) + 1e-10)
    return ModeDotaState(mu=mu_new, var=var, pi=pi_new, c=c_new,
                         class_counts=state.class_counts + class_sum,
                         t=state.t + n)


def fit(state: ModeDotaState, x: torch.Tensor, gamma_class: torch.Tensor,
        epsilon: float) -> ModeDotaState:
    """One streaming EM step.

    Args:
      x: ([S,] B, D) L2-normalised features; gamma_class: ([S,] B, K)
        zero-shot class probabilities.
    """
    return fit_merge(state, fit_stats(state, x, gamma_class, epsilon),
                     x.shape[-2])


def predict(state: ModeDotaState, x: torch.Tensor,
            epsilon: float) -> torch.Tensor:
    """Class scores log P(x|k) = logsumexp_m[log π + log lik], ([S,] B, K)."""
    log_lik = log_likelihood(x, state.mu, regularized_var(state, epsilon))
    return torch.logsumexp(torch.log(state.pi + 1e-10)[..., None, :, :]
                           + log_lik, dim=-1)
