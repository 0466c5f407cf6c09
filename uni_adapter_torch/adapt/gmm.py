"""GMM-DOTA: per-class diagonal Gaussian mixtures with a QR-orthonormal
init (mirror of `uni_adapter_tpu/adapt/gmm.py`).

What sets it apart from MODE-DOTA: the means start at the class centre
plus a small orthonormal perturbation, the covariance update uses the
old means, `update` shrinks the covariance toward ones, and `predict`
blends an empirical class prior with the uniform one.

Every function but `init` also takes S independent streams at once: a
leading stream axis on every tensor of the state, and on `x` and `y`.
The sample count `total_samples` is () while the streams agree on it and
([S],) when they do not.  The
init's draw comes from an explicit generator; the JAX package's comes
from a PRNG key, so the tests hand the port JAX's initial state.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from uni_adapter_torch.adapt.mode_dota import resolve_sigma_init

_FLOOR = 1e-8


class GMMDotaState(NamedTuple):
    """One stream's mixture; S streams' carry a leading (S,) axis on each
    tensor but `total_samples`, which has one only where the streams'
    counts differ."""
    mu: torch.Tensor             # ([S,] K, M, D)
    sigma: torch.Tensor          # ([S,] K, M, D) diagonal
    sigma_reg: torch.Tensor      # ([S,] K, M, D) the copy `predict` reads
    pi: torch.Tensor             # ([S,] K, M)
    C: torch.Tensor              # ([S,] K, M) soft counts
    class_counts: torch.Tensor   # ([S,] K)
    total_samples: torch.Tensor  # () or ([S],) int32


def class_counts_per_class(state: GMMDotaState) -> torch.Tensor:
    """([S,] K) effective counts of each class."""
    return state.C.sum(dim=-1)


def init(epsilon: float, sigma: float, input_dim: int, num_classes: int,
         clip_weights: torch.Tensor, num_modes: int = 4,
         perturbation_scale: float = 0.01,
         generator: Optional[torch.Generator] = None) -> GMMDotaState:
    """Means = class centre + perturbation_scale · orthonormal rows (the
    Q of a QR of a (K, D, M) standard normal draw from `generator`; with
    M = 1 or D < M, normalised rows of a (K, M, D) draw); variances
    sigma_init; π uniform; soft counts 1/(K·M).

    Args:
      clip_weights: (D, K) or (K, D) anchors (told apart by shape).
    """
    del epsilon
    K, M, D = num_classes, num_modes, input_dim
    dev = clip_weights.device
    cw = clip_weights.to(torch.float32)
    if cw.shape == (D, K):
        base = cw.T
    elif cw.shape == (K, D):
        base = cw
    else:
        raise ValueError(f"clip_weights shape {tuple(cw.shape)} incompatible "
                         f"with D={D}, K={K}")
    if M > 1 and D >= M:
        rv = torch.randn(K, D, M, generator=generator, device=dev)
        ortho = torch.linalg.qr(rv).Q.transpose(1, 2)           # (K, M, D)
    else:
        rv = torch.randn(K, M, D, generator=generator, device=dev)
        ortho = rv / (torch.linalg.norm(rv, dim=-1, keepdim=True) + 1e-12)
    var = torch.full((K, M, D), resolve_sigma_init(sigma, D), device=dev)
    return GMMDotaState(
        mu=base[:, None, :] + perturbation_scale * ortho,
        sigma=var, sigma_reg=var.clone(),
        pi=torch.full((K, M), 1.0 / M, device=dev),
        C=torch.full((K, M), 1.0 / (K * M), device=dev),
        class_counts=torch.zeros(K, device=dev),
        total_samples=torch.zeros((), dtype=torch.int32, device=dev))


def _log_gauss_diag(x: torch.Tensor, mu: torch.Tensor,
                    sigma: torch.Tensor) -> torch.Tensor:
    """Diagonal Gaussian log-density without its constant, in the direct
    form Σ_d (x − μ)²/σ: x ([S,] B, D), mu and sigma ([S,] K, M, D) ->
    ([S,] B, K, M)."""
    s = torch.clamp(sigma, min=_FLOOR)[..., None, :, :, :]
    diff = x[..., :, None, None, :] - mu[..., None, :, :, :]
    return -0.5 * ((diff * diff / s).sum(dim=-1) + torch.log(s).sum(dim=-1))


def fit_stats(state: GMMDotaState, x: torch.Tensor,
              y_zs_prob: torch.Tensor) -> tuple:
    """The E-step and the batch's additive statistics (Σγ, Σγx, Σγ(x−μ)²
    about the OLD means, the class sums): what a data-parallel step sums
    over its ranks before `fit_merge`."""
    x = x.to(torch.float32)
    y = y_zs_prob.to(torch.float32)
    log_l = _log_gauss_diag(x, state.mu, state.sigma)           # (.., B, K, M)
    log_pi = torch.log(torch.clamp(state.pi, min=1e-10))
    r = torch.softmax(log_pi[..., None, :, :] + log_l, dim=-1)
    gamma = y[..., None] * r                                    # (.., B, K, M)
    sum_gamma = gamma.sum(dim=-3)
    *lead, K, M, D = state.mu.shape
    weighted_x = torch.matmul(gamma.flatten(-2).transpose(-1, -2),
                              x).reshape(*lead, K, M, D)
    diff = x[..., :, None, None, :] - state.mu[..., None, :, :, :]
    wdsq = (gamma[..., None] * (diff * diff)).sum(dim=-4)   # (.., K, M, D)
    return sum_gamma, weighted_x, wdsq, y.sum(dim=-2)


def fit_merge(state: GMMDotaState, stats: tuple, n: int) -> GMMDotaState:
    """The streaming M-step on `fit_stats`'s statistics of `n` samples."""
    sum_gamma, weighted_x, wdsq, class_sum = stats
    new_C = state.C + sum_gamma
    denom = torch.clamp(new_C[..., None], min=1e-10)
    return state._replace(
        mu=(state.C[..., None] * state.mu + weighted_x) / denom,
        sigma=torch.clamp((state.C[..., None] * state.sigma + wdsq) / denom,
                          min=_FLOOR),
        pi=new_C / torch.clamp(new_C.sum(dim=-1, keepdim=True), min=1e-10),
        C=new_C, class_counts=state.class_counts + class_sum,
        total_samples=state.total_samples + n)


def fit(state: GMMDotaState, x: torch.Tensor,
        y_zs_prob: torch.Tensor) -> GMMDotaState:
    """One streaming EM step; the covariance update uses the OLD means.

    Args:
      x: ([S,] B, D) features; y_zs_prob: ([S,] B, K) class probabilities.
    """
    return fit_merge(state, fit_stats(state, x, y_zs_prob), x.shape[-2])


def update(state: GMMDotaState, epsilon: float) -> GMMDotaState:
    """Shrink the covariance toward ones: σ_reg = (1 − ε)·σ + ε."""
    reg = (1.0 - epsilon) * state.sigma + epsilon
    return state._replace(sigma_reg=torch.clamp(reg, min=_FLOOR))


def predict(state: GMMDotaState, x: torch.Tensor,
            alpha_max: float = 0.6, num_classes: Optional[int] = None,
            total_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Class scores logsumexp_m[log π + log N(x; μ, σ_reg)] plus the log of
    the prior (1 − α_t)·uniform + α_t·(class counts / their sum), α_t =
    min(alpha_max, t/(t + 100)) after t samples (uniform at t = 0):
    ([S,] B, K).  A state that holds a block of the classes scores them
    against all `num_classes`, whose counts sum to `total_counts`
    (([S],); `parallel/ep.py`)."""
    x = x.to(torch.float32)
    K = state.mu.shape[-3] if num_classes is None else num_classes
    f_km = _log_gauss_diag(x, state.mu, state.sigma_reg)
    log_pi = torch.log(torch.clamp(state.pi, min=1e-10))
    log_class_lik = torch.logsumexp(log_pi[..., None, :, :] + f_km, dim=-1)
    total = (state.class_counts.sum(dim=-1, keepdim=True)
             if total_counts is None else total_counts[..., None])
    t = state.total_samples.to(torch.float32)[..., None]       # over K
    est = state.class_counts / torch.clamp(total, min=1e-10)
    alpha_t = torch.clamp(t / (t + 100.0), max=alpha_max)
    uniform = torch.full_like(est, 1.0 / K)
    p_k = torch.where(t > 0, (1 - alpha_t) * uniform + alpha_t * est,
                      uniform)
    return log_class_lik + torch.log(torch.clamp(p_k, min=1e-10))[..., None, :]
