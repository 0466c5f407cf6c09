"""DOTA: a streaming Gaussian per class with a shared precision, scored as
LDA (mirror of `uni_adapter_tpu/adapt/dota.py`).

Every product is fp32 without TF32 (the JAX package runs them at
`Precision.HIGHEST`); the entry points turn TF32 off for the process.
The shared precision inverts a symmetric positive definite matrix (ε·I
plus a mean of covariances), by Cholesky (`torch.linalg.cholesky_ex`,
then `torch.cholesky_inverse`; the JAX package inverts by LU), which
neither checks nor synchronises on the host.  On the card it runs on
cuSOLVER, whose batched factorisation a captured step replays (MAGMA's,
which PyTorch may pick for a batch of matrices, cannot be captured).

Every function but `init` also takes S independent streams at once: a
leading stream axis on every tensor of the state, and on `x` and `y`.
The sample count `prior_step` is () while the streams agree on it and
([S],) when they do not.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch


class DOTAState(NamedTuple):
    """One stream's state; S streams' carry a leading (S,) axis on each
    tensor but `prior_step`, which has one only where the streams'
    counts differ."""
    mu: torch.Tensor               # ([S,] K, D) class means
    c: torch.Tensor                # ([S,] K) effective counts
    sigma: torch.Tensor            # ([S,] K, D, D) class covariances
    lam: torch.Tensor              # ([S,] D, D) shared precision
    cum_soft_labels: torch.Tensor  # ([S,] 1, K) cumulative prior evidence
    prior_step: torch.Tensor       # () or ([S],) int32: samples fitted


def init(epsilon: float, sigma: float, input_dim: int, num_classes: int,
         clip_weights: torch.Tensor) -> DOTAState:
    """Means from `clip_weights` (D, K), counts 1, every covariance σ·I and
    the precision I/σ.  (The engine passes a constant 0.001 matrix, as the
    reference's driver does, not the anchors.)"""
    del epsilon
    dev = clip_weights.device
    eye = torch.eye(input_dim, device=dev)
    return DOTAState(
        mu=clip_weights.T.to(torch.float32).contiguous(),
        c=torch.ones(num_classes, device=dev),
        sigma=(sigma * eye).expand(num_classes, -1, -1).contiguous(),
        lam=eye / sigma,
        cum_soft_labels=torch.zeros(1, num_classes, device=dev),
        prior_step=torch.zeros((), dtype=torch.int32, device=dev))


def fit_stats(mu: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> tuple:
    """The soft-label weighted batch's additive statistics (Σ_b y, Σ_b y·x,
    Δ): what a data-parallel step sums over its ranks before `fit_merge`.

    Args:
      mu ([S,] K, D); x ([S,] B, D) features, y ([S,] B, K) soft labels.
    """
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    sum_w = y.sum(dim=-2)                                       # ([S,] K)
    weighted_x = torch.matmul(y.transpose(-1, -2), x)           # ([S,] K, D)
    # Δ[k] = Σ_b y[b,k] (x_b − μ_k)(x_b − μ_k)ᵀ, K products (D, B)·(B, D)
    xm = (x[..., :, None, :] - mu[..., None, :, :]).movedim(-3, -2)
    delta = torch.matmul((y.transpose(-1, -2)[..., None] * xm)
                         .transpose(-1, -2), xm)                # (.., K, D, D)
    return sum_w, weighted_x, delta


def fit_merge(state: DOTAState, stats: tuple, n: int,
              prior_sum: Optional[torch.Tensor] = None) -> DOTAState:
    """`fit`'s streaming mean and covariance update on `fit_stats`'s
    statistics of `n` samples.  `prior_sum` is what the prior's evidence
    gains (the soft labels summed over the batch: Σ_b y by default; the
    class-sharded step passes all classes' where the statistics are of
    its block of them)."""
    sum_w, weighted_x, delta = stats
    if prior_sum is None:
        prior_sum = sum_w
    c = state.c
    mu = (weighted_x + c[..., None] * state.mu) / (sum_w[..., None]
                                                   + c[..., None])
    sigma = (c[..., None, None] * state.sigma + delta) / (
        (c + sum_w)[..., None, None])
    return state._replace(mu=mu, c=c + sum_w, sigma=sigma,
                          cum_soft_labels=(state.cum_soft_labels
                                           + prior_sum[..., None, :]),
                          prior_step=state.prior_step + n)


def fit(state: DOTAState, x: torch.Tensor, y: torch.Tensor) -> DOTAState:
    """Soft-label-weighted streaming update; the prior's evidence sums y
    over the batch and `prior_step` counts the samples fitted."""
    return fit_merge(state, fit_stats(state.mu, x, y), x.shape[-2])


@contextlib.contextmanager
def _cusolver(on_card: bool):
    """cuSOLVER as PyTorch's linear-algebra backend inside the block (on
    the card; the setting is the process's, and is restored)."""
    if not on_card:
        yield
        return
    saved = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(saved)


def shared_precision(mean_sigma: torch.Tensor,
                     epsilon: float) -> torch.Tensor:
    """Λ = ((1 − ε)·Σ̄ + ε·I)⁻¹ of the classes' mean covariance Σ̄."""
    d = mean_sigma.shape[-1]
    reg = ((1.0 - epsilon) * mean_sigma
           + epsilon * torch.eye(d, device=mean_sigma.device))
    with _cusolver(reg.is_cuda):
        return torch.cholesky_inverse(torch.linalg.cholesky_ex(reg)[0])


def update(state: DOTAState, epsilon: float) -> DOTAState:
    """The shared precision Λ = ((1 − ε)·mean_k Σ_k + ε·I)⁻¹."""
    return state._replace(lam=shared_precision(state.sigma.mean(dim=-3),
                                                epsilon))


def predict(state: DOTAState, x: torch.Tensor,
            prior_pre_steps: Optional[int] = None) -> torch.Tensor:
    """LDA scores x·W − ½·diag(MᵀW), W = Λ·M, ([S,] B, K); with
    `prior_pre_steps`, plus the log of the cumulative soft-label prior
    blended with that many pseudo-counts of a uniform prior."""
    M = state.mu.transpose(-1, -2)                              # ([S,] D, K)
    W = torch.matmul(state.lam, M)
    c = 0.5 * (M * W).sum(dim=-2)                               # ([S,] K)
    scores = torch.matmul(x.to(torch.float32), W) - c[..., None, :]
    if prior_pre_steps is not None:
        k = state.mu.shape[-2]
        prior = state.cum_soft_labels + prior_pre_steps / k
        steps = state.prior_step[..., None, None]       # over (1, K)
        prior = prior / (prior_pre_steps + steps)
        scores = scores + torch.log(prior + 1e-10)
    return scores
