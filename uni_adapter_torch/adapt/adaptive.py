"""Adaptive-modes DOTA: one mode a class at first, a mode split in two as
it widens (mirror of `uni_adapter_tpu/adapt/adaptive.py`).

The state is padded to `max_modes` slots a class with a validity mask,
allocated once, so a split is a masked scatter and the state keeps its
shapes (a captured step replays on it).  A slot's mode is eligible to
split when its largest diagonal variance exceeds `split_threshold`, its
count is at least `min_count_to_split` and its class has a spare slot.
Eligible modes are taken in ascending slot order up to the class's spare
slots and split in reverse order: the selected mode of ascending rank r
(of S selected) keeps its +½σ child in its slot and puts its −½σ child in
slot n_modes + (S − 1 − r), as the reference's ragged lists place it.

`fit` runs the split check every `split_check_interval` fits.  The check
is computed at every fit and its result taken where the fit counter says
so (`torch.where` on a device flag): no host read, one captured graph.

Every function but `init` and `get_mode_stats` also takes S independent
streams at once: a leading stream axis on every tensor of the state, and
on `x` and `gamma_class`.  The counts `t` and `fit_calls` are () while
the streams agree on them and ([S],) when they do not; the split check
is then due for each stream by its own `fit_calls`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from uni_adapter_torch.adapt.mode_dota import resolve_sigma_init

_FLOOR = 1e-8
_PAD_VAR = 1e10   # an empty slot's variance: its log-likelihood is -inf-like


class AdaptiveState(NamedTuple):
    """One stream's padded mixture; S streams' carry a leading (S,) axis on
    each tensor but the counts `t` and `fit_calls`, which have one only
    where the streams' counts differ."""
    mu: torch.Tensor            # ([S,] K, Mmax, D)
    var: torch.Tensor           # ([S,] K, Mmax, D)
    pi: torch.Tensor            # ([S,] K, Mmax)
    c: torch.Tensor             # ([S,] K, Mmax)
    mask: torch.Tensor          # ([S,] K, Mmax) bool: the valid slots
    class_counts: torch.Tensor  # ([S,] K)
    t: torch.Tensor             # () or ([S],) int32: samples fitted
    fit_calls: torch.Tensor     # () or ([S],) int32


def init(epsilon: float, sigma: float, input_dim: int, num_classes: int,
         clip_weights: torch.Tensor, max_modes: int = 8) -> AdaptiveState:
    """One mode a class in slot 0: the class centre from `clip_weights`
    (D, K), variance sigma_init, weight and count 1."""
    del epsilon
    K, M, D = num_classes, max_modes, input_dim
    dev = clip_weights.device
    mu = torch.zeros(K, M, D, device=dev)
    mu[:, 0] = clip_weights.T.to(torch.float32)
    var = torch.full((K, M, D), _PAD_VAR, device=dev)
    var[:, 0] = resolve_sigma_init(sigma, D)
    first = torch.zeros(K, M, device=dev)
    first[:, 0] = 1.0
    return AdaptiveState(mu, var, first, first.clone(), first > 0,
                         torch.zeros(K, device=dev),
                         torch.zeros((), dtype=torch.int32, device=dev),
                         torch.zeros((), dtype=torch.int32, device=dev))


def num_modes_per_class(state: AdaptiveState) -> torch.Tensor:
    return state.mask.sum(dim=-1).to(torch.int32)


def _log_likelihood(x: torch.Tensor, mu: torch.Tensor,
                    var: torch.Tensor) -> torch.Tensor:
    """x ([S,] B, D), mu and var ([S,] K, M, D) -> ([S,] B, K, M), in the
    direct form Σ_d (x − μ)²/v."""
    diff = x[..., :, None, None, :] - mu[..., None, :, :, :]
    maha = (diff * diff / var[..., None, :, :, :]).sum(dim=-1)
    log_det = torch.log(var).sum(dim=-1)
    return -0.5 * (log_det[..., None, :, :] + maha)


def _log_joint(state: AdaptiveState, x: torch.Tensor,
               epsilon: float) -> torch.Tensor:
    """log π + log-likelihood at var + ε, -inf on the empty slots."""
    var = torch.clamp(state.var + epsilon, min=_FLOOR)
    log_pi = torch.where(state.mask, torch.log(state.pi + 1e-10),
                         float("-inf"))
    return log_pi[..., None, :, :] + _log_likelihood(x, state.mu, var)


def _scatter_children(parent: torch.Tensor, child: torch.Tensor,
                      slot: torch.Tensor) -> torch.Tensor:
    """`parent` ([S,] K, M[, D]) with child[k, m] written to slot[k, m]
    along the mode axis; slot M drops the write (the JAX scatter's
    mode='drop')."""
    mode_dim = slot.dim() - 1
    pad = torch.zeros_like(parent.narrow(mode_dim, 0, 1))
    index = slot
    while index.dim() < child.dim():
        index = index[..., None]
    out = torch.cat([parent, pad], dim=mode_dim)
    out.scatter_(mode_dim, index.expand_as(child), child)
    return out.narrow(mode_dim, 0, parent.shape[mode_dim])


def check_and_split(state: AdaptiveState, split_threshold: float,
                    min_count_to_split: float = 5.0) -> AdaptiveState:
    """Split the eligible modes in one masked scatter (the module
    docstring gives the slot order)."""
    M, D = state.mu.shape[-2:]
    n_modes = num_modes_per_class(state)[..., None]               # (.., K, 1)
    max_var = torch.where(state.mask, state.var.amax(dim=-1),
                          float("-inf"))
    eligible = (state.mask & (state.c >= min_count_to_split)
                & (max_var > split_threshold))
    cap = torch.clamp(M - n_modes, min=0)
    rank = torch.cumsum(eligible.to(torch.int32), dim=-1) - 1
    selected = eligible & (rank < cap)
    n_sel = selected.sum(dim=-1, keepdim=True)
    child_slot = torch.where(selected, n_modes + n_sel - 1 - rank, M)
    split_dim = torch.argmax(state.var, dim=-1)     # the first max, as jnp
    split_std = torch.sqrt(torch.gather(state.var, -1, split_dim[..., None]))
    e = torch.nn.functional.one_hot(split_dim, D).to(torch.float32)
    offset = 0.5 * split_std * e
    var_c = torch.clamp(state.var * (1.0 - 0.5 * e), min=_FLOOR)
    sel3 = selected[..., None]
    half_c, half_pi = state.c * 0.5, state.pi * 0.5
    return state._replace(
        mu=_scatter_children(torch.where(sel3, state.mu + offset, state.mu),
                             state.mu - offset, child_slot),
        var=_scatter_children(torch.where(sel3, var_c, state.var), var_c,
                              child_slot),
        c=_scatter_children(torch.where(selected, half_c, state.c), half_c,
                            child_slot),
        pi=_scatter_children(torch.where(selected, half_pi, state.pi),
                             half_pi, child_slot),
        mask=_scatter_children(state.mask, torch.ones_like(state.mask),
                               child_slot))


def fit_stats(state: AdaptiveState, x: torch.Tensor,
              gamma_class: torch.Tensor, epsilon: float) -> tuple:
    """The masked E-step and the batch's additive statistics (Σγ, Σγx,
    Σγx², the class sums): what a data-parallel step sums over its ranks
    before `fit_merge`."""
    x = x.to(torch.float32)
    gamma_class = gamma_class.to(torch.float32)
    log_joint = _log_joint(state, x, epsilon)                 # (.., B, K, M)
    log_r = log_joint - torch.logsumexp(log_joint, dim=-1, keepdim=True)
    r = torch.where(state.mask[..., None, :, :], torch.exp(log_r), 0.0)
    gamma = gamma_class[..., None] * r
    sum_gamma = gamma.sum(dim=-3)
    gamma_perm = gamma.movedim(-3, -1)                        # (.., K, M, B)
    weighted_x = torch.matmul(gamma_perm, x[..., None, :, :])
    weighted_x_sq = torch.matmul(gamma_perm, (x * x)[..., None, :, :])
    return sum_gamma, weighted_x, weighted_x_sq, gamma_class.sum(dim=-2)


def fit_merge(state: AdaptiveState, stats: tuple, n: int,
              split_threshold: float, min_count_to_split: float = 5.0,
              split_check_interval: int = 50) -> AdaptiveState:
    """The masked streaming M-step on `fit_stats`'s statistics of `n`
    samples, then the split check if the fit counter is a multiple of
    `split_check_interval`."""
    sum_gamma, weighted_x, weighted_x_sq, class_sum = stats
    c_new = state.c + sum_gamma
    mask3 = state.mask[..., None]
    mu_new = (state.c[..., None] * state.mu + weighted_x) / (
        c_new[..., None] + 1e-10)
    # Σ_b γ (x − μ_old)² = Σγx² − 2μ_old·Σγx + Σγ·μ_old²
    wsq = (weighted_x_sq - 2.0 * state.mu * weighted_x
           + sum_gamma[..., None] * state.mu ** 2)
    var_new = torch.clamp((state.c[..., None] * state.var + wsq)
                          / (c_new[..., None] + 1e-10), min=_FLOOR)
    c = torch.where(state.mask, c_new, 0.0)
    new = state._replace(
        mu=torch.where(mask3, mu_new, state.mu),
        var=torch.where(mask3, var_new, state.var),
        pi=c / (c.sum(dim=-1, keepdim=True) + 1e-10), c=c,
        class_counts=state.class_counts + class_sum,
        t=state.t + n, fit_calls=state.fit_calls + 1)
    split = check_and_split(new, split_threshold, min_count_to_split)
    due = new.fit_calls % split_check_interval == 0
    return AdaptiveState(*(
        torch.where(due.reshape(due.shape + (1,) * (b.dim() - due.dim())),
                    a, b) if b.dim() else b for a, b in zip(split, new)))


def fit(state: AdaptiveState, x: torch.Tensor, gamma_class: torch.Tensor,
        epsilon: float, split_threshold: float,
        min_count_to_split: float = 5.0,
        split_check_interval: int = 50) -> AdaptiveState:
    """One masked streaming EM step, then the split check if the fit
    counter is a multiple of `split_check_interval`.

    Args:
      x: ([S,] B, D) features; gamma_class: ([S,] B, K) class
        probabilities.
    """
    return fit_merge(state, fit_stats(state, x, gamma_class, epsilon),
                     x.shape[-2], split_threshold, min_count_to_split,
                     split_check_interval)


def predict(state: AdaptiveState, x: torch.Tensor,
            epsilon: float) -> torch.Tensor:
    """Class scores logsumexp over the valid modes, ([S,] B, K).  (The JAX
    function's optional source-prior blend has no caller and is not
    ported.)"""
    return torch.logsumexp(_log_joint(state, x.to(torch.float32), epsilon),
                           dim=-1)


def update(state: AdaptiveState) -> AdaptiveState:
    """No-op, for the variants' common fit/update/predict protocol."""
    return state


def get_mode_stats(state: AdaptiveState) -> dict:
    """One stream's mode counts: per class, total, min, max, mean."""
    counts = num_modes_per_class(state).tolist()
    return {"per_class": counts, "total": sum(counts), "min": min(counts),
            "max": max(counts), "mean": sum(counts) / len(counts)}
