"""Exact t-SNE in PyTorch, on the input tensor's device.

The cross-class analysis embeds a few dozen centroids in 2-D (the JAX
package calls scikit-learn's `TSNE`, which the port does not depend on).
This is scikit-learn's algorithm (`sklearn/manifold/_t_sne.py`) step by
step, with its dtypes:

  * squared euclidean distances in fp64 (‖x‖² + ‖y‖² − 2x·y, clipped at 0,
    zero diagonal), rounded to fp32, then each row's Gaussian calibrated
    by `_binary_search_perplexity` (β doubled or halved until bracketed,
    then bisected, at most 100 steps, tolerance 1e-5 on the entropy);
  * the symmetrised P = (P + Pᵀ) / ΣP, floored at fp64's machine epsilon;
  * the init: PCA of the centred data (its SVD, signs by `svd_flip`'s rule
    on the components' largest entries), in fp32, scaled so that column
    0 has standard deviation 1e-4;
  * learning rate 'auto', max(n / 12 / 4, 50); early exaggeration 12 for
    250 iterations at momentum 0.5, then momentum 0.8 up to `max_iter`
    (1000), the gains +0.2 / ×0.8 with min_gain 0.01; the error and the
    gradient norm checked every 50 iterations (`n_iter_without_progress`
    300, 250 in the first phase; `min_grad_norm` 1e-7).  The embedding
    and the gains are fp32, the gradient computed in fp64 and stored in
    fp32, the update fp64.

The one difference from the JAX package's call is the method: it runs
scikit-learn's default, Barnes-Hut, which approximates this objective and
its gradient with a quad-tree; here the objective is exact (the method
scikit-learn calls 'exact').  Each iteration runs on the device without
synchronising; the host reads the error and the gradient norm at each
check.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

MACHINE_EPSILON = torch.finfo(torch.float64).eps
#: scikit-learn's `_utils.pyx` constants are C floats.
_EPSILON_DBL = float(torch.tensor(1e-8, dtype=torch.float32))
_PERPLEXITY_TOLERANCE = float(torch.tensor(1e-5, dtype=torch.float32))
EARLY_EXAGGERATION = 12.0
EXPLORATION_ITERS = 250
N_ITER_CHECK = 50
N_ITER_WITHOUT_PROGRESS = 300
MIN_GAIN = 0.01
MIN_GRAD_NORM = 1e-7


def squared_distances(x: torch.Tensor) -> torch.Tensor:
    """(n, n) squared euclidean distances of the rows of x, in fp64 as
    scikit-learn's `euclidean_distances(squared=True)` computes them."""
    x = x.to(torch.float64)
    xx = (x * x).sum(dim=1)
    d = -2.0 * (x @ x.T)
    d = d + xx[:, None]
    d = d + xx[None, :]
    d = torch.clamp(d, min=0.0)
    return d.fill_diagonal_(0.0)


def binary_search_perplexity(sqd: torch.Tensor,
                             perplexity: float) -> torch.Tensor:
    """Each row's conditional distribution p_j|i, (n, n) fp64 with a zero
    diagonal, its precision β bisected until its entropy is log
    `perplexity` (all rows at once; a row stops where it converged)."""
    n = sqd.shape[0]
    dev = sqd.device
    d = sqd.to(torch.float32).to(torch.float64)
    off = ~torch.eye(n, dtype=torch.bool, device=dev)
    desired = math.log(float(torch.tensor(perplexity, dtype=torch.float32)))
    beta = torch.ones(n, dtype=torch.float64, device=dev)
    beta_min = torch.full_like(beta, -math.inf)
    beta_max = torch.full_like(beta, math.inf)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    P = torch.zeros(n, n, dtype=torch.float64, device=dev)
    for _ in range(100):
        p = torch.where(off, torch.exp(-d * beta[:, None]), 0.0)
        sum_p = p.sum(dim=1)
        sum_p = torch.where(sum_p == 0.0, _EPSILON_DBL, sum_p)
        p = p / sum_p[:, None]
        entropy = torch.log(sum_p) + beta * (d * p).sum(dim=1)
        diff = entropy - desired
        P = torch.where(active[:, None], p, P)
        move = active & (diff.abs() > _PERPLEXITY_TOLERANCE)
        up = move & (diff > 0.0)
        down = move & ~(diff > 0.0)
        beta_up = torch.where(beta_max == math.inf, beta * 2.0,
                              (beta + beta_max) / 2.0)
        beta_down = torch.where(beta_min == -math.inf, beta / 2.0,
                                (beta + beta_min) / 2.0)
        beta_min = torch.where(up, beta, beta_min)
        beta_max = torch.where(down, beta, beta_max)
        beta = torch.where(up, beta_up, torch.where(down, beta_down, beta))
        active = move
    return P


def joint_probabilities(x: torch.Tensor, perplexity: float) -> torch.Tensor:
    """The symmetrised P of the rows of x, (n, n) fp64, floored at machine
    epsilon off the diagonal and zero on it."""
    cond = binary_search_perplexity(squared_distances(x), perplexity)
    P = cond + cond.T
    P = P / torch.clamp(P.sum(), min=MACHINE_EPSILON)
    P = torch.clamp(P, min=MACHINE_EPSILON)
    return P.fill_diagonal_(0.0)


def pca_init(x: torch.Tensor, n_components: int = 2) -> torch.Tensor:
    """scikit-learn's 'pca' init: the centred data's projection on its
    first components (U·S of its SVD, each component's sign making its
    largest entry positive), fp32, scaled to std 1e-4 in column 0."""
    x = x.to(torch.float64)
    xc = x - x.mean(dim=0)
    U, S, Vt = torch.linalg.svd(xc, full_matrices=False)
    U, S, Vt = U[:, :n_components], S[:n_components], Vt[:n_components]
    top = torch.argmax(Vt.abs(), dim=1)
    signs = torch.sign(Vt[torch.arange(n_components, device=x.device), top])
    y = ((U * signs) * S).to(torch.float32)
    return y / torch.std(y[:, 0], unbiased=False) * 1e-4


def _upper(a: torch.Tensor) -> torch.Tensor:
    n = a.shape[0]
    i, j = torch.triu_indices(n, n, offset=1, device=a.device)
    return a[i, j]


def kl_divergence(y: torch.Tensor, P: torch.Tensor,
                  compute_error: bool = True) -> tuple:
    """(KL(P‖Q) as a 0-d fp64 tensor, or None; its gradient in fp32) at
    the fp32 embedding y (n, 2), Q the Student-t (one degree of freedom)
    similarities of y: scikit-learn's `_kl_divergence`."""
    n = y.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=y.device)
    diff = y[:, None, :] - y[None, :, :]                 # fp32, as numpy's
    yd = y.to(torch.float64)
    dist = ((yd[:, None, :] - yd[None, :, :]) ** 2).sum(dim=-1)
    dist = 1.0 / (dist + 1.0)
    dist = torch.where(off, dist, 0.0)
    Q = torch.clamp(dist / (2.0 * _upper(dist).sum()), min=MACHINE_EPSILON)
    Q = torch.where(off, Q, 0.0)
    kl = None
    if compute_error:
        p = _upper(P)
        kl = 2.0 * torch.dot(p, torch.log(torch.clamp(p, min=MACHINE_EPSILON)
                                          / _upper(Q)))
    pqd = (P - Q) * dist
    grad = (pqd[:, :, None] * diff.to(torch.float64)).sum(dim=1)
    return kl, grad.to(torch.float32) * 4.0


def _gradient_descent(p: torch.Tensor, P: torch.Tensor, it: int,
                      max_iter: int, momentum: float, learning_rate: float,
                      n_iter_without_progress: int) -> tuple:
    """scikit-learn's `_gradient_descent` on the embedding p (n, 2) fp32:
    returns (p, the last error, the last iteration)."""
    update = torch.zeros(p.shape, dtype=torch.float64, device=p.device)
    gains = torch.ones_like(p)
    error = best_error = float(torch.finfo(torch.float64).max)
    best_iter = i = it
    for i in range(it, max_iter):
        check = (i + 1) % N_ITER_CHECK == 0
        kl, grad = kl_divergence(p, P, compute_error=check
                                 or i == max_iter - 1)
        inc = update * grad < 0.0
        gains = torch.clamp(torch.where(inc, gains + 0.2, gains * 0.8),
                            min=MIN_GAIN)
        grad = grad * gains
        update = momentum * update - learning_rate * grad.to(torch.float64)
        p = (p.to(torch.float64) + update).to(torch.float32)
        if kl is not None:
            error = float(kl)
        if check:
            grad_norm = float(torch.linalg.vector_norm(grad))
            if error < best_error:
                best_error, best_iter = error, i
            elif i - best_iter > n_iter_without_progress:
                break
            if grad_norm <= MIN_GRAD_NORM:
                break
    return p, error, i


def tsne(x: torch.Tensor, perplexity: float = 30.0,
         init: Optional[torch.Tensor] = None, max_iter: int = 1000) -> dict:
    """Embed the rows of x (n, d) in 2-D by exact t-SNE, on x's device.

    Args:
      perplexity: less than n.
      init: an (n, 2) initial embedding (scikit-learn's `init=<array>`);
        `pca_init(x)` if None.
      max_iter: at least 250 (the early-exaggeration phase); 250 returns
        the embedding at the end of that phase.
    Returns:
      dict with `embedding` ((n, 2) fp32 tensor), `kl_divergence` (the
      last error, float) and `n_iter` (the last iteration).
    """
    n = x.shape[0]
    if perplexity >= n:
        raise ValueError(f"perplexity ({perplexity}) must be less than "
                         f"n_samples ({n})")
    if max_iter < EXPLORATION_ITERS:
        raise ValueError(f"max_iter {max_iter} < {EXPLORATION_ITERS}")
    P = joint_probabilities(x, perplexity)
    y = (pca_init(x) if init is None
         else torch.as_tensor(init, dtype=torch.float32, device=x.device))
    lr = max(n / EARLY_EXAGGERATION / 4, 50.0)
    P = P * EARLY_EXAGGERATION
    y, kl, it = _gradient_descent(y, P, 0, EXPLORATION_ITERS, 0.5, lr,
                                  EXPLORATION_ITERS)
    P = P / EARLY_EXAGGERATION
    y, kl, it = _gradient_descent(y, P, it + 1, max_iter, 0.8, lr,
                                  N_ITER_WITHOUT_PROGRESS)
    return {"embedding": y, "kl_divergence": kl, "n_iter": it}
