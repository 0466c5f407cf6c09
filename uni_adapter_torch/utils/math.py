"""Entropy, conjugate gradient and the cache's graph-Laplacian refinement
(mirror of `uni_adapter_tpu/utils/math.py`).

Every function takes an optional leading stream axis (S independent
problems, the JAX package's `jax.vmap`), written out as batched
`torch.matmul` products.  fp32 products without TF32: the JAX package
runs them at `Precision.HIGHEST`, and the entry points turn TF32 off for
the process.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


def entropy(probs: torch.Tensor) -> torch.Tensor:
    """Shannon entropy of probability rows, in nats: (..., K) -> (...,)."""
    return -(probs * torch.log(probs + 1e-10)).sum(dim=-1)


def softmax_entropy(x: torch.Tensor) -> torch.Tensor:
    """Shannon entropy of softmax(x) rows, in nats: (..., K) -> (...,)."""
    return entropy(torch.softmax(x, dim=-1))


def normalized_entropy(ent: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Entropy over log2(K): a natural-log entropy normalised by a base-2
    log, as the reference does."""
    return (ent / math.log2(float(num_classes))).to(torch.float32)


class CGState(NamedTuple):
    """The CG's carry, updated in place by `cg_iteration_`: x, r, p ([S,]
    N, K); rz ([S,] K); done and iters ([S,])."""
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    done: torch.Tensor
    iters: torch.Tensor


def cg_start(b: torch.Tensor) -> CGState:
    """The carry at x = 0: r = p = b (b − A·0 without a product), no
    system stopped (a do-while: each runs at least one iteration)."""
    rz = torch.sum(b * b, dim=-2)
    return CGState(torch.zeros_like(b), b.clone(), b.clone(), rz,
                   torch.zeros(rz.shape[:-1], dtype=torch.bool,
                               device=b.device),
                   torch.zeros(rz.shape[:-1], dtype=torch.int32,
                               device=b.device))


def cg_iteration_(A: torch.Tensor, s: CGState,
                  tol: float = 1e-5) -> torch.Tensor:
    """One CG iteration of every system that has not stopped, written into
    `s` in place (a captured iteration replays on the same tensors);
    returns whether every system has now stopped, a () bool tensor."""
    return cg_update_(s, torch.matmul(A, s.p), tol)


def cg_update_(s: CGState, Ap: torch.Tensor,
               tol: float = 1e-5) -> torch.Tensor:
    """`cg_iteration_` after its product Ap = A·p (a class-sharded cache
    gathers Ap from the ranks' row blocks of A)."""
    alpha = (s.rz / (torch.sum(s.p * Ap, dim=-2) + 1e-8)).unsqueeze(-2)
    run = ~s.done
    keep = run[..., None, None]
    r_new = s.r - alpha * Ap
    rz_new = torch.sum(r_new * r_new, dim=-2)
    beta = (rz_new / (s.rz + 1e-8)).unsqueeze(-2)
    s.x.copy_(torch.where(keep, s.x + alpha * s.p, s.x))
    s.p.copy_(torch.where(keep, r_new + beta * s.p, s.p))
    s.r.copy_(torch.where(keep, r_new, s.r))
    s.rz.copy_(torch.where(run[..., None], rz_new, s.rz))
    s.iters.add_(run.to(torch.int32))
    s.done.logical_or_(torch.all(s.rz < tol, dim=-1))
    return s.done.all()


def run_cg(iteration: Callable[[], torch.Tensor], max_iter: int) -> None:
    """Call `iteration` (one in-place CG iteration, returning whether every
    system has stopped) until every system has stopped or `max_iter`
    times; the host reads the stop flag after each."""
    for _ in range(max_iter):
        if bool(iteration()):
            break


def conjugate_gradient(A, b: torch.Tensor, max_iter: int = 100,
                       tol: float = 1e-5):
    """Solve A @ x = b by CG with per-column step sizes.

    Args:
      A: ([S,] N, N).
      b: ([S,] N, K): K right-hand sides per system.
    Returns:
      (x ([S,] N, K), iterations ([S,]) int32).

    The JAX package's `lax.while_loop`, system by system: a do-while (at
    least one iteration, even for a tiny b), and a system stops only when
    ALL its columns have r·r < tol (a per-column stop diverges from the
    reference by ~3e-3).  S systems run together and each is frozen at its
    own stopping iteration, as `jax.vmap` of the loop freezes each batch
    member: a system that has stopped takes no further update, however
    long the others run.  The host reads the stop flags every iteration
    to leave the loop.
    """
    s = cg_start(b)
    run_cg(lambda: cg_iteration_(A, s, tol), max_iter)
    return s.x, s.iters


def _masked_laplacian(keys: torch.Tensor, valid: torch.Tensor,
                      threshold: float, lambda_reg: float) -> torch.Tensor:
    """Regularised normalised graph Laplacian over the valid nodes:
    cosine adjacency zeroed below `threshold` and on invalid rows and
    columns, L = I − D^-½ W D^-½ + 2λI.  keys ([S,] N, D), valid ([S,] N)."""
    n = keys.shape[-2]
    normed = keys / (torch.linalg.norm(keys, dim=-1, keepdim=True) + 1e-12)
    W = torch.matmul(normed, normed.transpose(-1, -2))
    W = torch.where(W < threshold, 0.0, W)
    vmask = valid.to(W.dtype)
    W = W * vmask[..., :, None] * vmask[..., None, :]
    d_inv_sqrt = 1.0 / (torch.sqrt(W.sum(dim=-1)) + 1e-8)
    eye = torch.eye(n, dtype=W.dtype, device=W.device)
    L_norm = eye - d_inv_sqrt[..., :, None] * W * d_inv_sqrt[..., None, :]
    return L_norm + 2.0 * lambda_reg * eye


def refinement_system(cache_keys: torch.Tensor, all_probs: torch.Tensor,
                      valid: torch.Tensor, threshold: float,
                      lambda_reg: float):
    """The linear system of the graph-Laplacian label smoothing:
    (L_reg ([S,] N, N), right-hand sides 2λ·probs ([S,] N, K), invalid rows
    zero)."""
    L_reg = _masked_laplacian(cache_keys, valid, threshold, lambda_reg)
    probs = all_probs * valid[..., None].to(all_probs.dtype)
    return L_reg, 2.0 * lambda_reg * probs


def solve_explicit(L_reg: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The explicit solve, without reading `info` back to the host (JAX's
    solve checks nothing either), so that a captured step holds it."""
    return torch.linalg.solve_ex(L_reg, rhs, check_errors=False)[0]


def refined_labels(sol: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The solution row-normalised, invalid rows zero."""
    sol = sol / (sol.sum(dim=-1, keepdim=True) + 1e-12)
    return sol * valid[..., None].to(sol.dtype)
