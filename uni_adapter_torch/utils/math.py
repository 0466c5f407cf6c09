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
    x = torch.zeros_like(b)
    r = b                   # b − A·x at x = 0, without a product
    p = r
    rz = torch.sum(r * r, dim=-2)
    # do-while: no system has stopped before its first iteration
    done = torch.zeros(rz.shape[:-1], dtype=torch.bool, device=b.device)
    iters = torch.zeros(rz.shape[:-1], dtype=torch.int32, device=b.device)
    for _ in range(max_iter):
        Ap = torch.matmul(A, p)
        alpha = (rz / (torch.sum(p * Ap, dim=-2) + 1e-8)).unsqueeze(-2)
        run = ~done
        keep = run[..., None, None]
        x = torch.where(keep, x + alpha * p, x)
        r_new = r - alpha * Ap
        rz_new = torch.sum(r_new * r_new, dim=-2)
        beta = (rz_new / (rz + 1e-8)).unsqueeze(-2)
        p = torch.where(keep, r_new + beta * p, p)
        r = torch.where(keep, r_new, r)
        rz = torch.where(run[..., None], rz_new, rz)
        iters += run.to(torch.int32)
        done = done | torch.all(rz < tol, dim=-1)
        if bool(done.all()):
            break
    return x, iters


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


def online_value_refinement_new(cache_keys: torch.Tensor,
                                all_probs: torch.Tensor, valid: torch.Tensor,
                                threshold: float = 0.5,
                                lambda_reg: float = 0.13,
                                max_iter: int = 100):
    """Graph-Laplacian label smoothing solved by CG.

    Args:
      cache_keys: ([S,] N, D) node features; all_probs: ([S,] N, K);
        valid: ([S,] N) bool.
    Returns:
      (refined ([S,] N, K) row-normalised, invalid rows zero;
       CG iterations ([S,])).
    """
    L_reg = _masked_laplacian(cache_keys, valid, threshold, lambda_reg)
    probs = all_probs * valid[..., None].to(all_probs.dtype)
    sol, iters = conjugate_gradient(L_reg, 2.0 * lambda_reg * probs,
                                    max_iter=max_iter)
    sol = sol / (sol.sum(dim=-1, keepdim=True) + 1e-12)
    return sol * valid[..., None].to(sol.dtype), iters


def online_value_refinement_old(cache_keys: torch.Tensor,
                                all_probs: torch.Tensor, valid: torch.Tensor,
                                threshold: float = 0.5,
                                lambda_reg: float = 0.13) -> torch.Tensor:
    """The explicit-solve variant (`torch.linalg.solve`)."""
    L_reg = _masked_laplacian(cache_keys, valid, threshold, lambda_reg)
    probs = all_probs * valid[..., None].to(all_probs.dtype)
    sol = torch.linalg.solve(L_reg, 2.0 * lambda_reg * probs)
    sol = sol / (sol.sum(dim=-1, keepdim=True) + 1e-12)
    return sol * valid[..., None].to(sol.dtype)
