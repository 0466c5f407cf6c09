"""Text-residual learning (mirror of `uni_adapter_tpu/adapt/residual.py`).

A trainable (K, D) residual is added to the frozen text anchors; each
stream step after the first runs `residual_steps` Adam updates of the
alignment loss over the (K, K) class-embedding log-likelihood matrix
under the current mixture.  Plain autograd gives the gradient (the JAX
`custom_vjp` is a TPU layout device, not part of the function), and Adam
is written out as optax's `adam(lr)` computes it, so one step agrees with
the JAX package to rounding.  Contractions are fp32 without TF32.

S independent streams run at once with a leading stream axis on the
mixture, the residuals and their Adam moments (the JAX package's
`jax.vmap`): the loss is per stream (its own max, its own means), and the
per-stream losses are summed before one `torch.autograd.grad`, which
gives each stream its own gradient since the streams share no parameter.
The Adam count is shared: every stream takes the same steps.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from uni_adapter_torch.adapt import mode_dota

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class ResidualState(NamedTuple):
    residuals: torch.Tensor   # ([S,] K, D)
    mu: torch.Tensor          # Adam first moment
    nu: torch.Tensor          # Adam second moment
    count: int                # Adam steps taken (each stream)


def init(text_features_initial: torch.Tensor) -> ResidualState:
    z = torch.zeros_like(text_features_initial, dtype=torch.float32)
    return ResidualState(z, z.clone(), z.clone(), 0)


def adam_step(state: ResidualState, grads: torch.Tensor,
              lr: float) -> ResidualState:
    """optax.adam(lr): m ← (1−b1)·g + b1·m; v ← (1−b2)·g² + b2·v;
    update = −lr · m̂ / (√v̂ + eps) with bias-corrected m̂, v̂."""
    count = state.count + 1
    mu = (1 - ADAM_B1) * grads + ADAM_B1 * state.mu
    nu = (1 - ADAM_B2) * grads ** 2 + ADAM_B2 * state.nu
    mu_hat = mu / (1 - ADAM_B1 ** count)
    nu_hat = nu / (1 - ADAM_B2 ** count)
    update = -lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
    return ResidualState(state.residuals + update, mu, nu, count)


class FrozenMixtureTerms(NamedTuple):
    """What the loss needs from the mixture, constant over the Adam loop."""
    proj: torch.Tensor   # ([S,] M, K, 2D): per-mode rows [1/var ‖ −2·μ/var]
    base: torch.Tensor   # ([S,] M, K): log π − ½·(Σ log var + Σ μ²/var)


def frozen_mixture_terms(state: mode_dota.ModeDotaState,
                         epsilon: float) -> FrozenMixtureTerms:
    var = mode_dota.regularized_var(state, epsilon)          # ([S,] K, M, D)
    quad_const = torch.sum(state.mu * state.mu / var, dim=-1)     # ([S,] K, M)
    log_det = torch.sum(torch.log(var), dim=-1)
    proj = torch.cat([1.0 / var, -2.0 * (state.mu / var)], dim=-1
                     ).transpose(-3, -2)                     # ([S,] M, K, 2D)
    base = (torch.log(state.pi + 1e-10)
            - 0.5 * (log_det + quad_const)).transpose(-1, -2)
    return FrozenMixtureTerms(proj.contiguous(), base.contiguous())


def _log_marginal(X: torch.Tensor, terms: FrozenMixtureTerms) -> torch.Tensor:
    """([S,] B, 2D) → ([S,] B, K): logsumexp over modes of the per-mode
    joints."""
    ljs = [terms.base[..., m, None, :]
           - 0.5 * torch.matmul(X, terms.proj[..., m, :, :].transpose(-1, -2))
           for m in range(terms.base.shape[-2])]
    mx = ljs[0]
    for lj in ljs[1:]:
        mx = torch.maximum(mx, lj)
    return mx + torch.log(sum(torch.exp(lj - mx) for lj in ljs))


def _loss_tail(lm: torch.Tensor) -> torch.Tensor:
    """Sharpen the diagonal of exp(exp(L / max(L))):
    −mean(diag/rowsum) − mean(diag/colsum), each stream's (K, K) matrix
    on its own max and means: ([S,] K, K) → ([S,])."""
    e = torch.exp(torch.exp(lm / torch.amax(lm, dim=(-2, -1), keepdim=True)))
    diag = torch.diagonal(e, dim1=-2, dim2=-1)
    return (-(diag / e.sum(dim=-1)).mean(dim=-1)
            - (diag / e.sum(dim=-2)).mean(dim=-1))


def _loss_from_terms(class_embeddings: torch.Tensor,
                     terms: FrozenMixtureTerms) -> torch.Tensor:
    x = class_embeddings.to(torch.float32)
    return _loss_tail(_log_marginal(torch.cat([x * x, x], dim=-1), terms))


def alignment_loss(class_embeddings: torch.Tensor,
                   state: mode_dota.ModeDotaState,
                   epsilon: float) -> torch.Tensor:
    """Alignment loss over L[i, k] = log P(e_i | class k); ([S,]) for
    ([S,] K, D) embeddings."""
    return _loss_from_terms(class_embeddings,
                            frozen_mixture_terms(state, epsilon))


def _normalize_rows(t: torch.Tensor) -> torch.Tensor:
    return t / (torch.linalg.norm(t, dim=-1, keepdim=True) + 1e-12)


def optimize_residuals(res_state: ResidualState,
                       text_features_initial: torch.Tensor,
                       mixture: mode_dota.ModeDotaState, lr: float,
                       epsilon: float, num_steps: int = 10) -> ResidualState:
    """`num_steps` Adam updates of the residuals against the frozen mixture:
    each renormalises (initial + residuals) per class row and steps on the
    alignment loss's gradient (S streams: on the sum of their losses,
    each stream's gradient its own)."""
    terms = frozen_mixture_terms(mixture, epsilon)
    with torch.enable_grad():
        for _ in range(num_steps):
            r = res_state.residuals.detach().requires_grad_(True)
            loss = _loss_from_terms(_normalize_rows(text_features_initial + r),
                                    terms)
            (grads,) = torch.autograd.grad(loss.sum(), r)
            res_state = adam_step(res_state._replace(residuals=r.detach()),
                                  grads, lr)
    return res_state


def adapted_text_weights(res_state: ResidualState,
                         text_features_initial: torch.Tensor) -> torch.Tensor:
    """clip_weights = normalize(initial + residuals)ᵀ, ([S,] D, K) fp32."""
    text = _normalize_rows(text_features_initial + res_state.residuals.detach())
    return text.to(torch.float32).transpose(-1, -2)
