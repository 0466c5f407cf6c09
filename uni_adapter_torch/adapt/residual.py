"""Text-residual learning (mirror of `uni_adapter_tpu/adapt/residual.py`).

A trainable (K, D) residual is added to the frozen text anchors; each
stream step after the first runs `residual_steps` Adam updates of the
alignment loss over the (K, K) class-embedding log-likelihood matrix
under the current mixture.  Plain autograd gives the gradient (the JAX
`custom_vjp` is a TPU layout device, not part of the function), and Adam
is written out as optax's `adam(lr)` computes it, so one step agrees with
the JAX package to rounding.

The loop's log-likelihood products, forward and backward, run at one of
the JAX package's three precision tiers (`DotaConfig.residual_precision`),
each mapped to what the card has: 'highest' (the TPU's fp32-exact 6-pass)
is fp32 with TF32 off; 'high' (the TPU's 3-pass bf16 split) is TF32,
turned on for the loop alone; 'default' (the TPU's single bf16 pass) is
bf16 operands with fp32 sums and an fp32 result (`bf16_matmul`).  Every
other contraction is fp32 without TF32.

S independent streams run at once with a leading stream axis on the
mixture, the residuals and their Adam moments (the JAX package's
`jax.vmap`): the loss is per stream (its own max, its own means), and the
per-stream losses are summed before one `torch.autograd.grad`, which
gives each stream its own gradient since the streams share no parameter.
The Adam count is () while the streams agree on it and ([S],) when they
do not (a serving tick that batches clients at different points of their
streams): each stream's bias corrections read its own count.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple, Optional

import torch

from uni_adapter_torch.adapt import mode_dota

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
PRECISIONS = ("highest", "high", "default")


class ResidualState(NamedTuple):
    residuals: torch.Tensor   # ([S,] K, D)
    mu: torch.Tensor          # Adam first moment
    nu: torch.Tensor          # Adam second moment
    count: torch.Tensor       # () or ([S],) int32: Adam steps taken


def init(text_features_initial: torch.Tensor) -> ResidualState:
    z = torch.zeros_like(text_features_initial, dtype=torch.float32)
    return ResidualState(z, z.clone(), z.clone(),
                         torch.zeros((), dtype=torch.int32, device=z.device))


def bias_corrections(count: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Adam's bias corrections 1 − b1**c and 1 − b2**c for the counts
    c = count + 1 … count + num_steps, ([S,] num_steps, 2) for a ([S],)
    count, taken in float64 and rounded once to fp32 (fp32's own 1 − 0.999
    cancels to 1.3e-5 of the value, which the loss's exp(exp(·)) carries
    over ten steps); a loop's at once, in a few launches."""
    c = (count[..., None] + torch.arange(1, num_steps + 1, dtype=count.dtype,
                                         device=count.device)
         ).to(torch.float64)
    return (1.0 - torch.stack([ADAM_B1 ** c, ADAM_B2 ** c], dim=-1)
            ).to(torch.float32)


def adam_step(state: ResidualState, grads: torch.Tensor, lr: float,
              correction: Optional[torch.Tensor] = None) -> ResidualState:
    """optax.adam(lr): m ← (1−b1)·g + b1·m; v ← (1−b2)·g² + b2·v;
    update = −lr · m̂ / (√v̂ + eps) with bias-corrected m̂, v̂.  The count
    is a device tensor, as optax's int32 count is, so that a captured
    step replays at every count; `correction` is this step's ([S,] 2) row
    of `bias_corrections`, if the caller has it."""
    if correction is None:
        correction = bias_corrections(state.count, 1)[..., 0, :]
    correction = correction[..., None, None, :]     # over the (K, D) rows
    mu = (1 - ADAM_B1) * grads + ADAM_B1 * state.mu
    nu = (1 - ADAM_B2) * grads ** 2 + ADAM_B2 * state.nu
    mu_hat = mu / correction[..., 0]
    nu_hat = nu / correction[..., 1]
    update = -lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
    return ResidualState(state.residuals + update, mu, nu, state.count + 1)


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


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to bf16 and the products summed in
    fp32, fp32 out: one bf16 tensor-core product on the card
    (`out_dtype=torch.float32`); on the CPU the same sum of exact products
    (a bf16 product fits in fp32) as an fp32 product of the rounded
    operands."""
    a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
    if not a.is_cuda:
        return torch.matmul(a16.to(torch.float32), b16.to(torch.float32))
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    if not lead:
        return torch.mm(a16, b16, out_dtype=torch.float32)
    a3 = a16.expand(*lead, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b16.expand(*lead, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    out = torch.bmm(a3, b3, out_dtype=torch.float32)
    return out.reshape(*lead, *out.shape[-2:])


class _Bf16Projection(torch.autograd.Function):
    """X @ Pᵀ at the 'default' tier, its input gradient (g @ P) too, as
    the JAX package's custom VJP runs both products at the tier; P is a
    constant of the loop."""

    @staticmethod
    def forward(ctx, X, P):
        ctx.save_for_backward(P)
        return bf16_matmul(X, P.transpose(-1, -2))

    @staticmethod
    def backward(ctx, g):
        (P,) = ctx.saved_tensors
        return bf16_matmul(g, P), None


def _projection(X: torch.Tensor, P: torch.Tensor,
                precision: str) -> torch.Tensor:
    if precision == "default":
        return _Bf16Projection.apply(X, P)
    return torch.matmul(X, P.transpose(-1, -2))


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown residual_precision {precision!r} "
                         f"(expected 'highest', 'high', or 'default')")


@contextmanager
def _tier(precision: str):
    """TF32 on for the products of the 'high' tier, restored after."""
    check_precision(precision)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "high"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def tier_product(X: torch.Tensor, P: torch.Tensor,
                 precision: str) -> torch.Tensor:
    """X @ Pᵀ as the residual loop computes it at the `precision` tier.
    At 'default' its gradient is the tier's too (g @ P on bf16 operands);
    at 'high' a gradient taken after the call runs at the caller's TF32
    setting."""
    with _tier(precision):
        return _projection(X, P, precision)


def _log_marginal(X: torch.Tensor, terms: FrozenMixtureTerms,
                  precision: str = "highest") -> torch.Tensor:
    """([S,] B, 2D) → ([S,] B, K): logsumexp over modes of the per-mode
    joints."""
    ljs = [terms.base[..., m, None, :]
           - 0.5 * _projection(X, terms.proj[..., m, :, :], precision)
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
                     terms: FrozenMixtureTerms,
                     precision: str = "highest") -> torch.Tensor:
    x = class_embeddings.to(torch.float32)
    return _loss_tail(_log_marginal(torch.cat([x * x, x], dim=-1), terms,
                                    precision))


def alignment_loss(class_embeddings: torch.Tensor,
                   state: mode_dota.ModeDotaState, epsilon: float,
                   precision: str = "highest") -> torch.Tensor:
    """Alignment loss over L[i, k] = log P(e_i | class k); ([S,]) for
    ([S,] K, D) embeddings.  At 'high' only the forward products run in
    TF32 here: a gradient taken after the call runs at the caller's
    setting (`optimize_residuals` takes it inside the tier)."""
    with _tier(precision):
        return _loss_from_terms(class_embeddings,
                                frozen_mixture_terms(state, epsilon),
                                precision)


def _normalize_rows(t: torch.Tensor) -> torch.Tensor:
    return t / (torch.linalg.norm(t, dim=-1, keepdim=True) + 1e-12)


def optimize_residuals(res_state: ResidualState,
                       text_features_initial: torch.Tensor,
                       mixture: mode_dota.ModeDotaState, lr: float,
                       epsilon: float, num_steps: int = 10,
                       precision: str = "highest") -> ResidualState:
    """`num_steps` Adam updates of the residuals against the frozen mixture:
    each renormalises (initial + residuals) per class row and steps on the
    alignment loss's gradient (S streams: on the sum of their losses,
    each stream's gradient its own), the log-likelihood products at the
    `precision` tier."""
    terms = frozen_mixture_terms(mixture, epsilon)
    corrections = bias_corrections(res_state.count, num_steps)
    with torch.enable_grad(), _tier(precision):
        for i in range(num_steps):
            r = res_state.residuals.detach().requires_grad_(True)
            loss = _loss_from_terms(_normalize_rows(text_features_initial + r),
                                    terms, precision)
            (grads,) = torch.autograd.grad(loss.sum(), r)
            res_state = adam_step(res_state._replace(residuals=r.detach()),
                                  grads, lr, corrections[..., i, :])
    return res_state


def adapted_text_weights(res_state: ResidualState,
                         text_features_initial: torch.Tensor) -> torch.Tensor:
    """clip_weights = normalize(initial + residuals)ᵀ, ([S,] D, K) fp32."""
    text = _normalize_rows(text_features_initial + res_state.residuals.detach())
    return text.to(torch.float32).transpose(-1, -2)
