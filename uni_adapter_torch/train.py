"""Contrastive pretraining of the point encoder (mirror of
`uni_adapter_tpu/train.py`).

A train step distils the point encoder into the frozen CLIP embedding
space (text and image embeddings precomputed by the frozen towers): the
loss of `models/losses.uni3d_text_image_loss`, its gradient by autograd
(on the card the fp32 EVA blocks' attention side through the hand-written
backward of `ops/attention.EvaAttnBlockFunction`), and optax's
`chain(clip_by_global_norm(10), adamw(warmup_cosine_decay_schedule,
mask=decay_mask))` written out in PyTorch to its arithmetic:

  * clipping over (params, logit_scale) together, g·10/‖g‖ only where
    ‖g‖ ≥ 10 (not `clip_grad_norm_`, which divides by ‖g‖ + 1e-6);
  * Adam's moments m = 0.1·g + 0.9·m, v = 0.001·g² + 0.999·v, bias
    corrected by 1 − βᵗ, then m̂ / (√v̂ + 1e-8);
  * the decoupled decay + wd·p on the masked leaves, and the step
    −lr(count)·(...), the schedule taken at the update count before it
    is incremented (with warmup, the first update has lr 0).

Parameters and moments are updated in place (PyTorch's tensors are
mutable; the JAX state is rebuilt each step): `TrainState.params` holds
the model's own parameter tensors.

`make_dp_train_step` is the data-parallel step over a `torch.distributed`
process group, one rank a process: each rank's batch, the negatives
gathered over the ranks inside the loss, the gradients and metrics
averaged over the ranks (JAX's `pmean`), then the same clipped AdamW
update on every rank, so the replicated parameters stay equal.  With
equal local batches it is the single-device step on the global batch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from uni_adapter_torch.models.common import Dense
from uni_adapter_torch.models.losses import uni3d_text_image_loss

#: The optimizer tree's name of the learnt log-scale, beside the model's
#: parameter names.
LOGIT_SCALE = "logit_scale"
#: The clamp of the log-scale after each step, [0, log 100].
MAX_LOG_SCALE = float(math.log(100.0))


class AdamWState(NamedTuple):
    count: int               # updates so far (optax's Adam and schedule counts)
    mu: dict                 # name -> first moment, fp32
    nu: dict                 # name -> second moment, fp32


class TrainState(NamedTuple):
    params: dict             # name -> the model's parameter, updated in place
    logit_scale: torch.Tensor    # () fp32, the learnt log-scale, like CLIP's
    opt_state: AdamWState
    step: int


def decay_mask(model: nn.Module) -> dict:
    """Which leaves of the optimizer tree decay, by what they are, not by
    rank or name suffix: the weight of every Dense (flax's `kernel`
    leaves) and a raw `pc_projection` matrix; not biases, norm gains (the
    port names LayerNorm gains `weight` too), BatchNorm statistics,
    cls_token/cls_pos, nor the logit scale."""
    dense = {f"{m_name}.weight" if m_name else "weight"
             for m_name, m in model.named_modules() if isinstance(m, Dense)}
    mask = {name: name in dense or name.rsplit(".", 1)[-1] == "pc_projection"
            for name, _ in model.named_parameters()}
    if LOGIT_SCALE in mask:
        raise ValueError(f"a model parameter is named {LOGIT_SCALE!r}")
    mask[LOGIT_SCALE] = False
    return mask


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's `chain(clip_by_global_norm(max_norm), adamw(sched,
    weight_decay, mask))` with `sched = warmup_cosine_decay_schedule(0, lr,
    warmup_steps, max(total_steps, warmup_steps + 1))`.  `masked`: decay
    only the leaves `decay_mask` names (the contrastive trainer), else
    every leaf (the dVAE's)."""
    lr: float
    weight_decay: float
    total_steps: int
    warmup_steps: int
    masked: bool = True
    max_norm: float = 10.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def schedule(self, count: int) -> float:
        """The learning rate at update `count`, in fp32 as optax's
        schedule computes it (linear warmup from 0, then cosine to 0)."""
        f32 = torch.float32
        warmup = self.warmup_steps
        decay = max(self.total_steps, warmup + 1) - warmup
        if count < warmup:
            frac = 1 - torch.tensor(max(count, 0), dtype=f32) / warmup
            return ((0.0 - self.lr) * frac + self.lr).item()
        c = torch.tensor(min(count - warmup, decay), dtype=f32)
        cosine = 0.5 * (1 + torch.cos(math.pi * c / decay))
        return (self.lr * ((1 - 0.0) * cosine ** 1.0 + 0.0)).item()

    def init(self, tree: dict) -> AdamWState:
        zeros = {n: torch.zeros_like(t, dtype=torch.float32)
                 for n, t in tree.items()}
        return AdamWState(0, zeros, {n: z.clone() for n, z in zeros.items()})

    def update(self, grads: dict, state: AdamWState, tree: dict,
               decay: Optional[dict] = None,
               g_norm: Optional[torch.Tensor] = None) -> tuple:
        """(updates, new state) for `grads` on `tree` ({name: tensor}, the
        parameters before the step); `decay` ({name: bool}) where
        `masked`.  `g_norm`: the clipping norm where `grads` are one
        rank's part of a sharded tree (its global norm), else ‖grads‖."""
        if self.masked and decay is None:
            raise ValueError("a masked AdamW needs the decay mask")
        if g_norm is None:
            g_norm = 0
            for g in grads.values():
                g_norm = g_norm + torch.sum(g * g)
            g_norm = torch.sqrt(g_norm)
        keep = g_norm < self.max_norm
        count = state.count + 1
        f32 = torch.float32
        dev = g_norm.device
        # βᵗ of fp32 β rounded once to fp32, as XLA's pow gives it (a
        # product of t rounded fp32 factors can be an ulp off, and 1 − βᵗ
        # turns that ulp into 2e-5 of v̂'s correction at t = 3)
        bc1, bc2 = (1 - torch.tensor(float(torch.tensor(b, dtype=f32)) ** count,
                                     dtype=f32).to(dev)
                    for b in (self.b1, self.b2))
        step = -self.schedule(state.count)
        mu, nu, updates = {}, {}, {}
        for name, g in grads.items():
            g = torch.where(keep, g, (g / g_norm) * self.max_norm)
            mu[name] = (1 - self.b1) * g + self.b1 * state.mu[name]
            nu[name] = (1 - self.b2) * (g * g) + self.b2 * state.nu[name]
            u = (mu[name] / bc1) / (torch.sqrt(nu[name] / bc2 + 0.0)
                                    + self.eps)
            if not self.masked or decay[name]:
                u = u + self.weight_decay * tree[name]
            updates[name] = u * step
        return updates, AdamWState(count, mu, nu)


def make_optimizer(lr: float = 1e-3, weight_decay: float = 0.05,
                   total_steps: int = 100_000,
                   warmup_steps: int = 2_000) -> AdamW:
    """AdamW + linear warmup → cosine decay (the open_clip-family recipe);
    weight decay on the matrices only (`decay_mask`)."""
    return AdamW(lr, weight_decay, total_steps, warmup_steps, masked=True)


def init_train_state(model: nn.Module, tx: AdamW,
                     init_logit_scale: float = float(math.log(1 / 0.07))
                     ) -> TrainState:
    """The state of a model whose parameters require grad (e.g.
    `create_uni3d(..., trainable=True)`): its parameters as they are, the
    log-scale at log(1/0.07), zero moments, step 0."""
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    logit_scale = torch.tensor(init_logit_scale, dtype=torch.float32,
                               device=dev)
    tree = {**params, LOGIT_SCALE: logit_scale}
    return TrainState(params, logit_scale, tx.init(tree), 0)


def load_train_state(model: nn.Module, saved: TrainState) -> TrainState:
    """A restored `TrainState` (`checkpoint.restore_state`) made the
    model's: its parameters copied into the model's, the log-scale and the
    moments moved to the model's device."""
    params = dict(model.named_parameters())
    if set(params) != set(saved.params):
        raise ValueError(
            "the checkpoint's parameters do not match the model's: missing "
            f"{sorted(set(params) - set(saved.params))[:5]}, unexpected "
            f"{sorted(set(saved.params) - set(params))[:5]}")
    dev = next(iter(params.values())).device
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(saved.params[name])
    opt = saved.opt_state
    move = lambda d: {n: t.to(dev) for n, t in d.items()}
    return TrainState(params, saved.logit_scale.to(dev),
                      AdamWState(opt.count, move(opt.mu), move(opt.nu)),
                      saved.step)


def _loss_fn(model, logit_scale, pc, text_embed, image_embed, mask,
             axis_name=None):
    pc_embed = model(pc)
    out = uni3d_text_image_loss(pc_embed, text_embed, image_embed,
                                torch.exp(logit_scale), mask=mask,
                                axis_name=axis_name)
    return out["loss"], out


def apply_grads(state: TrainState, tx: AdamW, grads: dict,
                decay: Optional[dict],
                g_norm: Optional[torch.Tensor] = None) -> TrainState:
    """One optimizer step on `grads` ({name: tensor}, the model's names and
    LOGIT_SCALE), in place; then the log-scale clamped to [0, log 100]
    (after the step, never in the forward: a clamp there would zero its
    gradient above the cap).  `g_norm`: `AdamW.update`'s."""
    tree = {**state.params, LOGIT_SCALE: state.logit_scale}
    updates, opt_state = tx.update(grads, state.opt_state, tree, decay,
                                   g_norm)
    with torch.no_grad():
        for name, u in updates.items():
            tree[name].add_(u)
        state.logit_scale.clamp_(0.0, MAX_LOG_SCALE)
    return TrainState(state.params, state.logit_scale, opt_state,
                      state.step + 1)


def loss_grads(model, state: TrainState, inputs: tuple, text_embed,
               image_embed, mask, axis_name=None) -> tuple:
    """(the contrastive loss's gradients by name, its metrics, detached),
    with `model(*inputs)` the point embeddings (a module, or a pipeline
    forward driven to its end, `parallel/pp.py`)."""
    names = [*state.params, LOGIT_SCALE]
    logit_scale = state.logit_scale.detach().requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = _loss_fn(lambda x: model(*x), logit_scale, inputs,
                                 text_embed, image_embed, mask, axis_name)
        grads = torch.autograd.grad(
            loss, [*state.params.values(), logit_scale], allow_unused=True,
            materialize_grads=True)
    return dict(zip(names, grads)), {k: v.detach() for k, v in
                                     metrics.items()}


def train_step(model: nn.Module, tx: AdamW, state: TrainState,
               pc: torch.Tensor, text_embed: torch.Tensor,
               image_embed: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> tuple:
    """One contrastive step on one device.  pc: (B, N, C); embeds: (B, D).
    Returns (the state, updated in place, with step + 1; the loss's
    metrics, detached)."""
    grads, metrics = loss_grads(model, state, (pc,), text_embed,
                                image_embed, mask)
    state = apply_grads(state, tx, grads,
                        decay_mask(model) if tx.masked else None)
    return state, metrics


def make_dp_train_step(model: nn.Module, tx: AdamW, mesh=None):
    """The data-parallel step over `mesh` (a `parallel.mesh.World`, a
    process group, or None for the default group):
    dp_step(state, pc, text_embed, image_embed, mask=None) -> (state,
    metrics) on this rank's rows.  The loss gathers every rank's
    features as negatives; the gradients and the metrics are averaged
    over the ranks (one all-reduce each, of their packed fp32 buffer);
    then `apply_grads`, the same update on every rank.  Without a mask
    the image leg runs masked by ones (the JAX wrapper's default)."""
    from uni_adapter_torch.parallel import collectives
    from uni_adapter_torch.parallel.mesh import World, make_mesh

    group = (mesh.group if isinstance(mesh, World)
             else make_mesh(mesh).group)
    if group is None:
        raise ValueError("make_dp_train_step needs an initialised "
                         "torch.distributed process group")
    decay = decay_mask(model) if tx.masked else None

    def dp_step(state: TrainState, pc: torch.Tensor,
                text_embed: torch.Tensor, image_embed: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> tuple:
        if mask is None:
            mask = torch.ones(pc.shape[0], device=pc.device)
        grads, metrics = loss_grads(model, state, (pc,), text_embed,
                                    image_embed, mask, axis_name=group)
        grads = dict(zip(grads, collectives.pmean(list(grads.values()),
                                                  group)))
        metrics = dict(zip(metrics, collectives.pmean(
            list(metrics.values()), group)))
        return apply_grads(state, tx, grads, decay), metrics

    return dp_step
