"""The dVAE's training loop, the point tokenizer's pretraining stage
(mirror of `uni_adapter_tpu/models/dvae_train.py`).

A train step over `models/dvae.DiscreteVAE` with Point-BERT's schedule
shapes: the Gumbel temperature annealed exponentially 1 → 0.0625 and a
linearly warmed KL weight, both taken from the step count; the optimizer
is `train.AdamW` (clip at 10, AdamW, warmup → cosine) with every leaf
decayed, as the JAX package's `optax.adamw` without a mask.  An epoch is
a Python loop of steps (the JAX package scans them on the device).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from uni_adapter_torch.models.dvae import DiscreteVAE, dvae_loss
from uni_adapter_torch.train import AdamW


class DVAETrainState(NamedTuple):
    params: dict             # name -> the model's parameter, updated in place
    opt_state: object        # train.AdamWState
    step: int


class DVAESchedule(NamedTuple):
    """Point-BERT-style schedules (upstream Point-BERT train config)."""
    temp_start: float = 1.0
    temp_end: float = 0.0625
    temp_anneal_steps: int = 100_000
    kl_weight: float = 0.1
    kl_warmup_steps: int = 10_000


def schedule_at(sched: DVAESchedule, step: int, device=None) -> tuple:
    """(temperature, kl_weight) at `step`, fp32 () tensors on `device`:
    exponential temperature decay, linear KL warmup."""
    f32 = torch.float32
    s = torch.tensor(step, dtype=f32)
    frac = torch.clamp(s / sched.temp_anneal_steps, 0.0, 1.0)
    log_start = torch.log(torch.tensor(sched.temp_start, dtype=f32))
    log_end = torch.log(torch.tensor(sched.temp_end, dtype=f32))
    temp = torch.exp(log_start + frac * (log_end - log_start))
    kl_w = sched.kl_weight * torch.clamp(s / sched.kl_warmup_steps, 0.0, 1.0)
    return temp.to(device), kl_w.to(device)


def make_optimizer(lr: float = 5e-4, weight_decay: float = 1e-4,
                   total_steps: int = 300_000,
                   warmup_steps: int = 3_000) -> AdamW:
    """AdamW + linear warmup → cosine decay, grad-norm clipped at 10,
    every parameter decayed."""
    return AdamW(lr, weight_decay, total_steps, warmup_steps, masked=False)


def init_train_state(model: DiscreteVAE, tx: AdamW) -> DVAETrainState:
    """The state of a trainable model (`dvae.create_dvae`): its parameters
    as they are, zero moments, step 0."""
    params = dict(model.named_parameters())
    return DVAETrainState(params, tx.init(params), 0)


def dvae_train_step(model: DiscreteVAE, tx: AdamW, sched: DVAESchedule,
                    state: DVAETrainState, batch: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    hard: bool = False,
                    gumbel: Optional[torch.Tensor] = None) -> tuple:
    """One optimizer step on a (B, N, 3) batch, the parameters updated in
    place.  The Gumbel noise is `gumbel` where given, else drawn from
    `generator`.  Returns (state with step + 1, metrics)."""
    temp, kl_w = schedule_at(sched, state.step, batch.device)
    names = list(state.params)
    with torch.enable_grad():
        ret = model(batch, generator, temperature=temp, hard=hard,
                    gumbel=gumbel)
        rec, klv = dvae_loss(ret)
        loss = rec + kl_w * klv
        grads = torch.autograd.grad(loss, list(state.params.values()),
                                    allow_unused=True, materialize_grads=True)
    updates, opt_state = tx.update(dict(zip(names, grads)), state.opt_state,
                                   state.params)
    with torch.no_grad():
        for name, u in updates.items():
            state.params[name].add_(u)
    metrics = {"loss": loss.detach(), "recon": rec.detach(),
               "kl": klv.detach(), "temperature": temp, "kl_weight": kl_w}
    return DVAETrainState(state.params, opt_state, state.step + 1), metrics


def train_epoch(model: DiscreteVAE, tx: AdamW, sched: DVAESchedule,
                state: DVAETrainState, batches: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                hard: bool = False) -> tuple:
    """The train step over (T, B, N, 3) pre-batched data, one batch after
    the other.  Returns (state, metrics stacked over the T steps)."""
    history = []
    for batch in batches:
        state, metrics = dvae_train_step(model, tx, sched, state, batch,
                                         generator, hard=hard)
        history.append(metrics)
    return state, {k: torch.stack([m[k] for m in history])
                   for k in history[0]}
