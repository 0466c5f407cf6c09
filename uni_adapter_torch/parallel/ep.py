"""Class-sharded ("expert-parallel") adaptation over a torch.distributed
process group (mirror of `uni_adapter_tpu/parallel/ep.py`).

At Objaverse-LVIS scale (K = 1156 classes) the adaptation's work and
state grow with K: the mixture's likelihood products, the residual
loop's (K, 2D)·(2D, K) contractions, plain DOTA's (K, D, D) covariances,
the cache's (K, C, K) probabilities and its class graph.  All of it is
class-local but for a few cross-class sums, so the class axis splits over
the ranks of a process group:

  * each rank holds a contiguous block of K_pad/n classes of the state
    and of the anchors, K_pad = ⌈K/n⌉·n (`pad_classes`: the pad rows are
    unit e_0 anchors whose columns are sliced off before any softmax, so
    the pad classes stay at their init and the trajectory is that of the
    unpadded problem);
  * the batch is replicated: every rank consumes the same stream step,
    so the adaptation order is the single-process order, and every rank
    draws the same noise (each rank's generator is seeded alike, where
    'psum' seeds `seed + rank`);
  * the collectives are the step's parts' requests
    (`collectives.Collective`, issued by `engine.drive` or between a
    captured step's segments): gathers of logit column blocks (the
    CLIP logits and the method's scores in one request), sums of the few
    cross-class scalars (the fusion weight's mean count, GMM's total
    count, plain DOTA's mean covariance), and in the residual loop the
    gathers of x = normalize(text + r) and of the log-marginal, and the
    sum of its input gradient.

Every method shards (`make_ep_step_fn`): MODE-DOTA (optionally with each
rank encoding ⌈2B/n⌉ rows of the fused batch, `shard_encoder`), plain
DOTA, GMM-DOTA, adaptive-modes DOTA and the prototype cache, whose
insert-or-merge broadcasts the owner's row by single-contributor sums and
whose graph refinement splits the adjacency and the CG's product by rows
(the CG's state replicated, the product gathered every iteration).

`run_stream_ep` runs one stream, `run_streams_ep` independent streams on
a 2-D grid of ranks (DP × EP: a class group per data row, a data group
per class column).  Both return full-K states, gathered on every rank,
interchangeable with the replicated engine's.  On the card the step is
captured in segments with the collectives between their replays
(`engine._StreamRunner`), gloo's and NCCL's alike.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from uni_adapter_torch import engine
from uni_adapter_torch.adapt import (adaptive, cache, dota, fusion, gmm,
                                     mode_dota, residual)
from uni_adapter_torch.config import Config
from uni_adapter_torch.parallel import collectives
from uni_adapter_torch.parallel import mesh as pmesh
from uni_adapter_torch.parallel.mesh import World, make_mesh
from uni_adapter_torch.utils import math as umath
from uni_adapter_torch.utils.math import normalized_entropy, softmax_entropy
from uni_adapter_torch.utils.metrics import topk_correct


class ClassShard(NamedTuple):
    """This rank's block of the class axis: the class group (None: this
    process alone), the rank in it, the group's size, and the real class
    count K."""
    group: Optional[object]
    rank: int
    n: int
    num_classes: int

    @property
    def k_local(self) -> int:
        return -(-self.num_classes // self.n)

    @property
    def k_pad(self) -> int:
        return self.k_local * self.n

    @property
    def offset(self) -> int:
        return self.rank * self.k_local

    @property
    def real(self) -> int:
        """This rank's real classes (its first rows; the rest are pads)."""
        return max(0, min(self.k_local, self.num_classes - self.offset))

    def real_sum(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """`t` summed over its class axis `dim`, on the real rows only (a
        cross-class statistic never counts the pad classes)."""
        return t.narrow(dim, 0, self.real).sum(dim=dim)

    def local_cols(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a (..., K) tensor, pad columns zero."""
        t = F.pad(t, (0, self.k_pad - self.num_classes))
        return t[..., self.offset:self.offset + self.k_local]


def class_shard(world: Optional[World], num_classes: int) -> ClassShard:
    world = world or make_mesh()
    return ClassShard(world.group, world.rank, world.size, num_classes)


def pad_classes(text: torch.Tensor, n_shards: int):
    """(K, D) anchors padded to K_pad = ⌈K/n⌉·n rows of unit e_0 vectors
    (valid Gaussians to init the frozen pad classes from, never scored);
    returns (padded anchors, K_pad)."""
    K, D = text.shape
    k_pad = -(-K // n_shards) * n_shards
    if k_pad != K:
        pad = text.new_zeros((k_pad - K, D))
        pad[:, 0] = 1.0
        text = torch.cat([text, pad])
    return text, k_pad


# ---- the parts' collectives ----------------------------------------------

def _gather(shard: ClassShard, t: torch.Tensor, dim: int):
    """Parts: the ranks' blocks of `t` concatenated along `dim`."""
    req = collectives.gather_request(t.movedim(dim, 0), shard.n)
    yield req
    return req.out.movedim(0, dim)


def _gather_classes(shard: ClassShard, t: torch.Tensor):
    """Parts: the column blocks of a (..., K_local) tensor as (..., K),
    the pad columns sliced off."""
    full = yield from _gather(shard, t, -1)
    return full[..., :shard.num_classes]


def _psum(t: torch.Tensor):
    """Parts: `t` summed over the class group (a copy, in fp32)."""
    req = collectives.Collective("sum", t.to(torch.float32).clone(
        memory_format=torch.contiguous_format))
    yield req
    return req.buf


def _psum_many(*ts: torch.Tensor):
    """Parts: each of `ts` summed over the group, in one request."""
    flat = yield from _psum(collectives.pack(ts))
    return collectives.unpack(flat, ts)


# ---- the residual loop ---------------------------------------------------

def residual_gradient_sharded(residuals_local: torch.Tensor,
                              text_init_local: torch.Tensor,
                              terms: residual.FrozenMixtureTerms,
                              shard: ClassShard, precision: str = "highest"):
    """Parts: the alignment loss's gradient at this rank's block of
    residual rows, against its block of the frozen mixture's `terms`.

    Autograd cannot span a collective, so the gradient is taken in
    pieces: (1) x = normalize(text + r), gathered by rows; (2) this
    rank's columns of the log-marginal lm(x), gathered; (3) on every rank
    the loss tail of the whole (K, K) lm and its gradient, then the VJP
    of this rank's columns to a (K_pad, D) dx; (4) dx summed over the
    group (JAX's psum_scatter, as an all-reduce then this rank's rows);
    (5) the VJP of the normalisation.  The products run at the
    `precision` tier; pad rows take a zero gradient."""
    K, off, kl = shard.num_classes, shard.offset, shard.k_local
    with torch.enable_grad():
        r = residuals_local.detach().requires_grad_(True)
        x_local = residual._normalize_rows(
            text_init_local.to(torch.float32) + r)
    x = yield from _gather(shard, x_local.detach(), -2)
    with torch.enable_grad(), residual._tier(precision):
        xg = x[..., :K, :].detach().requires_grad_(True)
        lm_local = residual._log_marginal(torch.cat([xg * xg, xg], -1),
                                          terms, precision)
    lm = yield from _gather_classes(shard, lm_local.detach())
    with torch.enable_grad():
        # contiguous, as the replicated loop's lm: the tail's sums then
        # reduce in the same order
        lmg = lm.contiguous().requires_grad_(True)
        (dlm,) = torch.autograd.grad(residual._loss_tail(lmg).sum(), lmg)
    with residual._tier(precision):
        (dx,) = torch.autograd.grad(lm_local, xg, shard.local_cols(dlm))
    dx = yield from _psum(F.pad(dx, (0, 0, 0, shard.k_pad - K)))
    (grads,) = torch.autograd.grad(x_local, r, dx[..., off:off + kl, :])
    return grads


def optimize_residuals_sharded(res_state: residual.ResidualState,
                               text_init_local: torch.Tensor,
                               mixture_local: mode_dota.ModeDotaState,
                               lr: float, epsilon: float,
                               shard: ClassShard, num_steps: int = 10,
                               precision: str = "highest"):
    """Parts: `num_steps` Adam updates of this rank's block of residual
    rows against its block of the frozen mixture (JAX
    `optimize_residuals_sharded`): each on `residual_gradient_sharded`'s
    gradient.  Pad rows take a zero gradient and stay."""
    terms = residual.frozen_mixture_terms(mixture_local, epsilon)
    corrections = residual.bias_corrections(res_state.count, num_steps)
    for i in range(num_steps):
        grads = yield from residual_gradient_sharded(
            res_state.residuals, text_init_local, terms, shard, precision)
        res_state = residual.adam_step(res_state, grads, lr,
                                       corrections[..., i, :])
    return res_state


# ---- the DOTA-family steps -----------------------------------------------

def _encode_fused(encode, shard: ClassShard, pcs, rgbs, shard_encoder):
    """Parts: the features of the (R, N, 3) clouds; with `shard_encoder`
    each rank encodes ⌈R/n⌉ rows of the batch zero-padded to a multiple
    of n, and the features are gathered (the pad rows sliced off)."""
    if not shard_encoder:
        return (yield from engine.encoded(encode, pcs, rgbs))
    total = pcs.shape[0]
    chunk = -(-total // shard.n)
    pad = chunk * shard.n - total
    if pad:
        pcs = torch.cat([pcs, pcs.new_zeros((pad, *pcs.shape[1:]))])
        rgbs = torch.cat([rgbs, rgbs.new_zeros((pad, *rgbs.shape[1:]))])
    rows = slice(shard.rank * chunk, (shard.rank + 1) * chunk)
    feat = yield from engine.encoded(encode, pcs[rows], rgbs[rows])
    feat = yield from _gather(shard, feat, 0)
    return feat[:total]


def _mode_dota_step(cfg: Config, encode, shard: ClassShard,
                    shard_encoder: bool) -> engine.Step:
    """MODE-DOTA's class-sharded step (JAX `make_ep_step_fn`'s MODE-DOTA
    branch): the fused clean + noisy forward, this rank's CLIP logits and
    predict scores gathered in one request, the double fit on this
    rank's rows of the zero-shot prob_map (no collective), the residual
    loop after the first step, and the fusion weight's mean count summed
    over the real rows."""
    dc, scale = cfg.dota, cfg.model.logit_scale
    use_res = dc.res_learning
    if use_res:
        residual.check_precision(dc.residual_precision)
    K, M = shard.num_classes, dc.mode_M

    @torch.no_grad()
    def parts(text_local: torch.Tensor, state: engine.EngineState, batch,
              noise: Optional[torch.Tensor] = None):
        pc, rgb, target = batch
        text_local = text_local.to(torch.float32)
        clip_w = (residual.adapted_text_weights(state.res_state, text_local)
                  if use_res else text_local.T)
        *lead, B, N, _ = pc.shape
        if noise is None:
            def draw(gen, shape):
                return torch.randn(shape, generator=gen, device=pc.device,
                                   dtype=pc.dtype)
            noise = (torch.stack([draw(g, pc.shape[1:])
                                  for g in state.generator]) if lead
                     else draw(state.generator, pc.shape))
        pc_aug = pc + dc.noise_std * noise
        feat_both = yield from _encode_fused(
            encode, shard,
            torch.cat([pc.reshape(-1, N, 3), pc_aug.reshape(-1, N, 3)]),
            torch.cat([rgb.reshape(-1, N, 3)] * 2), shard_encoder)
        n = feat_both.shape[0] // 2
        feat = feat_both[:n].reshape(*lead, B, -1)
        feat_aug = feat_both[n:].reshape(*lead, B, -1)

        ms = state.method_state
        blocks = [scale * torch.matmul(feat.to(torch.float32), clip_w),
                  mode_dota.predict(ms, engine._predict_input(
                      feat, dc.fp16_predict_input), dc.epsilon)]
        if use_res:     # the frozen anchors' logits, for zs_correct
            blocks.append(scale * torch.matmul(feat.to(torch.float32),
                                               text_local.T))
        full = yield from _gather_classes(shard, torch.cat(blocks, -2))
        clip_logits, dota_logits = full[..., :B, :], full[..., B:B + 1, :]
        zs_logits = full[..., B + 1:, :] if use_res else clip_logits
        prob_local = shard.local_cols(torch.softmax(clip_logits, dim=-1))
        ms = mode_dota.fit(ms, feat, prob_local, dc.epsilon)
        # the noise-augmented fit uses the CLEAN prob_map
        ms = mode_dota.fit(ms, feat_aug, prob_local, dc.epsilon)

        res_state = state.res_state
        gates = engine._gates(state.step)
        if use_res and any(gates):
            res_state = yield from optimize_residuals_sharded(
                res_state, text_local, ms, dc.residual_lr, dc.epsilon,
                shard, num_steps=dc.residual_steps,
                precision=dc.residual_precision)
            if not all(gates):
                res_state = engine._select_streams(gates, res_state,
                                                   state.res_state)

        c_sum = yield from _psum(shard.real_sum(ms.c, -2).sum(dim=-1))
        w = fusion.dota_fusion_weight(dc.rho, dc.eta, c_sum / (K * M),
                                      float(B))
        final = fusion.fuse_mode_dota(
            clip_logits, dota_logits, w,
            fix_normalization=dc.fix_fusion_normalization)
        out = engine.StepOutput(final, clip_logits,
                                topk_correct(final, target, (1, 3, 5)),
                                topk_correct(zs_logits, target, (1, 3, 5)))
        return engine.EngineState(ms, res_state,
                                  engine._next_step(state.step),
                                  state.generator), out

    return engine.Step(parts, shard.group)


def _variant_step(cfg: Config, encode, shard: ClassShard) -> engine.Step:
    """The class-sharded step of plain DOTA, GMM-DOTA or adaptive-modes
    DOTA (JAX `_make_{dota,gmm,adaptive}_step`): one forward, this rank's
    CLIP logits and scores gathered in one request, the fit on this
    rank's rows, and the cross-class sums: GMM's total count before its
    predict, plain DOTA's mean covariance (Σ̄ over the real classes, then
    Λ on every rank by Cholesky) with the fusion weight's mean count."""
    dc, scale = cfg.dota, cfg.model.logit_scale
    K = shard.num_classes
    kind = ("dota" if dc.use_dota else "gmm" if dc.use_gmm_dota
            else "adaptive")

    @torch.no_grad()
    def parts(text_local: torch.Tensor, state: engine.EngineState, batch,
              noise=None):
        del noise           # the variants draw none
        pc, rgb, target = batch
        text_local = text_local.to(torch.float32)
        *lead, B, N, _ = pc.shape
        feat = yield from engine.encoded(encode, pc.reshape(-1, N, 3),
                                         rgb.reshape(-1, N, 3))
        feat = feat.reshape(*lead, B, -1)
        logits_local = scale * torch.matmul(feat.to(torch.float32),
                                            text_local.T)
        ms = state.method_state
        mean_feat = feat.mean(dim=-2, keepdim=True)
        if kind == "dota":
            scores = dota.predict(ms, engine._predict_input(
                feat, dc.fp16_predict_input))
        elif kind == "gmm":
            total = yield from _psum(shard.real_sum(ms.class_counts, -1))
            scores = gmm.predict(ms, mean_feat, alpha_max=dc.alpha_max,
                                 num_classes=K, total_counts=total)
        else:
            scores = adaptive.predict(ms, mean_feat, dc.epsilon)
        full = yield from _gather_classes(
            shard, torch.cat([logits_local, scores], -2))
        clip_logits, scores = full[..., :B, :], full[..., B:, :]
        prob_map = torch.softmax(clip_logits, dim=-1)
        prob_local = shard.local_cols(prob_map)
        if kind == "dota":
            if dc.prior_pre_steps is not None:
                prior = (ms.cum_soft_labels[..., :K]
                         + dc.prior_pre_steps / K) / (
                    dc.prior_pre_steps + ms.prior_step[..., None, None])
                scores = scores + torch.log(prior + 1e-10)
            ms = dota.fit_merge(
                ms, dota.fit_stats(ms.mu, feat, prob_local), B,
                prior_sum=F.pad(prob_map.sum(dim=-2),
                                (0, shard.k_pad - K)))
            sigma_sum, c_sum = yield from _psum_many(
                shard.real_sum(ms.sigma, -3), shard.real_sum(ms.c, -1))
            ms = ms._replace(lam=dota.shared_precision(sigma_sum / K,
                                                       dc.epsilon))
            counts = c_sum / K
        elif kind == "gmm":
            ms = gmm.update(gmm.fit(ms, feat, prob_local), dc.epsilon)
            c_sum = yield from _psum(
                shard.real_sum(gmm.class_counts_per_class(ms), -1))
            counts = c_sum / K
        else:
            sigma_init = mode_dota.resolve_sigma_init(dc.sigma,
                                                      text_local.shape[1])
            ms = adaptive.fit(ms, feat, prob_local, dc.epsilon,
                              split_threshold=10.0 * sigma_init)
            c_sum = yield from _psum(shard.real_sum(ms.c, -2).sum(dim=-1))
            counts = c_sum / (K * ms.c.shape[-1])
        w = fusion.dota_fusion_weight(dc.rho, dc.eta, counts, float(B))
        if kind == "dota":
            final = fusion.fuse_dota(clip_logits, scores, w)
        else:
            final = fusion.fuse_mode_dota(
                clip_logits, scores, w,
                fix_normalization=dc.fix_fusion_normalization)
        out = engine.StepOutput(final, clip_logits,
                                topk_correct(final, target, (1, 3, 5)),
                                topk_correct(clip_logits, target, (1, 3, 5)))
        return engine.EngineState(ms, None, engine._next_step(state.step),
                                  state.generator), out

    return engine.Step(parts, shard.group)


# ---- the prototype cache -------------------------------------------------

class ShardedRefinement(NamedTuple):
    """A class-sharded refinement under way: this rank's rows of the
    system matrix (n_local, N) and of the graph's nodes, their validity,
    every node's validity (N,), the CG's replicated carry (None: the
    explicit solve) and the replicated (N, K) solution."""
    A_local: torch.Tensor
    nodes_local: torch.Tensor
    valid_local: torch.Tensor
    vmask_full: torch.Tensor
    cg: Optional[umath.CGState]
    sol: torch.Tensor


class ShardedCacheStep(engine.CacheStep):
    """The prototype cache's class-sharded step (JAX `_make_cache_step`)
    in the three parts of `engine.CacheStep`, each a parts generator:
    `head` (the forward, the gathered CLIP logits, the owner's
    insert-or-merge, the row-sharded graph system and the CG's start or
    the explicit solve), the CG's `iteration` (this rank's rows of A·p,
    gathered) and `tail` (the readout, its counts and logits summed over
    the node blocks, and the fusion)."""

    def __init__(self, cfg: Config, encode, shard: ClassShard):
        self.cc, self.scale = cfg.cache, cfg.model.logit_scale
        self.encode, self.shard, self.group = encode, shard, shard.group

    @torch.no_grad()
    def head(self, text_local: torch.Tensor, state: engine.EngineState,
             batch):
        cc, scale, shard = self.cc, self.scale, self.shard
        K = shard.num_classes
        pc, rgb, target = batch
        *lead, B, N, _ = pc.shape
        if B != 1:
            raise ValueError(
                f"the prototype-cache path requires batch_size=1 (got {B}): "
                f"one sample a step enters the cache")
        clip_w = text_local.to(torch.float32).T
        feat = yield from engine.encoded(self.encode, pc.reshape(-1, N, 3),
                                         rgb.reshape(-1, N, 3))
        feat = feat.reshape(*lead, B, -1)
        clip_logits = yield from _gather_classes(
            shard, scale * torch.matmul(feat.to(torch.float32), clip_w))
        ent = softmax_entropy(clip_logits)
        pred = torch.argmax(clip_logits[..., 0, :], dim=-1)
        cs = yield from _update_cache(
            state.method_state, shard, pred, feat[..., :1, :],
            normalized_entropy(ent[..., 0], K),
            torch.softmax(clip_logits, dim=-1)[..., :1, :], clip_w,
            cc.beta, scale)
        ref = yield from _start_refinement(cs, shard, cc.threshold,
                                           cc.lambda_reg,
                                           cc.use_new_approximation,
                                           cc.graph_mode)
        return engine._CacheContext(feat, clip_logits, target, cs, ref)

    @torch.no_grad()
    def iteration(self, ctx):
        ref = ctx.ref
        Ap = yield from _gather(self.shard,
                                torch.matmul(ref.A_local, ref.cg.p), -2)
        return umath.cg_update_(ref.cg, Ap)

    @torch.no_grad()
    def tail(self, state: engine.EngineState, ctx):
        ref = ctx.ref
        cache_logits = yield from _readout(ctx.feat, ref, self.shard)
        final = fusion.fuse_cache(ctx.clip_logits, cache_logits,
                                  logit_scale=self.scale)
        out = engine.StepOutput(
            final, ctx.clip_logits, topk_correct(final, ctx.target, (1, 3, 5)),
            topk_correct(ctx.clip_logits, ctx.target, (1, 3, 5)),
            None if ref.cg is None else ref.cg.iters)
        return engine.EngineState(ctx.method_state, None,
                                  engine._next_step(state.step),
                                  state.generator), out


def _update_cache(s: cache.CacheState, shard: ClassShard, pred, feat,
                  prop_ent, prob_map, clip_w_local, beta: float,
                  logit_scale: float):
    """Parts: `cache.update_cache` on the class-sharded cache (JAX
    `_ep_update_cache`).  One rank owns the predicted class's row: its
    row (validity count, similarities, prototypes, confidences, counts)
    reaches every rank by one sum to which only the owner contributes
    (bitwise the owner's values), every rank computes the merge
    candidate on them, and its probabilities come from its gathered
    logits over all classes; only the owner writes.  Both the insert and
    the merge are computed and `torch.where` picks, as the replicated
    update does."""
    lead = pred.shape
    K, kl, off = shard.num_classes, shard.k_local, shard.offset
    C, D = s.feats.shape[-2:]
    feats, conf, probs, counts, valid = (
        t.reshape(-1, *t.shape[len(lead):]) for t in s)
    L = feats.shape[0]
    li = torch.arange(L, device=feats.device)
    cls = pred.reshape(L).long()
    in_block = (cls >= off) & (cls < off + kl)
    o = in_block.to(torch.float32)
    lp = torch.clamp(cls - off, 0, kl - 1)
    confidence = torch.exp(-beta * prop_ent.reshape(L))
    feat = feat.reshape(L, -1, D)[:, 0].to(torch.float32)          # (L, D)
    prob_pad = F.pad(prob_map.reshape(L, -1, K)[:, 0].to(torch.float32),
                     (0, shard.k_pad - K))                          # (L, K_pad)

    row = feats[li, lp]                                             # (L, C, D)
    ow = o[:, None]
    n_valid, sims, row, conf_row, count_row = yield from _psum_many(
        o * valid[li, lp].to(torch.float32).sum(dim=-1),
        ow * torch.matmul(row, feat[:, :, None])[..., 0],
        ow[..., None] * row, ow * conf[li, lp], ow * counts[li, lp])
    n_valid = n_valid.long()
    has_room = n_valid < C
    m = cache.merge_slot(sims)
    feat_c, conf_c, count_c = row[li, m], conf_row[li, m], count_row[li, m]
    denom = count_c * conf_c + confidence
    weighted = ((conf_c * count_c)[:, None] * feat_c
                + confidence[:, None] * feat) / torch.where(
                    denom > 0.0, denom, 1.0)[:, None]
    new_feat = torch.where((denom > 0.0)[:, None], weighted,
                           (count_c[:, None] * feat_c + feat)
                           / (count_c + 1.0)[:, None])
    new_feat = new_feat / (torch.linalg.norm(new_feat, dim=-1, keepdim=True)
                           + 1e-12)
    lg = yield from _gather_classes(
        shard, logit_scale * torch.matmul(new_feat, clip_w_local))  # (L, K)
    new_prob = F.pad(torch.softmax(lg, dim=-1), (0, shard.k_pad - K))
    new_conf = torch.exp(-beta * normalized_entropy(softmax_entropy(lg), K))

    slot = torch.where(has_room, n_valid, m)
    room = has_room[:, None]
    idx = (li, lp, slot)

    def owner_write(t, val):
        keep = in_block.reshape(L, *([1] * (val.dim() - 1)))
        return t.index_put(idx, torch.where(keep, val, t[idx]))

    out = cache.CacheState(
        owner_write(feats, torch.where(room, feat, new_feat)),
        owner_write(conf, torch.where(has_room, confidence, new_conf)),
        owner_write(probs, torch.where(room, prob_pad, new_prob)),
        owner_write(counts, torch.where(has_room, 1.0, count_c + 1.0)),
        owner_write(valid, torch.ones_like(has_room)))
    return cache.CacheState(*(t.reshape(*lead, *t.shape[1:]) for t in out))


def _start_refinement(s: cache.CacheState, shard: ClassShard,
                      threshold: float, lambda_reg: float,
                      use_new_approximation: bool, graph_mode: str):
    """Parts: the row-sharded graph system (JAX `_sharded_refinement`'s
    set-up): this rank's nodes (its classes' K_local·C slots, or K_local
    prototypes), their rows of the cosine adjacency against all nodes
    (gathered with their validity and probabilities in one request), the
    degrees gathered, this rank's rows of the regularised Laplacian; then
    the CG's start, or the whole system gathered for the explicit
    solve.  The graph mode is chosen on the global node count."""
    K = shard.num_classes
    C, D = s.feats.shape[-2:]
    lead = s.feats.shape[:-3]
    if graph_mode == "auto":
        graph_mode = "dense" if K * C <= 4096 else "prototype"
    if graph_mode == "prototype":
        nodes, probs, valid = cache._class_prototypes(s)
    elif graph_mode == "dense":
        nodes = s.feats.reshape(*lead, -1, D)
        probs = s.probs.reshape(*lead, nodes.shape[-2], -1)
        valid = s.valid.reshape(*lead, -1)
    else:
        raise ValueError(f"unknown graph_mode {graph_mode!r} "
                         "(expected 'auto', 'dense', or 'prototype')")
    probs = probs[..., :K]
    n_local = nodes.shape[-2]
    n_total = n_local * shard.n
    off = shard.rank * n_local
    normed = nodes / (torch.linalg.norm(nodes, dim=-1, keepdim=True) + 1e-12)
    vmask = valid.to(torch.float32)
    full = yield from _gather(
        shard, torch.cat([normed, vmask[..., None], probs * vmask[..., None]],
                         -1), -2)
    normed_full, vmask_full = full[..., :D], full[..., D]
    b_full = 2.0 * lambda_reg * full[..., D + 1:]
    W = torch.matmul(normed, normed_full.transpose(-1, -2))
    W = torch.where(W < threshold, 0.0, W)
    W = W * vmask[..., :, None] * vmask_full[..., None, :]
    deg = yield from _gather(shard, W.sum(dim=-1), -1)
    dis_full = 1.0 / (torch.sqrt(deg) + 1e-8)
    dis = dis_full[..., off:off + n_local]
    eye = F.one_hot(off + torch.arange(n_local, device=W.device),
                    n_total).to(W.dtype)
    A = (eye - dis[..., :, None] * W * dis_full[..., None, :]
         + 2.0 * lambda_reg * eye)
    if use_new_approximation:
        cg = umath.cg_start(b_full)
        return ShardedRefinement(A, nodes, valid, vmask_full, cg, cg.x)
    A_full = yield from _gather(shard, A, -2)
    return ShardedRefinement(A, nodes, valid, vmask_full, None,
                             umath.solve_explicit(A_full, b_full))


def _readout(pc_features: torch.Tensor, ref: ShardedRefinement,
             shard: ClassShard):
    """Parts: `cache.graph_readout` over the node blocks: this rank's
    rows of the refined labels as one-hot values, count-normalised by
    the counts summed over all nodes, read out by this rank's affinities
    and summed over the ranks."""
    K = shard.num_classes
    n_local = ref.nodes_local.shape[-2]
    off = shard.rank * n_local
    refined = umath.refined_labels(ref.sol, ref.vmask_full)
    refined = refined[..., off:off + n_local, :]
    node_valid = ref.valid_local[..., None].to(torch.float32)
    values = F.one_hot(torch.argmax(refined, dim=-1), K).to(torch.float32)
    values = values * node_valid
    counts = yield from _psum(values.sum(dim=-2, keepdim=True))
    values = values / (counts + 1e-6)
    pc = pc_features / (torch.linalg.norm(pc_features, dim=-1, keepdim=True)
                        + 1e-12)
    affinity = torch.matmul(pc.to(torch.float32),
                            ref.nodes_local.transpose(-1, -2))
    affinity = affinity * node_valid.transpose(-1, -2)
    logits = yield from _psum(torch.matmul(affinity, values))
    return logits


def make_ep_step_fn(cfg: Config, model, shard: ClassShard,
                    shard_encoder: bool = False,
                    encode_fn: Optional[Callable] = None):
    """The class-sharded step of `cfg`'s method on this rank's block
    `shard`: `engine.Step` of the DOTA family, step(text_local, state,
    batch, noise=None), or `ShardedCacheStep`.  `shard_encoder` splits
    MODE-DOTA's fused encoder batch over the class group; the methods of
    one forward a step raise, as the JAX package does.  `encode_fn`
    replaces the model's forward (`engine.make_step_fn`): EP × TP, a
    trunk sharded over a model group of its own
    (`tp.make_tp_encode_fn`), its sums yielded with the class group's
    collectives."""
    encode = (encode_fn if encode_fn is not None
              else engine.encode_with(cfg.model.vlm3d, model))
    dc = cfg.dota
    what = None
    if engine.uses_cache(cfg):
        what = ("the cache path runs one batch-1 forward per step "
                "(get_logits_wrapper coerces pred to an int, "
                "Uni_Adapter.py:72) — nothing to split")
    elif not dc.use_mode_dota:
        name = ("plain DOTA" if dc.use_dota else "GMM-DOTA"
                if dc.use_gmm_dota else "adaptive-DOTA")
        what = f"{name} runs one forward per step — nothing to split"
    if shard_encoder and what is not None:
        raise ValueError("shard_encoder requires the fused 2-forward "
                         f"MODE-DOTA batch; {what}")
    if engine.uses_cache(cfg):
        return ShardedCacheStep(cfg, encode, shard)
    if not dc.use_mode_dota:
        return _variant_step(cfg, encode, shard)
    return _mode_dota_step(cfg, encode, shard, shard_encoder)


# ---- the state: padding, the rank's block, the gather back ---------------

#: Leaves that every rank holds whole although they are tensors: the
#: generator, plain DOTA's shared precision (D, D) and its cumulative
#: prior (1, K_pad: the class axis trails).  Matched by exact name.
_REPLICATED_NAMES = frozenset({"generator", "rng", "lam", "cum_soft_labels"})
#: Leaves whose last axis is the padded class axis.
_PADDED_TAIL_NAMES = frozenset({"probs", "cum_soft_labels"})


def _is_replicated_path(path: tuple) -> bool:
    return any(name in _REPLICATED_NAMES for name in path)


def _is_class_leaf(path: tuple, leaf: torch.Tensor) -> bool:
    """K-leading leaves shard over the class group; counts (step, t, the
    Adam count) and the `_REPLICATED_NAMES` leaves replicate."""
    return leaf.dim() > 0 and not _is_replicated_path(path)


def _is_stacked_class_leaf(path: tuple, leaf: torch.Tensor) -> bool:
    """The same with a stream axis in front: class leaves are (S, K, ...);
    counts are () or (S,)."""
    return leaf.dim() > 1 and not _is_replicated_path(path)


def _has_padded_class_tail(path: tuple) -> bool:
    return any(name in _PADDED_TAIL_NAMES for name in path)


def _map_leaves(state: engine.EngineState, fn) -> engine.EngineState:
    """The carry with fn(path, tensor) applied to every tensor, path the
    tuple of field names ('method_state', 'mu')."""
    ms, rs = state.method_state, state.res_state
    return dataclasses.replace(
        state,
        method_state=type(ms)(*(fn(("method_state", f), t)
                                for f, t in zip(ms._fields, ms))),
        res_state=None if rs is None else type(rs)(*(
            fn(("res_state", f), t) for f, t in zip(rs._fields, rs))))


def leaf_classification(state: engine.EngineState) -> dict:
    """{'method_state.mu': True, ...}: whether each tensor of a
    single-stream carry shards over the class group."""
    out = {}

    def note(path, t):
        out[".".join(path)] = _is_class_leaf(path, t)
        return t

    _map_leaves(state, note)
    out["generator"] = _is_class_leaf(("generator",), torch.zeros(2))
    return out


def local_padded_state(cfg: Config, text: torch.Tensor, shard: ClassShard,
                       seed: int = 42,
                       initial_state: Optional[engine.EngineState] = None
                       ) -> engine.EngineState:
    """This rank's block of the padded single-stream carry.  A fresh init
    on this rank's anchor rows gives every row of the block (every
    method's init is row by row but GMM-DOTA's); the trailing class axes
    (cache probs, DOTA's cumulative prior) span K_pad.  GMM-DOTA's
    perturbation is drawn for the real K from a generator seeded `seed`,
    as the replicated init draws it, and this rank keeps its rows (pad
    rows: no perturbation; soft counts 1/(K·M)).  With `initial_state`
    (a full-K carry) the real rows, the replicated leaves, the step and
    the generator are the carry's."""
    K = shard.num_classes
    off, kl = shard.offset, shard.k_local
    text_local = pad_classes(text.to(torch.float32), shard.n)[0][off:off + kl]
    st = engine.init_state(cfg, text_local, seed)
    ms, dev = st.method_state, text.device
    if isinstance(ms, cache.CacheState):
        ms = ms._replace(probs=ms.probs.new_zeros((*ms.probs.shape[:-1],
                                                  shard.k_pad)))
    elif isinstance(ms, dota.DOTAState):
        ms = ms._replace(cum_soft_labels=ms.cum_soft_labels.new_zeros(
            (1, shard.k_pad)))
    elif isinstance(ms, gmm.GMMDotaState):
        dc = cfg.dota
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        full = gmm.init(dc.epsilon, dc.sigma, text.shape[1], K,
                        text.to(torch.float32).T, num_modes=dc.mode_M,
                        generator=gen)
        real = shard.real
        mu = text_local[:, None, :].expand_as(ms.mu).clone()
        mu[:real] = full.mu[off:off + real]
        ms = ms._replace(mu=mu, C=torch.full_like(ms.C,
                                                  1.0 / (K * dc.mode_M)))
        st = dataclasses.replace(st, generator=gen)
    st = dataclasses.replace(st, method_state=ms)
    if initial_state is None:
        return st
    real = shard.real

    def splice(path, given, init):
        given = given.to(init.device)
        if _has_padded_class_tail(path):
            given = F.pad(given, (0, init.shape[-1] - given.shape[-1]))
        if not _is_class_leaf(path, init):
            return given.clone()
        out = init.clone()
        out[:real] = given[off:off + real]
        return out

    given = initial_state
    ms0, rs0 = st.method_state, st.res_state
    return engine.EngineState(
        type(ms0)(*(splice(("method_state", f), g, i) for f, g, i in
                    zip(ms0._fields, given.method_state, ms0))),
        None if rs0 is None else type(rs0)(*(
            splice(("res_state", f), g, i) for f, g, i in
            zip(rs0._fields, given.res_state, rs0))),
        given.step, engine.copy_generator(given.generator))


def make_padded_state(cfg: Config, text: torch.Tensor, seed: int = 42,
                      n_shards: int = 1,
                      initial_state: Optional[engine.EngineState] = None
                      ) -> engine.EngineState:
    """The whole padded carry (K_pad = ⌈K/n⌉·n rows) of `n_shards`
    ranks: their blocks of `local_padded_state` side by side.  A serving
    client's carry, and the state a snapshot re-pads into."""
    K = text.shape[0]
    blocks = [local_padded_state(cfg, text, ClassShard(None, r, n_shards, K),
                                 seed, initial_state)
              for r in range(n_shards)]

    def join(path, t):
        if not _is_class_leaf(path, t):
            return t
        part, name = path
        return torch.cat([getattr(getattr(b, part), name) for b in blocks])

    return _map_leaves(blocks[0], join)


def gather_state(state: engine.EngineState, shard: ClassShard,
                 stacked: bool = False) -> engine.EngineState:
    """The ranks' blocks of a class-sharded carry gathered into the whole
    padded carry on every rank, then the pad classes stripped: a full-K
    carry, as the replicated engine's (resume, snapshots)."""
    is_class = _is_stacked_class_leaf if stacked else _is_class_leaf
    dim = 1 if stacked else 0

    def full(path, t):
        if is_class(path, t):
            src = t.to(torch.uint8) if t.dtype == torch.bool else t
            req = collectives.gather_request(src.movedim(dim, 0), shard.n)
            collectives.issue(req, shard.group)
            t = req.out.movedim(0, dim).to(t.dtype)
        return t

    return strip_padded_state(_map_leaves(state, full), shard.num_classes,
                              stacked)


def strip_padded_state(state: engine.EngineState, num_classes: int,
                       stacked: bool = False) -> engine.EngineState:
    """A padded carry with its pad classes cut off: class leaves keep K
    rows, the trailing class axes K columns."""
    K = num_classes
    is_class = _is_stacked_class_leaf if stacked else _is_class_leaf

    def strip(path, t):
        if is_class(path, t):
            t = t[:, :K] if stacked else t[:K]
        if _has_padded_class_tail(path):
            t = t[..., :K]
        return t.contiguous()

    return _map_leaves(state, strip)


# ---- the runs ------------------------------------------------------------

def make_ep_scan_fn(cfg: Config, model, shard: ClassShard,
                    shard_encoder: bool = False,
                    encode_fn: Optional[Callable] = None) -> engine.ScanFn:
    """The stream's scan of the class-sharded step: on the card its parts
    captured as CUDA graphs (a graph a part between two collectives),
    replayed with the collectives between them; pass one to every
    `run_stream_ep` of a run to reuse them."""
    return engine.ScanFn(cfg, model, step=make_ep_step_fn(
        cfg, model, shard, shard_encoder, encode_fn))


def run_stream_ep(cfg: Config, model, text_features_initial: torch.Tensor,
                  pcs, rgbs, targets, mesh: Optional[World] = None,
                  seed: int = 42,
                  initial_state: Optional[engine.EngineState] = None,
                  shard_encoder: bool = False,
                  scan_fn: Optional[engine.ScanFn] = None,
                  return_outputs: bool = False,
                  encode_fn: Optional[Callable] = None):
    """One stream with the adaptation state class-sharded over the
    world's ranks (default: the initialised process group, else this
    process alone).  Every rank feeds the whole (T, B, ...) stream; the
    adaptation order is the single-process order.

    Args:
      mesh: the class group's world; with `encode_fn` the classes axis of
        a (classes, model) grid (`tp.make_tp_grid`): EP × TP.
      encode_fn: the step's encoder (`make_ep_step_fn`), e.g.
        `tp.make_tp_encode_fn`'s over the grid's model group.
      initial_state: resume from this full-K carry (continual TTA; as
        returned here or by the replicated engine); its real rows go to
        their ranks, the pad classes start fresh.
      scan_fn: `make_ep_scan_fn(cfg, model, shard)` of this world, reused
        across calls.
    Returns:
      (the final full-K EngineState, on every rank; summary with
       acc1/acc3/acc5, n_samples, n_class_shards, padded_classes), and
      with `return_outputs` the StepOutput with a leading T axis (the
      same on every rank).
    """
    world = mesh or make_mesh()
    text = torch.as_tensor(text_features_initial).to(torch.float32)
    K = text.shape[0]
    shard = class_shard(world, K)
    scan_fn = scan_fn or make_ep_scan_fn(cfg, model, shard, shard_encoder,
                                         encode_fn)
    text_local = pad_classes(text, shard.n)[0][
        shard.offset:shard.offset + shard.k_local]
    state = local_padded_state(cfg, text, shard, seed, initial_state)
    dev = text.device
    state, outs = scan_fn(text_local, state,
                          *(torch.as_tensor(a).to(dev)
                            for a in (pcs, rgbs, targets)))
    state = gather_state(state, shard)
    correct = outs.correct.sum(0).tolist()        # the same on every rank
    n_samples = pcs.shape[0] * pcs.shape[1]
    summary = {"acc1": 100.0 * correct[0] / n_samples,
               "acc3": 100.0 * correct[1] / n_samples,
               "acc5": 100.0 * correct[2] / n_samples,
               "n_samples": n_samples, "n_class_shards": shard.n,
               "padded_classes": shard.k_pad - K}
    return (state, summary, outs) if return_outputs else (state, summary)


class Grid(NamedTuple):
    """A 2-D grid of ranks, n_data × n_cls, rank = d·n_cls + c: the
    class group of this rank's data row d (its n_cls ranks share each
    stream's classes) and the data group of its class column c."""
    n_data: int
    n_cls: int
    data_index: int
    cls_rank: int
    cls_group: Optional[object]
    data_group: Optional[object]


def make_grid(n_data: int, world: Optional[World] = None) -> Grid:
    """The grid of `world` (default: the process group) with `n_data`
    data rows (`mesh.make_grid`): a row's ranks share each stream's
    classes, a column's share the streams."""
    g = pmesh.make_grid(n_data, world)
    return Grid(g.rows, g.cols, g.row, g.col, g.row_group, g.col_group)


def run_streams_ep(cfg: Config, model, text_features_initial: torch.Tensor,
                   pcs, rgbs, targets, grid: Optional[Grid] = None,
                   seed: int = 42, shard_encoder: bool = False,
                   scan_fn: Optional[engine.ScanFn] = None):
    """DP × EP: C independent streams over the grid's data rows (each
    row's C/n_data streams on the stream axis, stream i seeded seed + i
    as `engine.run_streams_scan` seeds it), each stream's classes over
    its row's class group.

    Args:
      pcs, rgbs: (C, T, B, N, 3); targets: (C, T, B).  C must be a
        multiple of the grid's data rows.
      grid: `make_grid` (default: one data row over the whole world).
    Returns:
      (this row's streams' final full-K EngineState with a leading stream
       axis, on each of its ranks; summary with every stream's acc1 in
       stream order, acc1/acc3/acc5, n_samples, n_class_shards,
       padded_classes).
    """
    grid = grid or make_grid(1)
    C, T, B = pcs.shape[0], pcs.shape[1], pcs.shape[2]
    if C % grid.n_data:
        raise ValueError(f"stream count {C} must divide over the "
                         f"{grid.n_data}-device data axis")
    text = torch.as_tensor(text_features_initial).to(torch.float32)
    K = text.shape[0]
    shard = ClassShard(grid.cls_group, grid.cls_rank, grid.n_cls, K)
    scan_fn = scan_fn or make_ep_scan_fn(cfg, model, shard, shard_encoder)
    per = C // grid.n_data
    lo = grid.data_index * per
    text_local = pad_classes(text, shard.n)[0][
        shard.offset:shard.offset + shard.k_local]
    state = engine.stack_states([local_padded_state(cfg, text, shard,
                                                    seed + lo + i)
                                 for i in range(per)])
    dev = text.device
    state, outs = scan_fn(text_local, state, *(
        torch.as_tensor(a[lo:lo + per]).to(dev).transpose(0, 1)
        for a in (pcs, rgbs, targets)))
    state = gather_state(state, shard, stacked=True)
    correct = outs.correct.sum(0)                          # (C/n_data, 3)
    if grid.data_group is not None:
        correct = collectives.all_gather_rows(correct.contiguous(),
                                              grid.data_group)
    correct = correct.cpu().numpy()
    n_samples = T * B
    return state, {
        "acc1_per_stream": (100.0 * correct[:, 0] / n_samples).tolist(),
        "acc1": float(100.0 * correct[:, 0].sum() / (C * n_samples)),
        "acc3": float(100.0 * correct[:, 1].sum() / (C * n_samples)),
        "acc5": float(100.0 * correct[:, 2].sum() / (C * n_samples)),
        "n_samples": C * n_samples, "n_class_shards": shard.n,
        "padded_classes": shard.k_pad - K}
