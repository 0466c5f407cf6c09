"""TTA engine: the online adaptation loop for the three backbones, by
MODE-DOTA, by the prototype cache or by one of the other DOTA variants
(plain DOTA, GMM-DOTA, adaptive-modes DOTA) (mirror of
`uni_adapter_tpu/engine.py`).

The JAX package jit-compiles one pure step and scans it over the stream
(`run_stream_scan`, its CLI's default).  Here `run_stream_scan` runs the
step on static tensors (the carry, the anchors, an input slot) that each
step updates in place: on the card the step is captured once as a CUDA
graph and replayed, on the CPU the same in-place step runs eagerly.
`run_stream` is the eager loop of the functional step.  The state stays
on the device between steps.  A MODE-DOTA step reads nothing back to the
host (the residual-learning gate `step > 0` is a host integer: the scan
captures a graph for each side of it), nor does a step of the other
variants; a cache step reads only the CG's stop flags, once an iteration
(`utils/math.run_cg`).

The MODE-DOTA noise comes from a `torch.Generator` carried in the state;
`step(..., noise=...)` takes it from the caller instead, which is how the
tests feed both packages the same draw.

`make_step_fn(..., encode_fn=...)` replaces the model's forward, as
the JAX package's does: a tensor-parallel trunk (`parallel/tp.py`)
whose forward is a parts generator, each of its sums over the model
group yielded with the step's own collectives.

With `make_step_fn(..., axis_name=group)` (a torch.distributed process
group; the JAX package's `axis_name` inside `shard_map`) each rank feeds
its own batch and the fits' additive statistics are summed over the
ranks, so the replicated state takes the global batch's update
(`parallel/mesh.run_stream_psum`).  A step is a generator of parts
(`Step.parts`) that yields a sum request of each fit's packed
statistics (`collectives.Collective`; the class-sharded steps of
`parallel/ep.py` also yield gathers): calling the step issues them as
they come; the captured step (`_StreamRunner`) records one CUDA graph a
part and issues the collectives between their replays, gloo's (which
cannot be captured) and NCCL's alike.

S independent streams (the JAX package's `run_streams_vmapped`, the
15-corruption sweep) run as one: the state from `init_states_streams`
carries a leading stream axis and one generator a stream, and the same
step takes (S, B, ...) batches.  `torch.func.vmap` cannot wrap the
residual loop's `torch.autograd.grad` or the kernels' launches, so the
axis is written out: the encoder takes one forward of the 2·S·B clouds,
the adaptation batched products, the residual loop one gradient of the
summed per-stream losses.  The streams of a stacked carry may stand at
different points of their streams (`stack_states`, as a serving tick
batches its clients): every count that enters the math is then read per
stream, and the residual gate `step > 0` is a host mask, as JAX's
vmapped `lax.cond` is a per-stream select: with the gate open for some
streams only, the Adam loop runs for the stack and a closed stream
keeps its residual state bitwise.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import inspect
import logging
import os
import time
from dataclasses import dataclass
from typing import Callable, Iterable, NamedTuple, Optional, Union

import torch
import torch.distributed as dist

from uni_adapter_torch.adapt import adaptive, cache, dota, fusion, gmm
from uni_adapter_torch.adapt import mode_dota, residual
from uni_adapter_torch.config import Config
from uni_adapter_torch.parallel import collectives
from uni_adapter_torch.utils.math import (normalized_entropy, run_cg,
                                          softmax_entropy)
from uni_adapter_torch.utils.metrics import topk_correct


@dataclass
class EngineState:
    """The adaptation carry: one stream's, or S streams' with a leading
    (S,) axis on every tensor but the counts the streams agree on, and
    one generator a stream (MODE-DOTA draws its noise from it, GMM-DOTA
    its init; the others draw nothing).  `step` is the steps taken: one
    int, or S of them where the streams' differ."""
    method_state: Union[mode_dota.ModeDotaState, cache.CacheState,
                        dota.DOTAState, gmm.GMMDotaState,
                        adaptive.AdaptiveState]
    res_state: Optional[residual.ResidualState]
    step: Union[int, tuple[int, ...]]
    generator: Union[torch.Generator, tuple[torch.Generator, ...]]


class StepOutput(NamedTuple):
    final_logits: torch.Tensor        # ([S,] B, K)
    clip_logits: torch.Tensor         # ([S,] B, K)
    correct: torch.Tensor             # ([S,] 3) top-1/3/5 correct counts
    zs_correct: torch.Tensor          # ([S,] 3) the frozen anchors' counts
    cg_iters: Optional[torch.Tensor] = None   # ([S,]) the cache's CG


def _backbone_inputs(kind: str, pc: torch.Tensor, rgb: torch.Tensor):
    """A backbone's inputs: uni3d takes xyz‖color, ulip xyz only,
    openshape (xyz, xyz‖color)."""
    if kind == "uni3d":
        return (torch.cat([pc, rgb], dim=-1),)
    if kind == "ulip":
        return (pc,)
    return pc, torch.cat([pc, rgb], dim=-1)


def _normalized(feat: torch.Tensor) -> torch.Tensor:
    return feat / (torch.linalg.norm(feat, dim=-1, keepdim=True) + 1e-12)


def _check_kind(kind: str) -> None:
    if kind not in ("uni3d", "ulip", "openshape"):
        raise ValueError(f"unknown backbone {kind!r}")


def encode_with(kind: str, model: Callable) -> Callable:
    """(pc, rgb) -> L2-normalised (B, D) features for a backbone: uni3d
    takes xyz‖color, ulip xyz only, openshape (xyz, xyz‖color)."""
    _check_kind(kind)

    def encode(pc: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
        return _normalized(model(*_backbone_inputs(kind, pc, rgb)))

    return encode


def encode_parts(kind: str, forward: Callable) -> Callable:
    """`encode_with`'s contract for a forward that is a parts generator
    (`parallel/tp.make_tp_forward`): encode(pc, rgb) is a generator that
    yields the forward's collectives and returns the features.  Pass it
    as `encode_fn` to the steps; they take it with `encoded`."""
    _check_kind(kind)

    def encode(pc: torch.Tensor, rgb: torch.Tensor):
        feat = yield from forward(*_backbone_inputs(kind, pc, rgb))
        return _normalized(feat)

    return encode


def encoded(encode: Callable, pc: torch.Tensor, rgb: torch.Tensor):
    """Parts: the features `encode(pc, rgb)`; an encoder made by
    `encode_parts` has its collectives yielded."""
    feat = encode(pc, rgb)
    if inspect.isgenerator(feat):
        feat = yield from feat
    return feat


def clip_logits_from(feat: torch.Tensor, clip_weights: torch.Tensor,
                     scale: float = 100.0):
    """logits = scale·f@W in fp32, plus entropy, probabilities and the
    sample-0 prediction; feat ([S,] B, D), clip_weights ([S,] D, K)."""
    logits = scale * torch.matmul(feat.to(torch.float32), clip_weights)
    ent = softmax_entropy(logits)
    prob_map = torch.softmax(logits, dim=-1)
    pred = torch.argmax(logits[..., 0, :], dim=-1)
    return logits, ent, prob_map, pred


def uses_cache(cfg: Config) -> bool:
    """The JAX engine's dispatch: the prototype cache runs when none of the
    DOTA family is asked for."""
    d = cfg.dota
    return not (d.use_dota or d.use_mode_dota or d.use_gmm_dota
                or d.use_adaptive_dota)


def init_state(cfg: Config, text_features_initial: torch.Tensor,
               seed: int = 42) -> EngineState:
    """The carry, by the JAX engine's dispatch: MODE-DOTA's mixture from
    the anchors and zero residuals; plain DOTA's Gaussians from a
    constant 0.001 mean matrix (the reference's driver's); GMM-DOTA's
    mixture, its perturbation drawn from the carry's generator (seeded
    `seed`); adaptive DOTA's one mode a class; or an empty prototype
    cache."""
    K, D = text_features_initial.shape
    dev = text_features_initial.device
    dc = cfg.dota
    rs = None
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    anchors = text_features_initial.T
    if uses_cache(cfg):
        ms = cache.init(K, cfg.cache.shot_capacity, D, device=dev)
    elif dc.use_mode_dota:
        ms = mode_dota.init(dc.epsilon, dc.sigma, D, K, anchors,
                            num_modes=dc.mode_M)
        if dc.res_learning:
            rs = residual.init(text_features_initial)
    elif dc.use_dota:
        ms = dota.init(dc.epsilon, dc.sigma, D, K,
                       torch.full((D, K), 0.001, device=dev))
    elif dc.use_gmm_dota:
        ms = gmm.init(dc.epsilon, dc.sigma, D, K, anchors,
                      num_modes=dc.mode_M, generator=gen)
    else:
        ms = adaptive.init(dc.epsilon, dc.sigma, D, K, anchors,
                           max_modes=dc.mode_M)
    return EngineState(ms, rs, 0, gen)


def _stack(states):
    """Single-stream NamedTuple states as one with a leading stream axis.
    A () count (samples seen, Adam steps) on which the streams agree
    stays one () count; counts that differ are stacked to ([S],)."""
    fields = []
    for vals in zip(*states):
        if vals[0].dim() > 0:
            fields.append(torch.stack(vals))
            continue
        counts = torch.stack(vals)
        fields.append(vals[0] if bool((counts == counts[0]).all())
                      else counts)
    return type(states[0])(*fields)


def _unstack(state, i: int):
    """Stream i of a NamedTuple state with a leading stream axis."""
    return type(state)(*(t if t.dim() == 0 else t[i] for t in state))


def stack_states(states: list) -> EngineState:
    """Single-stream carries as one carry with a leading stream axis (S =
    len(states)): their tensors stacked, their generators (the objects
    themselves) in a tuple, their steps one int or S of them."""
    steps = [s.step for s in states]
    res = states[0].res_state
    return EngineState(
        _stack([s.method_state for s in states]),
        None if res is None else _stack([s.res_state for s in states]),
        steps[0] if len(set(steps)) == 1 else tuple(steps),
        tuple(s.generator for s in states))


def unstack_state(state: EngineState, i: int) -> EngineState:
    """Stream i of a carry with a leading stream axis, as a single-stream
    carry (its tensors views of the stacked ones)."""
    res = state.res_state
    return EngineState(
        _unstack(state.method_state, i),
        None if res is None else _unstack(res, i),
        state.step[i] if isinstance(state.step, tuple) else state.step,
        state.generator[i])


def init_states_streams(cfg: Config, text_features_initial: torch.Tensor,
                        n_streams: int, seed: int = 42) -> EngineState:
    """S streams' carry: the single-stream init stacked, stream i's
    generator seeded seed + i (the JAX package's `init_states_vmapped`,
    the reference's seed+rank; GMM-DOTA's stream i draws its init from
    it)."""
    return stack_states([init_state(cfg, text_features_initial, seed + i)
                         for i in range(n_streams)])


def _next_step(step):
    return tuple(s + 1 for s in step) if isinstance(step, tuple) else step + 1


def _gates(step) -> tuple:
    """The residual gate `step > 0`: one bool, or one a stream where the
    streams' steps differ."""
    return tuple(s > 0 for s in step) if isinstance(step, tuple) else (
        step > 0,)


def _select_streams(gates: tuple, new, old):
    """The NamedTuple `new` on the streams whose gate is open and `old` on
    the others (JAX's vmapped `lax.cond`)."""
    m = torch.tensor(gates, device=old[0].device)
    return type(old)(*(
        torch.where(m.reshape(m.shape + (1,) * max(o.dim() - 1, 0)), n, o)
        for n, o in zip(new, old)))


def _fit(group, merge: Callable, stats: tuple, n: int):
    """A fit's merge of its statistics of n samples, the statistics first
    summed over `group`'s ranks: a generator that yields a sum request of
    their packed buffer for its caller to issue (`Step`, or a captured
    step's segments), and returns the merged state.  Without a group it
    yields nothing."""
    if group is not None:
        flat = collectives.pack(stats)
        yield collectives.Collective("sum", flat)
        stats = collectives.unpack(flat, stats)
        n *= dist.get_world_size(group)
    return merge(stats, n)


def drive(parts, group):
    """Run a step's parts generator to its end, each collective it yields
    (`collectives.Collective`) issued over `group`; returns its result."""
    try:
        while True:
            collectives.issue(next(parts), group)
    except StopIteration as done:
        return done.value


class Step:
    """A DOTA-family step, step(text_init, state, batch, noise=None) ->
    (state, StepOutput).  `parts(...)` is the same step as a generator
    that yields each fit's packed statistics where `group` (the
    `axis_name` of `make_step_fn`) sums them: calling the step runs it
    with the all-reduces issued in place, and a captured step
    (`_StreamRunner`) replays its segments with the all-reduces between
    them.  Without a group the generator yields nothing."""

    def __init__(self, parts: Callable, group=None):
        self.parts, self.group = parts, group

    def __call__(self, text_init: torch.Tensor, state: EngineState, batch,
                 noise: Optional[torch.Tensor] = None):
        return drive(self.parts(text_init, state, batch, noise), self.group)


def make_step_fn(cfg: Config, model: Callable, axis_name=None,
                 encode_fn: Optional[Callable] = None) -> Callable:
    """step(text_init, state, batch, noise=None) -> (state, StepOutput),
    with batch = (pc ([S,] B, N, 3), rgb ([S,] B, N, 3), target ([S,] B))
    and noise, if given, of pc's shape.  With a leading stream axis the
    state is `init_states_streams`'s; the encoder then takes the clean
    clouds of streams 0..S−1 and then their noisy ones as one 2·S·B
    batch, and each stream's noise comes from its own generator.  The
    cache path's step (`CacheStep`) and the other variants' (`variant_step`)
    take no noise.

    With `axis_name` (a process group) each rank feeds its local batch and
    the fits' sufficient statistics are summed over the ranks: the state
    stays replicated and takes the exact global streaming update, and the
    fusion weight divides by the global batch.  The prototype cache has
    no such form and raises.

    `encode_fn` replaces the model's forward (`encode_with`'s contract,
    or `encode_parts`': a tensor-parallel trunk, `parallel/tp.py`, whose
    sums the step yields with its own)."""
    encode = (encode_fn if encode_fn is not None
              else encode_with(cfg.model.vlm3d, model))
    dc = cfg.dota
    if uses_cache(cfg):
        if axis_name is not None:
            raise ValueError(
                "axis_name requires an adaptation method with additive "
                "sufficient statistics (DOTA family); the prototype cache "
                "cannot be psum-merged — run it sharded (independent "
                "per-device state) instead")
        return CacheStep(cfg, encode)
    if not dc.use_mode_dota:
        return variant_step(cfg, encode, axis_name)
    use_res = dc.res_learning
    if use_res:
        residual.check_precision(dc.residual_precision)
    group = axis_name

    @torch.no_grad()
    def parts(text_init: torch.Tensor, state: EngineState, batch,
              noise: Optional[torch.Tensor] = None):
        pc, rgb, target = batch
        text_init = text_init.to(torch.float32)
        if use_res:
            clip_weights = residual.adapted_text_weights(state.res_state,
                                                         text_init)
        else:
            clip_weights = text_init.T

        # clean and noise-augmented clouds of every stream in one forward
        *lead, B, N, _ = pc.shape
        if noise is None:
            def draw(gen, shape):
                return torch.randn(shape, generator=gen, device=pc.device,
                                   dtype=pc.dtype)
            noise = (torch.stack([draw(g, pc.shape[1:])
                                  for g in state.generator]) if lead
                     else draw(state.generator, pc.shape))
        pc_aug = pc + dc.noise_std * noise
        feat_both = yield from encoded(
            encode,
            torch.cat([pc.reshape(-1, N, 3), pc_aug.reshape(-1, N, 3)]),
            torch.cat([rgb.reshape(-1, N, 3)] * 2))
        n = feat_both.shape[0] // 2
        feat = feat_both[:n].reshape(*lead, B, -1)
        feat_aug = feat_both[n:].reshape(*lead, B, -1)
        clip_logits, _, prob_map, _ = clip_logits_from(
            feat, clip_weights, scale=cfg.model.logit_scale)

        ms = state.method_state
        dota_logits = mode_dota.predict(
            ms, _predict_input(feat, dc.fp16_predict_input), dc.epsilon)
        ms = yield from _fit(
            group, functools.partial(mode_dota.fit_merge, ms),
            mode_dota.fit_stats(ms, feat, prob_map, dc.epsilon), B)
        # the noise-augmented fit uses the CLEAN prob_map
        ms = yield from _fit(
            group, functools.partial(mode_dota.fit_merge, ms),
            mode_dota.fit_stats(ms, feat_aug, prob_map, dc.epsilon), B)

        res_state = state.res_state
        gates = _gates(state.step)
        if use_res and any(gates):
            res_state = residual.optimize_residuals(
                res_state, text_init, ms, dc.residual_lr, dc.epsilon,
                num_steps=dc.residual_steps,
                precision=dc.residual_precision)
            if not all(gates):
                res_state = _select_streams(gates, res_state,
                                            state.res_state)

        w = fusion.dota_fusion_weight(dc.rho, dc.eta,
                                      ms.c.mean(dim=(-2, -1)),
                                      float(B * _size(group)))
        final = fusion.fuse_mode_dota(
            clip_logits, dota_logits, w,
            fix_normalization=dc.fix_fusion_normalization)
        if use_res:
            zs_logits = clip_logits_from(feat, text_init.T,
                                         scale=cfg.model.logit_scale)[0]
        else:
            zs_logits = clip_logits
        out = StepOutput(final, clip_logits,
                         topk_correct(final, target, (1, 3, 5)),
                         topk_correct(zs_logits, target, (1, 3, 5)))
        return EngineState(ms, res_state, _next_step(state.step),
                           state.generator), out

    return Step(parts, group)


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _predict_input(f: torch.Tensor, fp16: bool) -> torch.Tensor:
    """The batch's mean feature that `predict` scores, rounded through
    fp16 when asked (the reference's `.half()`)."""
    m = f.mean(dim=-2, keepdim=True)
    return m.to(torch.float16).to(torch.float32) if fp16 else m


def variant_step(cfg: Config, encode: Callable, axis_name=None) -> Step:
    """The step of plain DOTA, GMM-DOTA or adaptive-modes DOTA,
    step(text_init, state, batch) -> (state, StepOutput): one encoder
    forward of the B clouds (S·B with a stream axis), the scores of the
    batch's mean feature from the state before the fit, the fit (its
    statistics summed over `axis_name`'s ranks where given), then the
    fusion with the clip logits (DOTA's additive, the others' inverse
    entropy).  The JAX engine's branches of the three."""
    dc, scale = cfg.dota, cfg.model.logit_scale
    if dc.use_dota:
        kind = "dota"
    elif dc.use_gmm_dota:
        kind = "gmm"
    else:
        kind = "adaptive"
    group = axis_name

    @torch.no_grad()
    def parts(text_init: torch.Tensor, state: EngineState, batch,
              noise=None):
        del noise           # the variants draw none
        pc, rgb, target = batch
        text_init = text_init.to(torch.float32)
        *lead, B, N, _ = pc.shape
        feat = yield from encoded(encode, pc.reshape(-1, N, 3),
                                  rgb.reshape(-1, N, 3))
        feat = feat.reshape(*lead, B, -1)
        clip_logits, _, prob_map, _ = clip_logits_from(feat, text_init.T,
                                                       scale=scale)
        ms = state.method_state
        mean_feat = feat.mean(dim=-2, keepdim=True)
        if kind == "dota":
            scores = dota.predict(ms, _predict_input(feat,
                                                     dc.fp16_predict_input),
                                  prior_pre_steps=dc.prior_pre_steps)
            ms = yield from _fit(group, functools.partial(dota.fit_merge, ms),
                                 dota.fit_stats(ms.mu, feat, prob_map), B)
            ms = dota.update(ms, dc.epsilon)
            counts = ms.c.mean(dim=-1)
        elif kind == "gmm":
            scores = gmm.predict(ms, mean_feat, alpha_max=dc.alpha_max)
            ms = yield from _fit(group, functools.partial(gmm.fit_merge, ms),
                                 gmm.fit_stats(ms, feat, prob_map), B)
            ms = gmm.update(ms, dc.epsilon)
            counts = gmm.class_counts_per_class(ms).mean(dim=-1)
        else:
            sigma_init = mode_dota.resolve_sigma_init(dc.sigma,
                                                      text_init.shape[1])
            scores = adaptive.predict(ms, mean_feat, dc.epsilon)
            ms = yield from _fit(
                group, functools.partial(adaptive.fit_merge, ms,
                                         split_threshold=10.0 * sigma_init),
                adaptive.fit_stats(ms, feat, prob_map, dc.epsilon), B)
            counts = ms.c.mean(dim=(-2, -1))
        w = fusion.dota_fusion_weight(dc.rho, dc.eta, counts,
                                      float(B * _size(group)))
        if kind == "dota":
            final = fusion.fuse_dota(clip_logits, scores, w)
        else:
            final = fusion.fuse_mode_dota(
                clip_logits, scores, w,
                fix_normalization=dc.fix_fusion_normalization)
        out = StepOutput(final, clip_logits,
                         topk_correct(final, target, (1, 3, 5)),
                         topk_correct(clip_logits, target, (1, 3, 5)))
        return EngineState(ms, None, _next_step(state.step),
                           state.generator), out

    return Step(parts, group)


class _CacheContext(NamedTuple):
    """What the cache step's first part hands its CG and its last part."""
    feat: torch.Tensor              # ([S,] B, D)
    clip_logits: torch.Tensor       # ([S,] B, K)
    target: torch.Tensor
    method_state: cache.CacheState  # the cache with the sample in it
    ref: cache.Refinement


class CacheStep:
    """The prototype-cache step, step(text_init, state, batch) -> (state,
    StepOutput): one encoder forward of the clouds (S of them with a
    stream axis), the sample inserted into or merged with its predicted
    class's prototypes, then the cache logits read from the cache that
    already holds it, fused with the clip logits.  Batch 1 a stream:
    with B > 1 only sample 0 would enter the cache while all B were
    scored against it, so B > 1 raises, as in the JAX engine.

    It runs in three parts, which a captured step replays one by one:
    `head` (the forward, the cache update, the graph's system and the
    CG's start, or the explicit solve), the CG's `iteration`, run until
    every system has stopped (the host reads the stop flags after each),
    and `tail` (the readout and the fusion).  Each part is a parts
    generator, as `Step.parts` is; here they yield nothing (the
    class-sharded cache's, `parallel/ep.ShardedCacheStep`, yield the
    collectives of its `group`)."""

    group = None

    def __init__(self, cfg: Config, encode: Callable):
        self.cc, self.scale = cfg.cache, cfg.model.logit_scale
        self.encode = encode

    @torch.no_grad()
    def head(self, text_init: torch.Tensor, state: EngineState, batch):
        cc, scale = self.cc, self.scale
        pc, rgb, target = batch
        *lead, B, N, _ = pc.shape
        if B != 1:
            raise ValueError(
                f"the prototype-cache path requires batch_size=1 (got {B}): "
                f"one sample a step enters the cache")
        clip_weights = text_init.to(torch.float32).T
        feat = yield from encoded(self.encode, pc.reshape(-1, N, 3),
                                  rgb.reshape(-1, N, 3))
        feat = feat.reshape(*lead, B, -1)
        clip_logits, ent, prob_map, pred = clip_logits_from(
            feat, clip_weights, scale=scale)
        cs, _ = cache.update_cache(
            state.method_state, pred, feat[..., :1, :],
            normalized_entropy(ent[..., 0], text_init.shape[0]),
            prob_map[..., :1, :], clip_weights, beta=cc.beta,
            logit_scale=scale)
        # cc.cg_tol is not passed: the JAX engine runs the CG at its
        # default tolerance
        return _CacheContext(feat, clip_logits, target, cs,
                             cache.start_refinement(
                                 cs, cc.threshold, cc.lambda_reg,
                                 cc.use_new_approximation, cc.graph_mode))

    @torch.no_grad()
    def iteration(self, ctx: _CacheContext):
        yield from ()
        return cache.refinement_iteration(ctx.ref)

    @torch.no_grad()
    def tail(self, state: EngineState, ctx: _CacheContext):
        yield from ()
        final = fusion.fuse_cache(
            ctx.clip_logits, cache.graph_readout(ctx.feat, ctx.ref),
            logit_scale=self.scale)
        cg = ctx.ref.cg
        out = StepOutput(final, ctx.clip_logits,
                         topk_correct(final, ctx.target, (1, 3, 5)),
                         topk_correct(ctx.clip_logits, ctx.target, (1, 3, 5)),
                         None if cg is None else cg.iters)
        return EngineState(ctx.method_state, None, _next_step(state.step),
                           state.generator), out

    def __call__(self, text_init: torch.Tensor, state: EngineState, batch):
        ctx = drive(self.head(text_init, state, batch), self.group)
        if ctx.ref.cg is not None:
            run_cg(lambda: drive(self.iteration(ctx), self.group),
                   self.cc.cg_max_iter)
        return drive(self.tail(state, ctx), self.group)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_stream(cfg: Config, model: Callable,
               text_features_initial: torch.Tensor,
               batches: Iterable, seed: int = 42,
               print_freq: Optional[int] = None,
               step_fn: Optional[Callable] = None,
               initial_state: Optional[EngineState] = None,
               checkpoint_path: Optional[str] = None,
               checkpoint_every: Optional[int] = None) -> dict:
    """Run one stream step by step.

    Args:
      batches: iterable of (pc, rgb, target) numpy arrays or tensors;
        each is moved to the anchors' device.
      initial_state: resume the adaptation trajectory from this carry
        instead of a fresh init (continual TTA: streams chained without a
        reset; the reference re-inits per corruption).
      checkpoint_path, checkpoint_every: every `checkpoint_every` steps
        the carry (generator and step count included) and the running
        counts are written to `checkpoint_path` (`checkpoint.save_state`).
        A run that finds a checkpoint there resumes from it exactly: at
        its step, skipping the batches it has seen.  A checkpoint takes
        precedence over `initial_state`.
    Returns:
      dict with acc1/acc3/acc5 and zs_acc1 (percent), per-step wall times
      in ms (each step ends in a device synchronise; the steps this call
      ran), `finite` (every final logit was finite), the cache's CG
      iterations a step (`cg_iters`, None on the other paths) and the
      final `state`.
    """
    from uni_adapter_torch import checkpoint

    dev = text_features_initial.device
    step = step_fn if step_fn is not None else make_step_fn(cfg, model)
    state = (initial_state if initial_state is not None
             else init_state(cfg, text_features_initial, seed))
    totals = torch.zeros(3, device=dev)
    zs_totals = torch.zeros(3, device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    n = start_step = 0
    if checkpoint_path and os.path.exists(checkpoint_path + ".npz"):
        saved = checkpoint.restore_state(checkpoint_path, dev)
        state, totals, zs_totals, finite, n = (
            saved[k] for k in ("state", "totals", "zs_totals", "finite", "n"))
        start_step = state.step
        logging.info("resumed adaptation state at step %d", start_step)
    step_ms, cg_iters = [], []
    for i, (pc, rgb, target) in enumerate(batches):
        if i < start_step:
            continue
        batch = tuple(torch.as_tensor(a).to(dev) for a in (pc, rgb, target))
        t0 = time.perf_counter()
        state, out = step(text_features_initial, state, batch)
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        totals += out.correct
        zs_totals += out.zs_correct
        finite &= torch.isfinite(out.final_logits).all()
        if out.cg_iters is not None:
            cg_iters.append(out.cg_iters)
        n += int(batch[0].shape[0])
        if print_freq and i % print_freq == 0:
            logging.info("step %d: acc1=%.3f%%", i,
                         100 * float(totals[0]) / n)
        if checkpoint_path and checkpoint_every and (
                (i + 1) % checkpoint_every == 0):
            checkpoint.save_state(checkpoint_path, {
                "state": state, "totals": totals, "zs_totals": zs_totals,
                "finite": finite, "n": n})
    return {**_percent(totals.tolist(), zs_totals.tolist(), max(n, 1)),
            "n": n, "step_ms": step_ms, "finite": bool(finite),
            "cg_iters": torch.stack(cg_iters).tolist() if cg_iters else None,
            "state": state}


def run_streams(cfg: Config, model: Callable,
                text_features_initial: torch.Tensor, pcs, rgbs, targets,
                seed: int = 42, step_fn: Optional[Callable] = None) -> dict:
    """Run S independent streams together, step by step (the JAX package's
    `run_streams_vmapped`): each step one forward of the 2·S·B clouds.

    Args:
      pcs, rgbs: (S, T, B, N, 3); targets: (S, T, B); numpy arrays or
        tensors, each step's slice moved to the anchors' device.
    Returns:
      dict with the final `state` (leading S axis), the per-step
      `outputs` (StepOutputs with a leading S axis; `summarize_streams`
      reads them), per-step wall times `step_ms` (each step ends in a
      device synchronise) and `finite`, per stream: every final logit was
      finite.
    """
    dev = text_features_initial.device
    step = step_fn if step_fn is not None else make_step_fn(cfg, model)
    state = init_states_streams(cfg, text_features_initial, len(pcs), seed)
    outputs, step_ms = [], []
    finite = torch.ones(len(pcs), dtype=torch.bool, device=dev)
    for t in range(pcs.shape[1]):
        batch = tuple(torch.as_tensor(a[:, t]).to(dev).contiguous()
                      for a in (pcs, rgbs, targets))
        t0 = time.perf_counter()
        state, out = step(text_features_initial, state, batch)
        _sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outputs.append(out)
        finite &= torch.isfinite(out.final_logits).flatten(1).all(dim=1)
    return {"state": state, "outputs": outputs, "step_ms": step_ms,
            "finite": finite.tolist()}


def stack_outputs(outputs) -> StepOutput:
    """Per-step StepOutputs as one with a leading T axis (a stacked one is
    returned as it is)."""
    if isinstance(outputs, StepOutput):
        return outputs
    return StepOutput(*(None if vals[0] is None else torch.stack(vals)
                        for vals in zip(*outputs)))


def _percent(correct: list, zs: list, n: int) -> dict:
    return {"acc1": 100.0 * correct[0] / n, "acc3": 100.0 * correct[1] / n,
            "acc5": 100.0 * correct[2] / n, "zs_acc1": 100.0 * zs[0] / n}


def summarize_streams(outputs, n_per_stream: int) -> list[dict]:
    """Per-stream percent accuracies from the outputs of `run_streams`
    (a list) or `run_streams_scan` (stacked): the JAX package's
    `summarize_vmapped`."""
    out = stack_outputs(outputs)
    return [_percent(c, z, n_per_stream) for c, z in
            zip(out.correct.sum(0).tolist(), out.zs_correct.sum(0).tolist())]


def summarize(outputs, n_samples: int) -> dict:
    """Aggregate per-step outputs (a list, or stacked with a leading T axis
    as `run_stream_scan` returns them) into percent accuracies."""
    out = stack_outputs(outputs)
    return _percent(out.correct.sum(0).tolist(),
                    out.zs_correct.sum(0).tolist(), n_samples)


# ---- the stream as one captured step, replayed ---------------------------

#: Eager runs of a step on a side stream before it is captured (PyTorch's
#: recipe for CUDA graphs: lazy initialisation, cuBLAS workspaces and the
#: autograd engine's streams are set up outside the capture).
WARMUP_RUNS = 2


def _state_tensors(state: EngineState) -> list[torch.Tensor]:
    return [*state.method_state, *(state.res_state or ())]


def _generators(state: EngineState) -> tuple:
    g = state.generator
    return g if isinstance(g, tuple) else (g,)


def copy_generator(g: torch.Generator) -> torch.Generator:
    """A new generator in the state of `g` (its next draws are g's)."""
    c = torch.Generator(device=g.device)
    c.set_state(g.get_state())
    return c


def clone_state(state: EngineState) -> EngineState:
    """A copy of the carry that shares no tensor and no generator with it."""
    res = state.res_state
    gens = tuple(map(copy_generator, _generators(state)))
    return EngineState(
        type(state.method_state)(*(t.clone() for t in state.method_state)),
        None if res is None else type(res)(*(t.clone() for t in res)),
        state.step, gens if isinstance(state.generator, tuple) else gens[0])


def _load_state_(dst: EngineState, src: EngineState) -> None:
    """Write the carry `src` into the static carry `dst` in place: its
    tensors, and its generators' seeds and offsets."""
    _load_state_tensors(dst, src)
    for d, s in zip(_generators(dst), _generators(src), strict=True):
        d.set_state(s.get_state())


def _load_state_tensors(dst: EngineState, src: EngineState) -> None:
    for d, s in zip(_state_tensors(dst), _state_tensors(src), strict=True):
        d.copy_(s)


@contextlib.contextmanager
def _collected_then_paused():
    """A graph destroyed while another is captured invalidates the capture,
    and an earlier runner's graphs are freed by the cyclic collector (a
    runner and its segments refer to each other): collect once before a
    capture, and none during it (nor between the segments of one step)."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class _Segment:
    """A part of a step on static tensors, `fn()`: run eagerly until
    `capture` records it as a CUDA graph, replayed after that."""

    def __init__(self, fn: Callable, generators: tuple = ()):
        self.fn, self.generators = fn, generators
        self.graph = self.out = None

    def capture(self, paused: bool = False) -> None:
        """Record `fn` as a graph; `paused`: the caller already collected
        and holds the collector off (`_collected_then_paused`)."""
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:   # each replay draws the generator's next
            graph.register_generator_state(g)
        with contextlib.nullcontext() if paused else \
                _collected_then_paused():
            with torch.cuda.graph(graph):
                self.out = self.fn()
        self.graph = graph

    def __call__(self):
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        return self.out


class _Done(NamedTuple):
    value: object


def _advance(parts):
    """The parts generator run to its next all-reduce: the buffer it
    yields, or `_Done` with its result."""
    try:
        return next(parts)
    except StopIteration as done:
        return _Done(done.value)


class _Parted:
    """A step's parts generator, `make_parts()`, on static tensors: run
    eagerly (the collectives it yields issued over `group` as they come)
    until `capture` records it as one CUDA graph for each part between
    two collectives; then each call replays them in turn, the request of
    each issued before the next part reads its buffer.  `generators` are
    registered with the first part's graph, which draws the noise."""

    def __init__(self, make_parts: Callable, generators: tuple = (),
                 group=None):
        self.make_parts, self.generators = make_parts, generators
        self.group = group
        self.segments: list = []

    @property
    def graph(self):
        return self.segments[0].graph if self.segments else None

    def capture(self) -> None:
        parts = self.make_parts()
        with _collected_then_paused():
            while True:
                seg = _Segment(functools.partial(_advance, parts),
                               () if self.segments else self.generators)
                seg.capture(paused=True)
                self.segments.append(seg)
                if isinstance(seg.out, _Done):
                    seg.out = seg.out.value
                    return

    @property
    def out(self):
        """The captured parts' result (the last segment's)."""
        return self.segments[-1].out

    def __call__(self):
        if not self.segments:
            return drive(self.make_parts(), self.group)
        for seg in self.segments[:-1]:
            collectives.issue(seg(), self.group)
        return self.segments[-1]()


class _StreamRunner:
    """One configuration's step on static tensors of one shape: the carry,
    the anchors and an input slot.  The step reads the slot and the
    carry and writes the new carry into it in place.  On the card each of
    its parts is captured once (per residual gate) and replayed; on the
    CPU the same parts run eagerly.  `noise`: the step draws from the
    carry's generators (MODE-DOTA), whose states each replay advances.
    A step with a process group (`make_step_fn(axis_name=...)`) is
    captured in segments, with its all-reduces issued between their
    replays: gloo's collectives cannot be captured, and one design serves
    both backends."""

    def __init__(self, step: Callable, gated: bool, noise: bool,
                 text: torch.Tensor, state: EngineState, slot: tuple):
        self.step, self.gated = step, gated
        self.text = text.clone()
        self.state = clone_state(state)
        self.slot = tuple(torch.empty_like(a, memory_format=torch
                                           .contiguous_format) for a in slot)
        self.on_card = text.device.type == "cuda"
        self.ctx = None
        if isinstance(step, CacheStep):
            # the cache draws no noise and has no gate: one program of
            # three parts (each in segments where its group's collectives
            # split it: the class-sharded cache, parallel/ep.py)
            g = step.group
            self.programs = {True: (
                _Parted(lambda: step.head(self.text, self.state, self.slot),
                        (), g),
                _Parted(lambda: step.iteration(self.ctx), (), g),
                _Parted(self._cache_tail, (), g))}
        else:
            # MODE-DOTA's step (a program per residual gate) or another
            # variant's (no gate, no generator), in parts where a group
            # sums the fits' statistics
            gens = _generators(self.state) if noise else ()
            self.parts = step.parts
            self.programs = {gate: (_Parted(
                functools.partial(self._body, gate), gens, step.group),)
                for gate in ((False, True) if gated else (True,))}

    def _body(self, gate: bool):
        # the residual gate `step > 0` is the graph's, not the carry's
        new, out = yield from self.parts(self.text, dataclasses.replace(
            self.state, step=int(gate)), self.slot)
        _load_state_tensors(self.state, new)
        return out

    def _cache_tail(self):
        new, out = yield from self.step.tail(self.state, self.ctx)
        _load_state_tensors(self.state, new)
        return out

    def _gate(self, step: int) -> bool:
        return step > 0 or not self.gated

    def _run_step(self, program: tuple) -> StepOutput:
        if len(program) == 1:
            return program[0]()
        head, iteration, tail = program
        self.ctx = head()
        if self.ctx.ref.cg is not None:
            run_cg(iteration, self.step.cc.cg_max_iter)
        return tail()

    def _capture(self, program: tuple) -> None:
        """Warm the step up on a side stream, then capture its parts, and
        leave the carry and its generators as they were."""
        saved = [t.clone() for t in _state_tensors(self.state)]
        gen_states = [g.get_state() for g in _generators(self.state)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self._run_step(program)
        torch.cuda.current_stream().wait_stream(side)
        for i, seg in enumerate(program):
            seg.capture()
            if i == 0 and len(program) > 1:
                self.ctx = seg.out     # the later parts read the head's
                if self.ctx.ref.cg is None:     # the explicit solve: no CG
                    program[2].capture()
                    break
        for t, s in zip(_state_tensors(self.state), saved):
            t.copy_(s)
        for g, s in zip(_generators(self.state), gen_states):
            g.set_state(s)

    def run(self, text: torch.Tensor, state: EngineState, pcs, rgbs,
            targets):
        """Steps over (T, ...) device tensors from `state`: returns the
        final carry (a copy), the outputs with a leading T axis and each
        step's ms (on the card from CUDA events recorded between the
        steps, with no host synchronisation inside the stream, but for the
        cache's stop flags; on the CPU its wall time)."""
        T, step0 = pcs.shape[0], state.step
        self.text.copy_(text)
        _load_state_(self.state, state)
        inputs = (pcs, rgbs, targets)
        for s, a in zip(self.slot, inputs):
            s.copy_(a[0])       # the warm-up's input: the first step's
        if self.on_card:
            for gate in {self._gate(step0 + t) for t in range(T)}:
                if self.programs[gate][0].graph is None:
                    self._capture(self.programs[gate])
            marks = [torch.cuda.Event(enable_timing=True)
                     for _ in range(T + 1)]
        outs, step_ms = None, []
        for t in range(T):
            if self.on_card:
                marks[t].record()
            else:
                t0 = time.perf_counter()
            for s, a in zip(self.slot, inputs):
                s.copy_(a[t])
            out = self._run_step(self.programs[self._gate(step0 + t)])
            if outs is None:
                outs = StepOutput(*(None if o is None else
                                    o.new_empty((T, *o.shape)) for o in out))
            for buf, o in zip(outs, out):
                if o is not None:
                    buf[t].copy_(o)
            if not self.on_card:
                step_ms.append((time.perf_counter() - t0) * 1e3)
        if self.on_card:
            marks[T].record()
            marks[T].synchronize()
            step_ms = [marks[t].elapsed_time(marks[t + 1]) for t in range(T)]
        final = clone_state(self.state)
        final.step = step0 + T
        return final, outs, step_ms


class ScanFn:
    """`make_scan_fn`'s result: scan_fn(text, state, pcs, rgbs, targets)
    -> (state, StepOutput with a leading T axis), over time-leading
    (T, [S,] B, ...) device tensors.  It keeps one `_StreamRunner` (one
    set of captured graphs on the card) per shape and reuses it across
    calls, as the JAX CLI reuses one jitted scan across corruptions.
    `step_ms` holds the last call's ms a step.  `axis_name`: a process
    group over which the step sums the fits' statistics
    (`make_step_fn`); `encode_fn`: the step's encoder (`make_step_fn`);
    `step`: another step of `cfg`'s method to scan (the class-sharded
    steps of `parallel/ep.py`)."""

    def __init__(self, cfg: Config, model: Callable, axis_name=None,
                 step: Optional[Callable] = None,
                 encode_fn: Optional[Callable] = None):
        self.step = (step if step is not None
                     else make_step_fn(cfg, model, axis_name=axis_name,
                                       encode_fn=encode_fn))
        self.noise = cfg.dota.use_mode_dota
        self.gated = self.noise and cfg.dota.res_learning
        self.runners: dict = {}
        self.step_ms: list = []

    def __call__(self, text: torch.Tensor, state: EngineState, pcs, rgbs,
                 targets):
        key = (text.device, tuple(text.shape),
               *((a.dtype, tuple(a.shape[1:])) for a in (pcs, rgbs, targets)))
        if key not in self.runners:
            self.runners[key] = _StreamRunner(
                self.step, self.gated, self.noise, text, state,
                tuple(a[0] for a in (pcs, rgbs, targets)))
        state, outs, self.step_ms = self.runners[key].run(
            text, state, pcs, rgbs, targets)
        return state, outs


def make_scan_fn(cfg: Config, model: Callable, axis_name=None,
                 encode_fn: Optional[Callable] = None) -> ScanFn:
    """The stream's scan for `cfg`; pass one to every `run_stream_scan` of
    a run to reuse its captured step.  With `axis_name` (a process group)
    its step is the psum step of `make_step_fn`; with `encode_fn` its
    encoder is that one (a tensor-parallel trunk's sums then split the
    captured step into segments, as the psum step's do)."""
    return ScanFn(cfg, model, axis_name, encode_fn=encode_fn)


def run_stream_scan(cfg: Config, model: Callable,
                    text_features_initial: torch.Tensor, pcs, rgbs, targets,
                    seed: int = 42, initial_state: Optional[EngineState] = None,
                    scan_fn: Optional[ScanFn] = None):
    """Run one stream as a scan of its step (the JAX package's
    `run_stream_scan`): the stream goes to the device once; on the card
    one step is captured as a CUDA graph (two with MODE-DOTA's residual
    learning: step 0 without the Adam loop, the later steps with it; the
    cache's step in three parts around its CG) and replayed T times.

    Args:
      pcs, rgbs: (T, B, N, 3); targets: (T, B); numpy arrays or tensors.
      initial_state: resume the adaptation trajectory from this carry
        instead of a fresh init (continual TTA).
      scan_fn: `make_scan_fn(cfg, model)`, reused across calls.
    Returns:
      (final EngineState, StepOutput with a leading T axis).
    """
    dev = text_features_initial.device
    scan_fn = scan_fn if scan_fn is not None else make_scan_fn(cfg, model)
    state = (initial_state if initial_state is not None
             else init_state(cfg, text_features_initial, seed))
    return scan_fn(text_features_initial, state,
                   *(torch.as_tensor(a).to(dev) for a in (pcs, rgbs, targets)))


def run_streams_scan(cfg: Config, model: Callable,
                     text_features_initial: torch.Tensor, pcs, rgbs, targets,
                     seed: int = 42, scan_fn: Optional[ScanFn] = None):
    """Run S independent streams as one scan of the S-stream step (the JAX
    package's `run_streams_vmapped`).

    Args:
      pcs, rgbs: (S, T, B, N, 3); targets: (S, T, B).
    Returns:
      (final EngineState with a leading S axis, StepOutput with leading
      (T, S) axes).
    """
    dev = text_features_initial.device
    scan_fn = scan_fn if scan_fn is not None else make_scan_fn(cfg, model)
    state = init_states_streams(cfg, text_features_initial, len(pcs), seed)
    return scan_fn(text_features_initial, state,
                   *(torch.as_tensor(a).to(dev).transpose(0, 1)
                     for a in (pcs, rgbs, targets)))
