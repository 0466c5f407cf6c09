"""TTA engine: the online adaptation loop for the three backbones, by
MODE-DOTA or by the prototype cache (mirror of `uni_adapter_tpu/engine.py`,
its MODE-DOTA and cache branches).

The JAX package jit-compiles one pure step and scans it over the stream;
here the step runs eagerly and `run_stream` is a Python loop.  The state
stays on the device between steps.  A MODE-DOTA step reads nothing back
to the host (the residual-learning gate `step > 0` is a host integer); a
cache step reads only the CG's stop flags, once an iteration
(`utils/math.conjugate_gradient`).

The MODE-DOTA noise comes from a `torch.Generator` carried in the state;
`step(..., noise=...)` takes it from the caller instead, which is how the
tests feed both packages the same draw.

S independent streams (the JAX package's `run_streams_vmapped`, the
15-corruption sweep) run as one: the state from `init_states_streams`
carries a leading stream axis and one generator a stream, and the same
step takes (S, B, ...) batches.  `torch.func.vmap` cannot wrap the
residual loop's `torch.autograd.grad` or the kernels' launches, so the
axis is written out: the encoder takes one forward of the 2·S·B clouds,
the adaptation batched products, the residual loop one gradient of the
summed per-stream losses.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Iterable, NamedTuple, Optional, Union

import torch

from uni_adapter_torch.adapt import cache, fusion, mode_dota, residual
from uni_adapter_torch.config import Config
from uni_adapter_torch.utils.math import normalized_entropy, softmax_entropy
from uni_adapter_torch.utils.metrics import topk_correct


@dataclass
class EngineState:
    """The adaptation carry: one stream's, or S streams' with a leading
    (S,) axis on every tensor and one generator a stream (the cache path
    draws nothing from it)."""
    method_state: Union[mode_dota.ModeDotaState, cache.CacheState]
    res_state: Optional[residual.ResidualState]
    step: int
    generator: Union[torch.Generator, tuple[torch.Generator, ...]]


class StepOutput(NamedTuple):
    final_logits: torch.Tensor        # ([S,] B, K)
    clip_logits: torch.Tensor         # ([S,] B, K)
    correct: torch.Tensor             # ([S,] 3) top-1/3/5 correct counts
    zs_correct: torch.Tensor          # ([S,] 3) the frozen anchors' counts
    cg_iters: Optional[torch.Tensor] = None   # ([S,]) the cache's CG


def encode_with(kind: str, model: Callable) -> Callable:
    """(pc, rgb) -> L2-normalised (B, D) features for a backbone: uni3d
    takes xyz‖color, ulip xyz only, openshape (xyz, xyz‖color)."""
    if kind not in ("uni3d", "ulip", "openshape"):
        raise ValueError(f"unknown backbone {kind!r}")

    def encode(pc: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
        if kind == "uni3d":
            feat = model(torch.cat([pc, rgb], dim=-1))
        elif kind == "ulip":
            feat = model(pc)
        else:
            feat = model(pc, torch.cat([pc, rgb], dim=-1))
        return feat / (torch.linalg.norm(feat, dim=-1, keepdim=True) + 1e-12)

    return encode


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
    """The carry: MODE-DOTA's mixture from the anchors and zero residuals,
    or an empty prototype cache."""
    K, D = text_features_initial.shape
    dc = cfg.dota
    rs = None
    if uses_cache(cfg):
        ms = cache.init(K, cfg.cache.shot_capacity, D,
                        device=text_features_initial.device)
    else:
        ms = mode_dota.init(dc.epsilon, dc.sigma, D, K,
                            text_features_initial.T, num_modes=dc.mode_M)
        if dc.res_learning:
            rs = residual.init(text_features_initial)
    gen = torch.Generator(device=text_features_initial.device)
    gen.manual_seed(seed)
    return EngineState(ms, rs, 0, gen)


def _stack(states):
    """Single-stream NamedTuple states as one with a leading stream axis;
    their int fields (sample and Adam counts) must agree."""
    fields = []
    for vals in zip(*states):
        if isinstance(vals[0], torch.Tensor):
            fields.append(torch.stack(vals))
        elif len(set(vals)) == 1:
            fields.append(vals[0])
        else:
            raise ValueError(f"streams disagree on a count: {vals}")
    return type(states[0])(*fields)


def init_states_streams(cfg: Config, text_features_initial: torch.Tensor,
                        n_streams: int, seed: int = 42) -> EngineState:
    """S streams' carry: the single-stream init stacked (MODE-DOTA's init
    draws nothing), stream i's generator seeded seed + i (the JAX
    package's `init_states_vmapped`, the reference's seed+rank)."""
    states = [init_state(cfg, text_features_initial, seed + i)
              for i in range(n_streams)]
    return EngineState(
        _stack([s.method_state for s in states]),
        (None if states[0].res_state is None
         else _stack([s.res_state for s in states])),
        0, tuple(s.generator for s in states))


def make_step_fn(cfg: Config, model: Callable) -> Callable:
    """step(text_init, state, batch, noise=None) -> (state, StepOutput),
    with batch = (pc ([S,] B, N, 3), rgb ([S,] B, N, 3), target ([S,] B))
    and noise, if given, of pc's shape.  With a leading stream axis the
    state is `init_states_streams`'s; the encoder then takes the clean
    clouds of streams 0..S−1 and then their noisy ones as one 2·S·B
    batch, and each stream's noise comes from its own generator.  The
    cache path's step takes no noise (`make_cache_step_fn`)."""
    encode = encode_with(cfg.model.vlm3d, model)
    dc = cfg.dota
    if uses_cache(cfg):
        return make_cache_step_fn(cfg, encode)
    if not dc.use_mode_dota:
        raise NotImplementedError("plain, GMM and adaptive DOTA are not "
                                  "ported (ROADMAP M8)")
    use_res = dc.res_learning
    if use_res:
        residual.check_precision(dc.residual_precision)

    def predict_input(f):
        m = f.mean(dim=-2, keepdim=True)
        if dc.fp16_predict_input:
            m = m.to(torch.float16).to(torch.float32)
        return m

    @torch.no_grad()
    def step(text_init: torch.Tensor, state: EngineState, batch,
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
        feat_both = encode(
            torch.cat([pc.reshape(-1, N, 3), pc_aug.reshape(-1, N, 3)]),
            torch.cat([rgb.reshape(-1, N, 3)] * 2))
        n = feat_both.shape[0] // 2
        feat = feat_both[:n].reshape(*lead, B, -1)
        feat_aug = feat_both[n:].reshape(*lead, B, -1)
        clip_logits, _, prob_map, _ = clip_logits_from(
            feat, clip_weights, scale=cfg.model.logit_scale)

        ms = state.method_state
        dota_logits = mode_dota.predict(ms, predict_input(feat), dc.epsilon)
        ms = mode_dota.fit(ms, feat, prob_map, dc.epsilon)
        # the noise-augmented fit uses the CLEAN prob_map
        ms = mode_dota.fit(ms, feat_aug, prob_map, dc.epsilon)

        res_state = state.res_state
        if use_res and state.step > 0:
            res_state = residual.optimize_residuals(
                res_state, text_init, ms, dc.residual_lr, dc.epsilon,
                num_steps=dc.residual_steps,
                precision=dc.residual_precision)

        w = fusion.dota_fusion_weight(dc.rho, dc.eta,
                                      ms.c.mean(dim=(-2, -1)), float(B))
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
        return EngineState(ms, res_state, state.step + 1,
                           state.generator), out

    return step


def make_cache_step_fn(cfg: Config, encode: Callable) -> Callable:
    """The prototype-cache step, step(text_init, state, batch) ->
    (state, StepOutput): one encoder forward of the clouds (S of them
    with a stream axis), the sample inserted into or merged with its
    predicted class's prototypes, then the cache logits read from the
    cache that already holds it, fused with the clip logits.  Batch 1 a
    stream: with B > 1 only sample 0 would enter the cache while all B
    were scored against it, so B > 1 raises, as in the JAX engine."""
    cc, scale = cfg.cache, cfg.model.logit_scale

    @torch.no_grad()
    def step(text_init: torch.Tensor, state: EngineState, batch):
        pc, rgb, target = batch
        *lead, B, N, _ = pc.shape
        if B != 1:
            raise ValueError(
                f"the prototype-cache path requires batch_size=1 (got {B}): "
                f"one sample a step enters the cache")
        text_init = text_init.to(torch.float32)
        clip_weights = text_init.T
        feat = encode(pc.reshape(-1, N, 3),
                      rgb.reshape(-1, N, 3)).reshape(*lead, B, -1)
        clip_logits, ent, prob_map, pred = clip_logits_from(
            feat, clip_weights, scale=scale)
        cs, _ = cache.update_cache(
            state.method_state, pred, feat[..., :1, :],
            normalized_entropy(ent[..., 0], text_init.shape[0]),
            prob_map[..., :1, :], clip_weights, beta=cc.beta,
            logit_scale=scale)
        # cc.cg_tol is not passed: the JAX engine runs the CG at its
        # default tolerance
        cache_logits, iters = cache.compute_cache_logits(
            feat, cs, cc.threshold, cc.lambda_reg,
            use_new_approximation=cc.use_new_approximation,
            cg_max_iter=cc.cg_max_iter, graph_mode=cc.graph_mode)
        final = fusion.fuse_cache(clip_logits, cache_logits,
                                  logit_scale=scale)
        out = StepOutput(final, clip_logits,
                         topk_correct(final, target, (1, 3, 5)),
                         topk_correct(clip_logits, target, (1, 3, 5)), iters)
        return EngineState(cs, None, state.step + 1, state.generator), out

    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_stream(cfg: Config, model: Callable,
               text_features_initial: torch.Tensor,
               batches: Iterable, seed: int = 42,
               print_freq: Optional[int] = None,
               step_fn: Optional[Callable] = None,
               initial_state: Optional[EngineState] = None) -> dict:
    """Run one stream step by step.

    Args:
      batches: iterable of (pc, rgb, target) numpy arrays or tensors;
        each is moved to the anchors' device.
      initial_state: resume the adaptation trajectory from this carry
        instead of a fresh init (continual TTA: streams chained without a
        reset; the reference re-inits per corruption).
    Returns:
      dict with acc1/acc3/acc5 and zs_acc1 (percent), per-step wall times
      in ms (each step ends in a device synchronise), `finite` (every
      final logit was finite), the cache's CG iterations a step
      (`cg_iters`, None on the other paths) and the final `state`.
    """
    dev = text_features_initial.device
    step = step_fn if step_fn is not None else make_step_fn(cfg, model)
    state = (initial_state if initial_state is not None
             else init_state(cfg, text_features_initial, seed))
    totals = torch.zeros(3, device=dev)
    zs_totals = torch.zeros(3, device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    n = 0
    step_ms, cg_iters = [], []
    for i, (pc, rgb, target) in enumerate(batches):
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
    accs = (100.0 * totals / max(n, 1)).tolist()
    return {"acc1": accs[0], "acc3": accs[1], "acc5": accs[2],
            "zs_acc1": 100.0 * float(zs_totals[0]) / max(n, 1),
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


def summarize_streams(outputs: list[StepOutput],
                      n_per_stream: int) -> list[dict]:
    """Per-stream percent accuracies from `run_streams`'s outputs (the JAX
    package's `summarize_vmapped`)."""
    correct = torch.stack([o.correct for o in outputs]).sum(0).tolist()
    zs = torch.stack([o.zs_correct for o in outputs]).sum(0).tolist()
    return [{"acc1": 100.0 * c[0] / n_per_stream,
             "acc3": 100.0 * c[1] / n_per_stream,
             "acc5": 100.0 * c[2] / n_per_stream,
             "zs_acc1": 100.0 * z[0] / n_per_stream}
            for c, z in zip(correct, zs)]


def summarize(outputs: list[StepOutput], n_samples: int) -> dict:
    """Aggregate per-step outputs into percent accuracies."""
    correct = torch.stack([o.correct for o in outputs]).sum(0).tolist()
    zs = torch.stack([o.zs_correct for o in outputs]).sum(0).tolist()
    return {"acc1": 100.0 * correct[0] / n_samples,
            "acc3": 100.0 * correct[1] / n_samples,
            "acc5": 100.0 * correct[2] / n_samples,
            "zs_acc1": 100.0 * zs[0] / n_samples}
