"""Where one step of the PyTorch/CUDA port spends its time.

    python3 scripts/torch_step_profile.py [--vlm3d uni3d|openshape|ulip]
        [--npoints N] [--dataset-name NAME] [--compute-dtype float32]
        [--streams S] [--method mode_dota|cache|dota|gmm|adaptive]
        [--residual-precision highest|high|default] [--scan]

On one CUDA card (its name and power limit printed first), one backbone
at its published widths and depth in bf16 (or `--compute-dtype float32`:
the fp32 kernels) with random weights from a seed: Uni3D-L (24 blocks,
width 1024; the default), OpenShape PPTA-G (12 blocks, width 512) or
ULIP-2 Point-BERT (12 blocks, width 384); MODE-DOTA defaults with
residual learning; random N-point clouds (default 1024) on a sphere of
radius 0.5.  `--streams S` (default 1) profiles the step of S streams
together (`engine.init_states_streams`, the 15-corruption sweep's step at
S = 15): every phase below then takes the S streams' clouds, and the
stream loop is `engine.run_streams`.  The anchors are
the shipped bank of the dataset where Uni3D has one (ModelNet40, the
default, ScanObjectNN, ShapeNetCore), else a seeded bank with the
dataset's number of classes (1156 for objaverse_lvis) at the backbone's
width.  After warm-up it prints, per step:

  * wall time (host clock, ending in a device synchronise) of the whole
    step and of its phases run alone: the fused 2B encoder forward, its
    grouping (FPS + kNN or ball query on the 2B clouds; the kernels the
    cloud's size picks), the MODE-DOTA predict + two fits + fusion, and
    the 10-step residual loop (its products at `--residual-precision`);
    with `--method cache`, the prototype-cache step instead (shot
    capacity 8 above 256 classes, as bench.py sets it), on a populated
    cache: K·C samples of a seeded feature stream over all K classes
    (`populated_cache`) go in before the 16 warm-up steps, so the graph
    holds many classes' nodes and the CG runs as many iterations as such
    a graph takes (random weights alone send every cloud to one class).
    Its phases: the encoder forward of the B (S·B) clouds, its grouping,
    `update_cache`, the graph's nodes (the class prototypes on the
    prototype graph), its Laplacian, the CG (its iterations printed;
    timed as the step runs it, reading its stop flags every iteration,
    and with a local copy that reads them every 2 and 4; and at its cap,
    tol 0, reading every 1 and every 4: an iteration's cost and a read's)
    or the explicit solve, and the readout + fusion; with `--method
    dota|gmm|adaptive`, plain DOTA's, GMM-DOTA's or adaptive-modes DOTA's
    step (defaults): the encoder forward of the B (S·B) clouds, its
    grouping, `predict`, `fit` (adaptive: with its split check, computed
    at every fit), `update` (plain DOTA: the Λ inverse; GMM: the
    shrinkage) and the fusion;
  * from `torch.profiler` over 5 steps: device busy time (the sum
    of kernel times) against the unprofiled step's wall time, and device
    time by kernel, in groups: the port's CUDA kernels split into the bf16
    attention core (`attention_core.cuh`: the block's attention step, the
    natural-layout and the (B, H, N, hd) attention), the fp32 attention
    core (its split-TF32 and FFMA kernels), the EVA block's GEMMs and the
    grouping kernels (FPS, kNN, ball query); library GEMMs; the rest.  Each
    group with its ms and launches a step;
  * with `--scan`, the captured step beside the eager one from the same
    carry (the populated cache on `--method cache`) on 12 fresh steps
    (`engine.make_scan_fn`: the stream's step captured as a CUDA graph
    and replayed): ms a step (the scan's from CUDA events between its
    replays), device busy ms a step (a trace of a second run: for the
    scan, replays only) and the idle share of each.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from uni_adapter_torch import engine  # noqa: E402
from uni_adapter_torch.adapt import (adaptive, cache, dota,  # noqa: E402
                                     fusion, gmm, mode_dota, residual)
from uni_adapter_torch.anchors import load_precomputed  # noqa: E402
from uni_adapter_torch.cli.tta import feature_width, set_numerics  # noqa: E402
from uni_adapter_torch.config import (CacheConfig, Config,  # noqa: E402
                                     DataConfig, DotaConfig, ModelConfig,
                                     load_labels)
from uni_adapter_torch.models.loader import (BACKBONES,  # noqa: E402
                                             build_backbone)
from uni_adapter_torch.ops import build  # noqa: E402
from uni_adapter_torch.ops.geometry import (group_points,  # noqa: E402
                                            sample_and_group)
from uni_adapter_torch.utils import math as umath  # noqa: E402

#: The port's CUDA kernels by group: a kernel belongs to the first group
#: one of whose names its profiler name contains (so "attn_f32_kernel"
#: before "attn_kernel").  The fp32 core is two kernels: split TF32
#: (`attn_f32_tc_kernel`, every main path's launch) and FFMA.
PORT_GROUPS = {
    "port: fp32 attention core": ("attn_f32_tc_kernel", "attn_f32_kernel"),
    "port: bf16 attention core": ("attn_kernel",),
    "port: EVA block GEMMs": ("gemm_bf16_kernel", "gemm_f32_kernel"),
    "port: grouping (FPS, kNN, ball query)": (
        "fps_kernel", "fps_grid_kernel", "knn_kernel", "knn_gather_kernel",
        "ballquery_kernel"),
    "port: EVA block backward": (
        "eva_bwd_dq_kernel", "eva_bwd_dkdv_kernel", "eva_bwd_ln_sum_kernel"),
}
PROFILED_STEPS = 5
#: Steps of the captured stream that `--scan` times and traces.
SCAN_STEPS = 12


def wall_ms(fn, n):
    """Median host-clock ms of fn() ending in a synchronise."""
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def group_of(name: str) -> str:
    for group, names in PORT_GROUPS.items():
        if any(k in name for k in names):
            return group
    if "gemm" in name.lower() or "cutlass" in name or "sm90_" in name:
        return "library GEMMs"
    return "other (elementwise, reductions, copies)"


def mode_dota_phases(cfg, state, feat, text) -> dict:
    """The MODE-DOTA step's adaptation phases on the features `feat`."""
    dc = cfg.dota
    clip_w = residual.adapted_text_weights(state.res_state, text)
    logits, _, prob, _ = engine.clip_logits_from(feat, clip_w)

    def adapt():
        ms = state.method_state
        d = mode_dota.predict(ms, feat, dc.epsilon)
        ms = mode_dota.fit(ms, feat, prob, dc.epsilon)
        ms = mode_dota.fit(ms, feat, prob, dc.epsilon)
        fusion.fuse_mode_dota(logits, d, fusion.dota_fusion_weight(
            dc.rho, dc.eta, ms.c.mean(dim=(-2, -1)), 1.0))

    return {
        "predict + 2 fits + fusion": torch.no_grad()(adapt),
        "residual loop (10 Adam steps)": lambda: residual.optimize_residuals(
            state.res_state, text, state.method_state, dc.residual_lr,
            dc.epsilon, dc.residual_steps, precision=dc.residual_precision),
    }


def variant_phases(cfg, method, state, feat, text) -> dict:
    """Plain, GMM or adaptive DOTA's adaptation phases on the features
    `feat`, as `engine.variant_step` runs them."""
    dc, ms = cfg.dota, state.method_state
    logits, _, prob, _ = engine.clip_logits_from(feat, text.T)
    mean = feat.mean(dim=-2, keepdim=True)
    if method == "dota":
        phases = {"predict": lambda: dota.predict(ms, mean,
                                                  dc.prior_pre_steps),
                  "fit": lambda: dota.fit(ms, feat, prob),
                  "update (the Λ inverse)": lambda: dota.update(ms,
                                                                dc.epsilon)}
    elif method == "gmm":
        phases = {"predict": lambda: gmm.predict(ms, mean, dc.alpha_max),
                  "fit": lambda: gmm.fit(ms, feat, prob),
                  "update": lambda: gmm.update(ms, dc.epsilon)}
    else:
        threshold = 10.0 * mode_dota.resolve_sigma_init(dc.sigma,
                                                        text.shape[1])
        phases = {"predict": lambda: adaptive.predict(ms, mean, dc.epsilon),
                  "fit (with the split check)": lambda: adaptive.fit(
                      ms, feat, prob, dc.epsilon, threshold)}
    scores = phases["predict"]()
    w = fusion.dota_fusion_weight(dc.rho, dc.eta, torch.ones(
        feat.shape[:-2], device=feat.device), 1.0)
    phases["fusion"] = (
        (lambda: fusion.fuse_dota(logits, scores, w)) if method == "dota"
        else lambda: fusion.fuse_mode_dota(logits, scores, w))
    return {k: torch.no_grad()(f) for k, f in phases.items()}


def populated_cache(cfg, cs, text, lead, gen):
    """`cs` after K·C samples, one a stream a step, through
    `update_cache` as the step calls it: each a unit feature
    0.5·g + 0.6·(w·a + (1 − w)·b) + noise (g a direction all share, a and
    b the anchors of two random classes of the K, w in 0.5-0.7), so the
    predictions spread over the K classes, classes fill and merge, and
    the shared g connects the graph's nodes across classes (chip_smoke's
    `cache_sequence` over all classes).  Prints the occupancy."""
    cc, scale = cfg.cache, cfg.model.logit_scale
    K, D = text.shape
    n = K * cc.shot_capacity
    dev = text.device
    g = torch.randn(D, generator=gen, device=dev)
    g = g / g.norm()
    pairs = torch.randint(0, K, (n, *lead, 2), generator=gen, device=dev)
    w = 0.5 + 0.2 * torch.rand(n, *lead, 1, generator=gen, device=dev)
    noise = torch.randn(n, *lead, D, generator=gen, device=dev)
    for t in range(n):
        f = (0.5 * g + 0.6 * (w[t] * text[pairs[t, ..., 0]]
                              + (1 - w[t]) * text[pairs[t, ..., 1]])
             + 0.01 * noise[t])
        f = (f / f.norm(dim=-1, keepdim=True))[..., None, :]
        _, ent, prob, pred = engine.clip_logits_from(f, text.T, scale)
        cs, _ = cache.update_cache(
            cs, pred, f, umath.normalized_entropy(ent[..., 0], K), prob,
            text.T, beta=cc.beta, logit_scale=scale)
    slots = cs.valid.sum(dim=(-2, -1))
    classes = cs.valid.any(dim=-1).sum(dim=-1)
    print(f"populated cache: {n} samples a stream; slots filled "
          f"{slots.tolist()} of {K * cc.shot_capacity}, classes held "
          f"{classes.tolist()} of {K}")
    return cs


def cg_read_every(A, b, every: int, max_iter: int = 100, tol: float = 1e-5):
    """`utils/math.conjugate_gradient` with the host reading the stop flags
    only every `every` iterations (the step reads them every iteration):
    the same result, since stopped systems are frozen, with fewer waits
    for the device and up to every − 1 dead iterations."""
    x = torch.zeros_like(b)
    r, p = b, b
    rz = torch.sum(r * r, dim=-2)
    done = torch.zeros(rz.shape[:-1], dtype=torch.bool, device=b.device)
    for i in range(max_iter):
        Ap = torch.matmul(A, p)
        alpha = (rz / (torch.sum(p * Ap, dim=-2) + 1e-8)).unsqueeze(-2)
        keep = (~done)[..., None, None]
        x = torch.where(keep, x + alpha * p, x)
        r_new = r - alpha * Ap
        rz_new = torch.sum(r_new * r_new, dim=-2)
        p = torch.where(keep, r_new + (rz_new / (rz + 1e-8)).unsqueeze(-2)
                        * p, p)
        r = torch.where(keep, r_new, r)
        rz = torch.where((~done)[..., None], rz_new, rz)
        done = done | torch.all(rz < tol, dim=-1)
        if (i + 1) % every == 0 and bool(done.all()):
            break
    return x


def cache_phases(cfg, cs, feat, text) -> dict:
    """The cache step's phases after the encoder, each on the outputs of
    the one before, as `compute_cache_logits` runs them; prints the CG's
    iterations."""
    cc, scale = cfg.cache, cfg.model.logit_scale
    K, C = text.shape[0], cc.shot_capacity
    logits, ent, prob, pred = engine.clip_logits_from(feat, text.T, scale)

    def update():
        return cache.update_cache(
            cs, pred, feat[..., :1, :],
            umath.normalized_entropy(ent[..., 0], K), prob[..., :1, :],
            text.T, beta=cc.beta, logit_scale=scale)[0]

    cs2 = update()
    nodes, probs, valid = cache.graph_nodes(cs2, cc.graph_mode)
    mode = "dense" if nodes.shape[-2] == K * C else "prototype"
    system = lambda: umath.refinement_system(             # noqa: E731
        nodes, probs, valid, cc.threshold, cc.lambda_reg)
    graph = cache.GraphSystem(nodes, valid, *system())
    L, b = graph.L, graph.rhs
    ref = cache.start_refinement(cs2, cc.threshold, cc.lambda_reg,
                                 cc.use_new_approximation, cc.graph_mode)
    phases = {"update_cache": update,
              f"graph nodes ({mode})": lambda: cache.graph_nodes(
                  cs2, cc.graph_mode),
              f"graph Laplacian ({mode})": system}
    if cc.use_new_approximation:
        umath.run_cg(lambda: cache.refinement_iteration(ref), cc.cg_max_iter)
        iters = ref.cg.iters
        print(f"CG iterations: {iters.tolist()} (max {cc.cg_max_iter}); "
              f"{mode} graph of {nodes.shape[-2]} nodes, "
              f"{valid.sum(dim=-1).tolist()} valid")
        phases["CG (the step's: stop flags read every iteration)"] = (
            lambda: umath.conjugate_gradient(L, b, max_iter=cc.cg_max_iter))
        for every in (2, 4):
            phases[f"CG, stop flags read every {every}"] = (
                lambda every=every: cg_read_every(L, b, every,
                                                  cc.cg_max_iter))
        # at its cap (tol 0: no system stops): the cost of an iteration,
        # and of the host's read of the flags (every one against every 4)
        cap = cc.cg_max_iter
        phases[f"CG at its cap ({cap} iterations), flags read every 1"] = (
            lambda: umath.conjugate_gradient(L, b, max_iter=cap, tol=0.0))
        phases[f"CG at its cap ({cap} iterations), flags read every 4"] = (
            lambda: cg_read_every(L, b, 4, cap, tol=0.0))
    else:
        phases["explicit solve"] = lambda: umath.solve_explicit(L, b)
    phases["readout + fusion"] = lambda: fusion.fuse_cache(
        logits, cache.graph_readout(feat, ref), scale)
    return phases


def device_busy_ms(fn, n_steps: int) -> float:
    """The sum of the kernels' durations a step in a trace of fn() (which
    runs n_steps steps)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.device_time_total for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               ) / 1e3 / n_steps


def scan_profile(cfg, model, text, state, pcs) -> dict:
    """The captured step (the stream's scan, `engine.make_scan_fn`: its
    step captured as a CUDA graph and replayed) beside the eager one (the
    same step called once a step with a synchronise after it, as
    `engine.run_stream` runs it), both from the same carry over the same
    SCAN_STEPS steps of clouds `pcs` ((SCAN_STEPS, [S,] 1, N, 3) on the
    card): ms a step (median of the steps after the first two; the
    scan's from CUDA events between its replays), device busy ms a step
    (a trace of a second run: for the scan, replays only) and the idle
    share of each."""
    rgbs = torch.ones_like(pcs)
    tgts = torch.zeros(pcs.shape[:-2], dtype=torch.int64, device=pcs.device)
    scan_fn = engine.make_scan_fn(cfg, model)

    def eager():
        st, ms = state, []
        for t in range(SCAN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _ = scan_fn.step(text, st, (pcs[t], rgbs[t], tgts[t]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    def scan():
        scan_fn(text, state, pcs, rgbs, tgts)
        return scan_fn.step_ms

    out = {}
    for name, run in (("eager", eager), ("captured", scan)):
        run()                             # warm-up; the scan captures
        ms = statistics.median(run()[2:])
        busy = device_busy_ms(run, SCAN_STEPS)
        out.update({f"{name}_ms": ms, f"{name}_busy_ms": busy,
                    f"{name}_idle": 1 - busy / ms})
        print(f"scan: {name} {ms:.3f} ms/step, device busy {busy:.3f} ms "
              f"a step, {100 * (1 - busy / ms):.1f}% idle")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vlm3d", choices=sorted(BACKBONES), default="uni3d")
    ap.add_argument("--npoints", type=int, default=1024)
    ap.add_argument("--dataset-name", default="modelnet")
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--streams", type=int, default=1)
    ap.add_argument("--method", choices=["mode_dota", "cache", "dota", "gmm",
                                         "adaptive"], default="mode_dota")
    ap.add_argument("--residual-precision", default="highest",
                    choices=list(residual.PRECISIONS))
    ap.add_argument("--scan", action="store_true")
    args = ap.parse_args()
    kind, npoints, S = args.vlm3d, args.npoints, args.streams
    lead = (S,) if S > 1 else ()   # the stream axis of every tensor
    if not torch.cuda.is_available():
        sys.exit("torch_step_profile: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    build.build_all()
    set_numerics()
    dev = torch.device("cuda")
    use_cache = args.method == "cache"
    variant = args.method in ("dota", "gmm", "adaptive")
    cfg = Config(model=ModelConfig(vlm3d=kind,
                                   compute_dtype=args.compute_dtype),
                 dota=DotaConfig(use_mode_dota=args.method == "mode_dota",
                                 use_dota=args.method == "dota",
                                 use_gmm_dota=args.method == "gmm",
                                 use_adaptive_dota=args.method == "adaptive",
                                 residual_precision=args.residual_precision),
                 data=DataConfig(dataset_name=args.dataset_name)).resolve()
    dc = cfg.dota
    model, n_group, group_size = build_backbone(kind, cfg.model, dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    text = None
    if kind == "uni3d":
        try:
            text = load_precomputed("large", args.dataset_name).to(dev)
        except KeyError:                    # no shipped bank for the family
            pass
    if text is None:                        # a seeded, row-normalised bank
        text = torch.randn(len(load_labels(cfg)), feature_width(cfg.model),
                           generator=gen, device=dev)
        text = text / text.norm(dim=1, keepdim=True)
    K = text.shape[0]
    if use_cache and K > 256:               # bench.py's LVIS cache
        cfg = dataclasses.replace(cfg, cache=dataclasses.replace(
            cfg.cache, shot_capacity=8))
    print(f"{kind}, {npoints} points, {args.dataset_name}, "
          f"{args.compute_dtype}: anchors {tuple(text.shape)}"
          + (f", {S} streams" if lead else "")
          + (f"; the cache: {cfg.cache}" if use_cache
             else f"; {args.method}" if variant
             else f"; residual precision {dc.residual_precision}"))
    step = engine.make_step_fn(cfg, model)
    encode = engine.encode_with(kind, model)

    def sphere(*shape):
        x = torch.randn(*shape, 3, generator=gen, device=dev)
        return 0.5 * x / x.norm(dim=-1, keepdim=True)

    def batch():
        pc = sphere(*lead, 1, npoints)
        return pc, torch.ones_like(pc), torch.zeros(*lead, 1,
                                                    dtype=torch.int64,
                                                    device=dev)

    state = (engine.init_states_streams(cfg, text, S) if lead
             else engine.init_state(cfg, text))
    if use_cache:
        state = dataclasses.replace(state, method_state=populated_cache(
            cfg, state.method_state, text, lead, gen))
    for _ in range(16 if use_cache else 3):  # warm-up; step > 0 after it
        state, _ = step(text, state, batch())
    pc, rgb, tgt = batch()
    if use_cache or variant:                # one forward of the S·B clouds
        two_b = "SB" if lead else "B"
        xyz2 = pc.reshape(-1, npoints, 3)
    else:
        # the encoder's 2·S clouds: every stream's clean cloud, then its
        # noisy
        two_b = "2SB" if lead else "2B"
        xyz2 = torch.cat([pc.reshape(-1, npoints, 3)] * 2)
    rgb2 = torch.ones_like(xyz2)
    with torch.no_grad():
        feat = encode(xyz2, rgb2)[:S].reshape(*lead, 1, -1)
    if kind == "openshape":
        sa = model.ppat.sa
        grouping = lambda: sample_and_group(            # noqa: E731
            sa.npoint, sa.radius, sa.nsample, xyz2,
            torch.cat([xyz2, rgb2], dim=-1))
    else:
        grouping = lambda: group_points(                # noqa: E731
            xyz2, rgb2 if kind == "uni3d" else None, n_group, group_size)
    phases = {
        "step": lambda: step(text, state, (pc, rgb, tgt)),
        f"encoder forward ({two_b})": lambda: torch.no_grad()(encode)(
            xyz2, rgb2),
        f"grouping ({two_b})": grouping,
    }
    if use_cache:
        phases.update(cache_phases(cfg, state.method_state, feat, text))
    elif variant:
        phases.update(variant_phases(cfg, args.method, state, feat, text))
    else:
        phases.update(mode_dota_phases(cfg, state, feat, text))
    timings = {k: wall_ms(f, 10) for k, f in phases.items()}
    # the same step as the stream loop runs it: fresh clouds from the host
    # each step, state carried over
    if lead:
        clouds = sphere(S, 12, 1, npoints).cpu().numpy()
        res = engine.run_streams(cfg, model, text, clouds,
                                 np.ones_like(clouds),
                                 np.zeros((S, 12, 1), np.int64), step_fn=step)
        loop = "run_streams"
    else:
        clouds = sphere(12, 1, npoints).cpu()
        res = engine.run_stream(cfg, model, text, (
            (c.numpy(), torch.ones_like(c).numpy(), [0]) for c in clouds),
            step_fn=step)
        loop = "run_stream"
    timings[f"{loop} step (median of steps 2-11)"] = statistics.median(
        res["step_ms"][2:])
    for k, v in timings.items():
        print(f"wall {k}: {v:.3f} ms")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILED_STEPS):
            state, _ = step(text, state, batch())
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    by_kernel = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name][0] += ev.device_time_total / 1e3
            by_kernel[ev.name][1] += 1
    busy = sum(v[0] for v in by_kernel.values()) / PROFILED_STEPS
    # the profiler slows the host, not the kernels: the share is taken
    # against the unprofiled step's wall time
    share = busy / timings["step"]
    print(f"device busy {busy:.3f} ms/step of {timings['step']:.3f} ms "
          f"unprofiled wall: {100 * share:.1f}% busy, "
          f"{100 * (1 - share):.1f}% idle (profiled wall {wall:.1f} ms/step)")
    groups = collections.defaultdict(float)
    group_launches = collections.defaultdict(int)
    for name, (ms, n) in by_kernel.items():
        groups[group_of(name)] += ms / PROFILED_STEPS
        group_launches[group_of(name)] += n // PROFILED_STEPS
    port = sum(ms for g, ms in groups.items() if g.startswith("port"))
    print(f"group port CUDA kernels (all): {port:.3f} ms/step")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"group {g}: {ms:.3f} ms/step, {group_launches[g]} launches "
              f"a step")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, n) in top:
        print(f"kernel {ms / PROFILED_STEPS:9.3f} ms/step "
              f"{n // PROFILED_STEPS:6d}x  {name[:90]}")
    scan = (scan_profile(cfg, model, text, state,
                         sphere(SCAN_STEPS, *lead, 1, npoints))
            if args.scan else None)
    print(json.dumps({"vlm3d": kind, "npoints": npoints, "streams": S,
                      "method": args.method,
                      "residual_precision": dc.residual_precision,
                      "dataset_name": args.dataset_name,
                      "compute_dtype": args.compute_dtype, "card": card,
                      "wall_ms": timings,
                      "profiled_wall_ms": wall, "device_busy_ms": busy,
                      "groups_ms": groups,
                      "group_launches_per_step": group_launches,
                      "scan": scan}))


if __name__ == "__main__":
    main()
