"""Where one MODE-DOTA step of the PyTorch/CUDA port spends its time.

    python3 scripts/torch_step_profile.py [--vlm3d uni3d|openshape|ulip]
        [--npoints N] [--dataset-name NAME] [--compute-dtype float32]
        [--streams S]

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
    the 10-step residual loop;
  * from `torch.profiler` over 5 steps: device busy time (the sum
    of kernel times) against the unprofiled step's wall time, and device
    time by kernel, in groups: the port's CUDA kernels split into the bf16
    attention core (`attention_core.cuh`: the block's attention step, the
    natural-layout and the (B, H, N, hd) attention), the fp32 attention
    core (its split-TF32 and FFMA kernels), the EVA block's GEMMs and the
    grouping kernels (FPS, kNN, ball query); library GEMMs; the rest.  Each
    group with its ms and launches a step.
"""
from __future__ import annotations

import argparse
import collections
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
from uni_adapter_torch.adapt import fusion, mode_dota, residual  # noqa: E402
from uni_adapter_torch.anchors import load_precomputed  # noqa: E402
from uni_adapter_torch.cli.tta import feature_width, set_numerics  # noqa: E402
from uni_adapter_torch.config import (Config, DataConfig,  # noqa: E402
                                     ModelConfig, load_labels)
from uni_adapter_torch.models.loader import (BACKBONES,  # noqa: E402
                                             build_backbone)
from uni_adapter_torch.ops import build  # noqa: E402
from uni_adapter_torch.ops.geometry import (group_points,  # noqa: E402
                                            sample_and_group)

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
}
PROFILED_STEPS = 5


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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vlm3d", choices=sorted(BACKBONES), default="uni3d")
    ap.add_argument("--npoints", type=int, default=1024)
    ap.add_argument("--dataset-name", default="modelnet")
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--streams", type=int, default=1)
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
    cfg = Config(model=ModelConfig(vlm3d=kind,
                                   compute_dtype=args.compute_dtype),
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
    print(f"{kind}, {npoints} points, {args.dataset_name}, "
          f"{args.compute_dtype}: anchors {tuple(text.shape)}"
          + (f", {S} streams" if lead else ""))
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
    for _ in range(3):                       # warm-up; step > 0 after this
        state, _ = step(text, state, batch())
    pc, rgb, tgt = batch()
    # the encoder's 2·S clouds: every stream's clean cloud, then its noisy
    two_b = "2SB" if lead else "2B"
    xyz2 = torch.cat([pc.reshape(-1, npoints, 3)] * 2)
    rgb2 = torch.ones_like(xyz2)
    with torch.no_grad():
        feat = encode(xyz2, rgb2)[:S].reshape(*lead, 1, -1)
    clip_w = residual.adapted_text_weights(state.res_state, text)
    logits, _, prob, _ = engine.clip_logits_from(feat, clip_w)

    def adapt():
        ms = state.method_state
        d = mode_dota.predict(ms, feat, dc.epsilon)
        ms = mode_dota.fit(ms, feat, prob, dc.epsilon)
        ms = mode_dota.fit(ms, feat, prob, dc.epsilon)
        fusion.fuse_mode_dota(logits, d, fusion.dota_fusion_weight(
            dc.rho, dc.eta, ms.c.mean(dim=(-2, -1)), 1.0))

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
        "predict + 2 fits + fusion": torch.no_grad()(adapt),
        "residual loop (10 Adam steps)": lambda: residual.optimize_residuals(
            state.res_state, text, state.method_state, dc.residual_lr,
            dc.epsilon, dc.residual_steps),
    }
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
    print(json.dumps({"vlm3d": kind, "npoints": npoints, "streams": S,
                      "dataset_name": args.dataset_name,
                      "compute_dtype": args.compute_dtype, "card": card,
                      "wall_ms": timings,
                      "profiled_wall_ms": wall, "device_busy_ms": busy,
                      "groups_ms": groups,
                      "group_launches_per_step": group_launches}))


if __name__ == "__main__":
    main()
