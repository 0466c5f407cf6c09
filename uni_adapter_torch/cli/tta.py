"""Evaluation CLI: the per-corruption online-TTA loop (mirror of
`uni_adapter_tpu/cli/tta.py`, its sequential replicated path).

    python -m uni_adapter_torch.cli.tta --root DATA --corruption uniform \
        --precomputed-text-features large [--device cuda|cpu]
    python -m uni_adapter_torch.cli.tta --vlm3d openshape|ulip ... \
        --precomputed-text-features BANK.npy
    python -m uni_adapter_torch.cli.tta ... --checkpoint-path POINT.pt \
        [--clip-checkpoint-path TEXT.pt]

    python -m uni_adapter_torch.cli.tta --corruption all \
        --vmap-corruptions true ...
    python -m torch.distributed.run --nproc-per-node N \
        -m uni_adapter_torch.cli.tta --dist-mode sharded|psum ...

`--vlm3d` picks the backbone: uni3d (Uni3D-L, the default), ulip
(ULIP-2 Point-BERT, 512-d features) or openshape (PPTA, `vitg14` 1280-d
or `vitl14` 768-d); the anchors must have the backbone's width.  They come
from `--precomputed-text-features` (a shipped size key or a file) when it
is set and present; otherwise (a configured bank that is missing warns)
from the backbone's CLIP text tower (`models/clip_text.py`, the preset of
`--vlm3d`, `openshape_{--oshape-version}` for OpenShape) in bf16 on the
run's device, over the labels and the `--template-key` templates.
`--checkpoint-path` lays a reference-layout torch checkpoint over the
point backbone and `--clip-checkpoint-path` one over the text tower
(`models/loader.py`); what a checkpoint does not cover keeps its random
init from `--seed`, and is logged.

Runs on the GPU unless `--device cpu` is passed; asked for `cuda` on a
host without one, it raises.  `--compute-dtype` (bfloat16, the default, or
float32) picks the kernels on the card; any other dtype raises at the
first kernel, naming it.  Writes `results.json` (adapted top-1 per
corruption) and `results_zs.json` (the frozen anchors' top-1 from the
same forwards) under `<output-dir>/<name>/`, in the JAX CLI's shape.
`--corruption all` runs the 15 corruption streams one after the other,
each from a fresh state; with `--continual true` one adaptation
trajectory runs through them all, and with `--vmap-corruptions true` the
15 streams run together, one step of each at a time (the encoder takes
their 2·15 clouds in one forward), truncated to the shortest.
Each stream runs as a scan of its step (`engine.run_stream_scan`, the JAX
CLI's default) over its whole batches: on the card one step is captured
as a CUDA graph and replayed, and a failed capture raises; `--use-scan
false` runs the eager step loop (`engine.run_stream`) over every batch,
a short last one too, as the JAX CLI's eager loop does.
`--dota-use-mode-dota false` (with the other DOTA variants off, as by
default) runs the prototype cache instead of MODE-DOTA: one forward of the
batch-1 clouds a step, the cache updated, its graph refined by CG (or the
explicit solve, ShapeNetCore's table), and the two fused; `--cache-*`
flags beat the per-dataset table.  `--dota-use-mode-dota false` with
`--dota-use-dota true` runs plain DOTA (`--dota-prior-pre-steps`), with
`--dota-use-gmm-dota true` GMM-DOTA (`--dota-alpha-max`), with
`--dota-use-adaptive-dota true` adaptive-modes DOTA: one forward of the
clouds a step, no noise.  Each corruption's first two clouds are written
as `vis_{corruption}_batch_0.html` into the run's directory;
`--profile-dir DIR` writes a torch.profiler trace of the corruption loop
into DIR.  Without `--checkpoint-path` the point backbone's weights are
random from `--seed` (a warning says so), so the accuracies only show
that the pipeline ran.

Under a multi-process launch (`torch.distributed.run`, or SLURM's or
Open MPI's variables) the ranks join one process group
(`parallel/bootstrap.py`: NCCL where each has a card of its own, gloo for
CPU ranks and ranks that share a card).  `--dist-mode sharded` splits
each stream into contiguous shards, one a rank, each adapted on its own
from seed + rank (with `--vmap-corruptions`, the streams over the ranks);
`--dist-mode psum` gives each step one batch a rank and sums the fits'
statistics over the ranks (`parallel/mesh.py`); `--dist-mode ep` splits
the class axis of the adaptation state and of the anchors over the ranks,
every rank consuming the whole stream (`parallel/ep.py`; with
`--continual` the full-K carry goes on from one corruption to the next,
with `--vmap-corruptions` the streams run together on a grid of one data
row; `--ep-shard-encoder` also splits MODE-DOTA's fused encoder batch).
All three run the stream's scan, and write results.json only (the JAX
CLI's files); only rank 0 logs and writes.

    python -m torch.distributed.run --nproc-per-node N \
        -m uni_adapter_torch.cli.tta --trunk-parallel tp ...

`--trunk-parallel tp` shards the encoder trunk over the whole world
(`parallel/trunk.py`, `parallel/tp.py`: each rank its heads and hidden
columns, the blocks' sums over the ranks) while every rank runs the
replicated adaptation on the whole stream; it writes results.json and
results_zs.json as the run without it does (rank 0).  It takes
`--dist-mode replicated` only and not `--vmap-corruptions`, as the JAX
CLI; `--use-scan`, `--continual` and `--quantize-int8` run with it.  A
model whose heads or MLP hidden width do not divide over the world
raises the JAX CLI's ValueError.  `--trunk-parallel pp` runs the trunk
as pipeline stages over the first `--trunk-stages` ranks (default: the
world), `--pp-interleave` chunks a stage (`parallel/pp.py`), under the
same rules; a depth that does not divide by stages × chunks raises the
JAX CLI's ValueError.  `--trunk-parallel sp` shards the trunk's tokens
over the world, attention an exact ring (`parallel/sp.py`; Uni3D and
ULIP-2, OpenShape and int8 trunks raising the JAX CLI's ValueErrors).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time
from datetime import datetime

import numpy as np
import torch

from uni_adapter_torch import engine
from uni_adapter_torch.anchors import get_text_anchors
from uni_adapter_torch.config import CORRUPTIONS, parse_args
from uni_adapter_torch.data.datasets import load_tta_dataset
from uni_adapter_torch.models.clip_text import create_text_encoder
from uni_adapter_torch.models.loader import build_backbone, load_checkpoint
from uni_adapter_torch.parallel import ep as pep
from uni_adapter_torch.parallel import mesh as pmesh
from uni_adapter_torch.parallel.bootstrap import init_distributed_device
from uni_adapter_torch.parallel.trunk import prepare_trunk_parallel
from uni_adapter_torch.utils import profiling
from uni_adapter_torch.utils.logging import setup_logging
from uni_adapter_torch.visualize import visualize_pointclouds_plotly


def resolve_device(name: str) -> torch.device:
    """`cuda` needs a GPU (no silent CPU fallback); `cpu` is explicit."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda (the default) needs a CUDA GPU; "
                               "pass --device cpu to run the plain PyTorch "
                               "versions of the kernels on the CPU")
        return torch.device("cuda")
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r}")


def set_numerics() -> None:
    """fp32 products stay fp32: the JAX package runs the adaptation's
    contractions (log-likelihoods, EM statistics, logits, the residual
    loss) at Precision.HIGHEST, so TF32 is off; bf16 GEMMs reduce in fp32
    as flax's bf16 Dense does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def check_backbone(kind: str) -> None:
    """An unknown `--vlm3d` raises the JAX CLIs' `ValueError(kind)` (their
    `build_model`), before the backbone is built."""
    if kind not in ("uni3d", "ulip", "openshape"):
        raise ValueError(kind)


def feature_width(m) -> int:
    """The width of the features the configured backbone returns."""
    if m.vlm3d == "ulip":
        return m.ulip_embed_dim
    if m.vlm3d == "openshape":
        return m.oshape_clip_dim if m.oshape_version == "vitg14" else 768
    return m.embed_dim


def finish(summary: dict) -> dict:
    """Log the per-corruption top-1 and write results.json and, where the
    run has the frozen anchors' counts, results_zs.json into the run's
    log_dir (rank 0 alone under a multi-process launch)."""
    logging.info("Summary of Results: %s", summary["acc1"])
    logging.info("Average Top-1: %.3f",
                 float(np.mean(list(summary["acc1"].values()))))
    if not pmesh.is_primary():
        return summary
    for name, key in (("results.json", "acc1"), ("results_zs.json",
                                                  "zs_acc1")):
        if summary[key]:
            with open(os.path.join(summary["log_dir"], name), "w") as f:
                json.dump(summary[key], f, indent=2)
    return summary


def write_batch0_figure(log_dir: str, corr: str, dataset, pcs,
                        targets) -> None:
    """The first two clouds of the stream's first batch as
    `vis_{corr}_batch_0.html`, best effort (a failure is logged)."""
    try:
        viz = {f"Sample_{j}_{dataset.class_names[int(targets[0, j])]}":
               pcs[0, j] for j in range(min(2, pcs.shape[1]))}
        visualize_pointclouds_plotly(
            viz, save_path=os.path.join(log_dir, f"vis_{corr}_batch_0"),
            title=f"{corr} batch 0 input")
    except Exception as e:
        logging.warning("Visualization failed: %s", e)


def run_all_vmapped(cfg, model, text, corruptions, log_dir,
                    step_fn, scan_fn) -> dict:
    """All corruption streams together (`engine.run_streams_scan`, or with
    `--use-scan false` `engine.run_streams`), each truncated to the
    shortest; the JAX CLI's `run_all_vmapped`."""
    stacks = []
    for corr in corruptions:
        c = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, corruption=corr))
        stacks.append(load_tta_dataset(c).as_arrays(
            cfg.data.batch_size, npoints=cfg.data.npoints, seed=cfg.run.seed))
    T = min(s[0].shape[0] for s in stacks)
    pcs, rgbs, tgts = (np.stack([s[i][:T] for s in stacks])
                       for i in range(3))
    logging.info("vmapped sweep: %d streams × %d steps", len(stacks), T)
    t0 = time.perf_counter()
    if cfg.run.dist_mode in ("sharded", "ep"):
        return finish(sharded_streams(cfg, model, text, corruptions, log_dir,
                                      scan_fn, (pcs, rgbs, tgts), t0))
    if scan_fn is not None:
        state, outs = engine.run_streams_scan(cfg, model, text, pcs, rgbs,
                                              tgts, seed=cfg.run.seed,
                                              scan_fn=scan_fn)
        step_ms = scan_fn.step_ms
    else:
        res = engine.run_streams(cfg, model, text, pcs, rgbs, tgts,
                                 seed=cfg.run.seed, step_fn=step_fn)
        state, outs, step_ms = res["state"], res["outputs"], res["step_ms"]
    outs = engine.stack_outputs(outs)                        # (T, S, ...)
    per_stream = engine.summarize_streams(outs, T * cfg.data.batch_size)
    dt = time.perf_counter() - t0
    iters = ([None] * len(corruptions) if outs.cg_iters is None
             else outs.cg_iters.T.tolist())
    finite = torch.isfinite(outs.final_logits).transpose(0, 1).flatten(1)
    summary = {
        "acc1": {c: s["acc1"] for c, s in zip(corruptions, per_stream)},
        "zs_acc1": {c: s["zs_acc1"] for c, s in zip(corruptions, per_stream)},
        "step_ms": dict.fromkeys(corruptions, step_ms),
        "finite": dict(zip(corruptions, finite.all(dim=1).tolist())),
        "steps": dict.fromkeys(corruptions, [0, state.step]),
        "n": dict.fromkeys(corruptions, T * cfg.data.batch_size),
        "cg_iters": dict(zip(corruptions, iters)),
        "log_dir": log_dir}
    total = pcs.shape[0] * pcs.shape[1] * pcs.shape[2]
    logging.info("Zero-shot baseline (same run): %s", summary["zs_acc1"])
    logging.info("Total time: %.1f ms (%.1f pc/s over %d samples)",
                 dt * 1e3, total / dt, total)
    return finish(summary)


def sharded_streams(cfg, model, text, corruptions, log_dir, scan_fn,
                    stream, t0) -> dict:
    """The corruption streams over the ranks: `--dist-mode sharded`
    splits them (`mesh.run_streams_sharded`), `ep` runs them all on a
    grid of one data row, each stream's classes over every rank
    (`ep.run_streams_ep`); per-stream top-1 only, as the JAX CLI's
    distributed sweeps report."""
    pcs = stream[0]
    if cfg.run.dist_mode == "ep":
        logging.info("DP × EP: one data row, each stream's classes over "
                     "%d ranks", pmesh.make_mesh().size)
        state, res = pep.run_streams_ep(
            cfg, model, text, *stream, seed=cfg.run.seed,
            shard_encoder=cfg.run.ep_shard_encoder, scan_fn=scan_fn)
    else:
        state, res = pmesh.run_streams_sharded(cfg, model, text, *stream,
                                               seed=cfg.run.seed,
                                               scan_fn=scan_fn)
    dt = time.perf_counter() - t0
    T, B = pcs.shape[1], pcs.shape[2]
    total = pcs.shape[0] * T * B
    logging.info("Total time: %.1f ms (%.1f pc/s over %d samples)",
                 dt * 1e3, total / dt, total)
    return {"acc1": dict(zip(corruptions, res["acc1_per_stream"])),
            "zs_acc1": {}, "step_ms": dict.fromkeys(corruptions,
                                                    scan_fn.step_ms),
            "finite": dict.fromkeys(corruptions),
            "steps": dict.fromkeys(corruptions, [0, state.step]),
            "n": dict.fromkeys(corruptions, T * B),
            "cg_iters": dict.fromkeys(corruptions), "log_dir": log_dir}


def distributed_stream(cfg, model, text, pcs, rgbs, targets, scan_fn) -> dict:
    """One stream over the ranks, `--dist-mode sharded` or `psum`
    (`parallel/mesh.py`), summarised as the JAX CLI summarises it: the
    accuracies over the whole stream, no zero-shot counts."""
    run = (pmesh.run_stream_sharded if cfg.run.dist_mode == "sharded"
           else pmesh.run_stream_psum)
    state, res = run(cfg, model, text, pcs, rgbs, targets,
                     seed=cfg.run.seed, scan_fn=scan_fn)
    return {**res, "n": res["n_samples"], "step_ms": scan_fn.step_ms,
            "finite": None, "cg_iters": None, "state": state}


def ep_stream(cfg, model, text, pcs, rgbs, targets, initial_state,
              scan_fn) -> dict:
    """One stream with its classes over the ranks, `--dist-mode ep`
    (`ep.run_stream_ep`, from the full-K carry `initial_state` under
    `--continual`), summarised as the JAX CLI summarises it."""
    state, res = pep.run_stream_ep(
        cfg, model, text, pcs, rgbs, targets, seed=cfg.run.seed,
        initial_state=initial_state,
        shard_encoder=cfg.run.ep_shard_encoder, scan_fn=scan_fn)
    return {**res, "n": res["n_samples"], "step_ms": scan_fn.step_ms,
            "finite": None, "cg_iters": None, "state": state}


def scan_stream(cfg, model, text, pcs, rgbs, targets, initial_state,
                scan_fn) -> dict:
    """One stream through `engine.run_stream_scan`, summarised as
    `engine.run_stream` summarises it."""
    state, outs = engine.run_stream_scan(cfg, model, text, pcs, rgbs,
                                         targets, seed=cfg.run.seed,
                                         initial_state=initial_state,
                                         scan_fn=scan_fn)
    n = pcs.shape[0] * pcs.shape[1]
    return {**engine.summarize(outs, n), "n": n, "step_ms": scan_fn.step_ms,
            "finite": bool(torch.isfinite(outs.final_logits).all()),
            "cg_iters": (None if outs.cg_iters is None
                         else outs.cg_iters.tolist()),
            "state": state}


def main(argv=None) -> dict:
    """Run the evaluation; returns per-corruption `acc1`, `zs_acc1`,
    `step_ms` (each step's ms: on the card under the scan from CUDA events
    between its replays, else wall time ending in a device synchronise;
    under `--vmap-corruptions` the sweep's steps, shared by all), `finite`
    (every final logit finite), `steps` (the state's step counter at the
    stream's start and end), `n` (the clouds adapted on and counted),
    `cg_iters` (the cache path's CG iterations a
    step, None on the DOTA family) and the run's `log_dir`."""
    cfg = parse_args(argv)
    # a multi-process launch joins its process group before anything
    # touches the device; one process is a no-op
    boot = init_distributed_device(cfg.run.device)
    device = boot["device"] or resolve_device(cfg.run.device)
    set_numerics()
    primary = pmesh.is_primary()
    name = cfg.run.name or datetime.now().strftime("%Y_%m_%d-%H_%M_%S")
    log_dir = os.path.join(cfg.run.output_dir, name)
    if primary:
        os.makedirs(log_dir, exist_ok=True)
    setup_logging(os.path.join(log_dir, "out.log") if primary else None,
                  level=logging.INFO if primary else logging.WARNING)
    logging.info("Running Experiment: %s on %s, compute dtype %s", name,
                 torch.cuda.get_device_name(device) if device.type == "cuda"
                 else "cpu", cfg.model.compute_dtype)
    logging.info("Config: %s", cfg)
    if boot["distributed"]:
        logging.info("distributed: process %d/%d (%s), dist mode %s, trunk "
                     "parallel %s", boot["rank"], boot["world_size"],
                     boot["backend"], cfg.run.dist_mode,
                     cfg.run.trunk_parallel)

    check_backbone(cfg.model.vlm3d)
    model, _, _ = build_backbone(cfg.model.vlm3d, cfg.model, device,
                                 seed=cfg.run.seed,
                                 checkpoint_path=cfg.model.checkpoint_path)
    if cfg.model.checkpoint_path is None:
        logging.warning("No checkpoint configured — random weights; "
                        "accuracy numbers are not meaningful.")
    # the trunk over the world's ranks (--trunk-parallel tp or pp); the
    # adaptation stays replicated
    encode_fn = None
    if cfg.run.trunk_parallel != "none":
        model, encode_fn = prepare_trunk_parallel(cfg, model)
    text = get_text_anchors_with_fallback(cfg, device)
    width = feature_width(cfg.model)
    if text.shape[1] != width:
        source = cfg.data.precomputed_text_features or "the text tower"
        raise ValueError(f"the anchors ({source}) are {tuple(text.shape)}; "
                         f"--vlm3d {cfg.model.vlm3d} gives {width}-d "
                         f"features")
    # one scan (one set of captured graphs) for every corruption, as the
    # JAX CLI jits one scan_fn; the distributed modes always scan
    dist_mode = cfg.run.dist_mode
    if dist_mode == "ep":
        scan_fn = pep.make_ep_scan_fn(
            cfg, model, pep.class_shard(pmesh.make_mesh(), text.shape[0]),
            cfg.run.ep_shard_encoder)
    elif dist_mode == "psum" and not cfg.run.vmap_corruptions:
        scan_fn = engine.make_scan_fn(cfg, model,
                                      axis_name=pmesh.make_mesh().group)
    elif cfg.run.use_scan or dist_mode != "replicated":
        scan_fn = engine.make_scan_fn(cfg, model, encode_fn=encode_fn)
    else:
        scan_fn = None
    step_fn = (None if scan_fn is not None
               else engine.make_step_fn(cfg, model, encode_fn=encode_fn))

    corruptions = (list(CORRUPTIONS) if cfg.data.corruption == "all"
                   else [cfg.data.corruption])
    # a torch.profiler trace of the loop (--profile-dir)
    profile = (profiling.trace(cfg.run.profile_dir) if cfg.run.profile_dir
               else contextlib.nullcontext())
    if cfg.run.vmap_corruptions and len(corruptions) > 1:
        with profile:
            return run_all_vmapped(cfg, model, text, corruptions, log_dir,
                                   step_fn, scan_fn)
    with profile:
        return finish(run_sequential(cfg, model, text, corruptions, log_dir,
                                     step_fn, scan_fn))


def get_text_anchors_with_fallback(cfg, device: torch.device) -> torch.Tensor:
    """The anchors on `device`: the configured bank if it is present, else
    the text tower of the backbone's preset in bf16 (as the JAX CLI builds
    it), random from `--seed` with `--clip-checkpoint-path` laid over it."""
    if cfg.data.precomputed_text_features:
        try:
            return get_text_anchors(cfg).to(device)
        except FileNotFoundError:
            logging.warning(
                "precomputed bank '%s' not found; falling back to the "
                "on-the-fly text tower", cfg.data.precomputed_text_features)
    m = cfg.model
    preset = (m.vlm3d if m.vlm3d != "openshape"
              else f"openshape_{m.oshape_version}")
    tower = create_text_encoder(preset, device, torch.bfloat16,
                                seed=cfg.run.seed)
    if m.clip_checkpoint_path:
        load_checkpoint(tower, m.clip_checkpoint_path)
    return get_text_anchors(cfg, encode_text_fn=tower, device=device)


def run_sequential(cfg, model, text, corruptions, log_dir, step_fn,
                   scan_fn) -> dict:
    """The corruption streams one after the other: the scan over each
    stream's whole batches, or the eager loop over all its batches (a
    short last one too, `iter_batches`); with `--continual` the carry
    survives from one corruption to the next."""
    summary = {"acc1": {}, "zs_acc1": {}, "step_ms": {}, "finite": {},
               "steps": {}, "n": {}, "cg_iters": {}, "log_dir": log_dir}
    carry_state = None
    for corr in corruptions:
        c = dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, corruption=corr))
        logging.info("%s Processing corruption: %s %s", "=" * 20, corr,
                     "=" * 20)
        dataset = load_tta_dataset(c)
        pcs, rgbs, targets = dataset.as_arrays(
            c.data.batch_size, npoints=c.data.npoints, seed=c.run.seed)
        if pmesh.is_primary():
            write_batch0_figure(log_dir, corr, dataset, pcs, targets)
        t0 = time.perf_counter()
        if cfg.run.dist_mode in ("sharded", "psum"):
            res = distributed_stream(c, model, text, pcs, rgbs, targets,
                                     scan_fn)
        elif cfg.run.dist_mode == "ep":
            res = ep_stream(c, model, text, pcs, rgbs, targets, carry_state,
                            scan_fn)
        elif scan_fn is not None:
            res = scan_stream(c, model, text, pcs, rgbs, targets,
                              carry_state, scan_fn)
        else:
            res = engine.run_stream(
                c, model, text, dataset.iter_batches(
                    c.data.batch_size, npoints=c.data.npoints,
                    seed=c.run.seed),
                seed=c.run.seed, print_freq=c.run.print_freq,
                step_fn=step_fn, initial_state=carry_state)
        dt = time.perf_counter() - t0
        logging.info("Final Results: Acc@1 %.3f Acc@3 %.3f Acc@5 %.3f",
                     res["acc1"], res["acc3"], res["acc5"])
        if "zs_acc1" in res:
            logging.info("Zero-shot baseline (same run): Acc@1 %.3f "
                         "(adaptation %+0.3f)", res["zs_acc1"],
                         res["acc1"] - res["zs_acc1"])
            summary["zs_acc1"][corr] = float(res["zs_acc1"])
        logging.info("Total time: %.3f ms (%.1f pc/s)", dt * 1e3,
                     res["n"] / dt)
        summary["acc1"][corr] = float(res["acc1"])
        summary["step_ms"][corr] = res["step_ms"]
        summary["finite"][corr] = res["finite"]
        summary["n"][corr] = res["n"]
        summary["cg_iters"][corr] = res["cg_iters"]
        summary["steps"][corr] = [carry_state.step if carry_state else 0,
                                  res["state"].step]
        if cfg.run.continual:
            carry_state = res["state"]
    return summary


def cli() -> int:
    main()
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
