"""CLI: contrastive pretraining of the Uni3D point encoder into CLIP space
(mirror of `uni_adapter_tpu/cli/pretrain.py`, its data-parallel path).

    python -m uni_adapter_torch.cli.pretrain --device cpu --steps 20 \
        --batch-size 16 --depth 1 --out /tmp/pretrain
    python -m torch.distributed.run --nproc-per-node 2 \
        -m uni_adapter_torch.cli.pretrain --batch-size 16 ...

  sharded corpus (data/streaming.ShardedCorpus, the native mmap reader)
    → deterministic resumable StreamingLoader
    → the batch on the device (streaming.global_batch)
    → train.train_step (fp32 Uni3D; on the card the EVA blocks' attention
      side through the hand-written kernels forward and backward), or
      under a multi-process launch train.make_dp_train_step (negatives
      gathered over the ranks, gradients averaged), or `--parallel pp`:
      parallel/pp.make_pp_train_step (pipeline stages over the ranks,
      each stage's blocks and AdamW moments on its rank, every rank
      reading the whole batch; `--pp-tp-size K` shards each stage's
      blocks over K ranks too, PP × TP), or `--parallel sp`:
      parallel/sp.make_sp_train_step (the trunk's tokens over the ranks,
      attention an exact ring, every rank reading the whole batch)
    → checkpoint.save_state every --ckpt-every steps, stamped with the
      recipe; `--resume` continues the exact batch schedule and refuses a
      checkpoint of another recipe.

Runs on the GPU unless `--device cpu` is passed; asked for `cuda` on a
host without one, it raises.  On the card the EVA blocks need head dim
64 (`--trans-dim` = 64 × `--heads`: Uni3D-L's 1024 and 16), so the demo
widths below (64 and 4, head dim 16) raise there by name; the CPU runs
any width.  Without --pc-shards it writes a small synthetic corpus (the
JAX CLI's, bitwise) under <out>/synthetic, written by rank 0.

A multi-process launch (`torch.distributed.run`, or SLURM's or Open
MPI's variables) joins one process group before anything touches the
device (`parallel/bootstrap.py`: NCCL where each rank has a card of its
own, gloo for CPU ranks and ranks that share a card); each rank reads
only its rows of every global `--batch-size` batch, only rank 0 logs and
writes checkpoints, and `--resume` restores on every rank (`--out` on a
filesystem all ranks share).

`--parallel pp` needs a launch of exactly `--pp-stages` × `--pp-tp-size`
processes (`--pp-stages` default: the world over the tp size), rank =
stage·tp + model rank, one process a device where JAX takes the first
devices of one process (a world of another size raises by name);
`--pp-microbatches` (default: one a stage) splits the batch, and
`--pp-interleave V` runs the interleaved schedule.  Its checkpoint is one
process's whole state (rank 0 gathers the stages' blocks and moments),
stamped with `pp_stages`, `pp_interleave` and `pp_tp_size`; `--resume`
refuses another stage count or interleave, as the JAX CLI does, and
re-shards onto another tp size.

`--parallel sp` runs over a launch of any size, every rank a shard of
the tokens (the JAX CLI's one process over all its devices; a world of
one is the plain step).  Its checkpoint is one process's plain state,
saved by rank 0 and stamped `"parallel": "sp"`; it does not depend on
the world's size, so a checkpoint saved at one size resumes at another,
and `--resume` refuses another `--parallel`, as the JAX CLI does.
"""
from __future__ import annotations

import argparse
import glob
import logging
import os
import time


def _synthetic_corpus(root: str, n_shards: int = 2, per_shard: int = 64,
                      npoints: int = 128, dim: int = 64):
    """Write a tiny random corpus (pc + frozen-tower embedding shards)."""
    import numpy as np

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    pc, tx, im = [], [], []
    for s in range(n_shards):
        for tag, shape, group in (("pc", (per_shard, npoints, 6), pc),
                                  ("text", (per_shard, dim), tx),
                                  ("image", (per_shard, dim), im)):
            # shape in the name: re-running with different --embed-dim /
            # --npoints into the same --out never reuses stale shards
            p = os.path.join(
                root, f"{tag}_{'x'.join(map(str, shape[1:]))}_{s:03d}.npy")
            if not os.path.exists(p):
                np.save(p, rng.standard_normal(shape).astype(np.float32))
            group.append(p)
    return pc, tx, im


def _pp_layout(args, world_size: int) -> tuple:
    """(stages, tp size) of `--parallel pp` over a launch of `world_size`
    processes: the JAX CLI's checks, then the world must be exactly
    stages × tp (one process a device; JAX takes the first devices)."""
    tp = args.pp_tp_size
    if tp < 1 or world_size % tp:
        raise ValueError(f"--pp-tp-size {tp} must divide the device "
                         f"count ({world_size})")
    n_stages = (args.pp_stages if args.pp_stages is not None
                else world_size // tp)
    if not 1 <= n_stages * tp <= world_size:
        raise ValueError(f"--pp-stages {n_stages} x --pp-tp-size {tp} "
                         f"needs {n_stages * tp} devices, have {world_size}")
    if n_stages * tp != world_size:
        raise ValueError(
            f"--parallel pp runs one process a device: --pp-stages "
            f"{n_stages} x --pp-tp-size {tp} needs a launch of exactly "
            f"{n_stages * tp} processes, this one has {world_size}")
    return n_stages, tp


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--pc-shards", default=None,
                        help="glob of point-cloud .npy shards")
    parser.add_argument("--text-shards", default=None)
    parser.add_argument("--image-shards", default=None)
    parser.add_argument("--out", default="outputs/pretrain")
    parser.add_argument("--batch-size", type=int, default=64,
                        help="GLOBAL batch (split across processes)")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--warmup-steps", type=int, default=10)
    parser.add_argument("--weight-decay", type=float, default=0.05)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--prefetch", type=int, default=2)
    parser.add_argument("--ckpt-every", type=int, default=50)
    parser.add_argument("--resume", action="store_true",
                        help="resume from <out>/ckpt if present")
    parser.add_argument("--ckpt-async", action="store_true",
                        help="write checkpoints on a background thread so "
                             "the train loop never stalls on IO (a copy of "
                             "the state is taken at the call: the step "
                             "updates the parameters in place; the atomic "
                             "tmp+rename in checkpoint.save_state still "
                             "guarantees a consistent file pair)")
    parser.add_argument("--log-every", type=int, default=10)
    # model size (Uni3D point encoder; defaults are demo-sized — pass the
    # EVA02-L numbers for a real run)
    parser.add_argument("--depth", type=int, default=2)
    parser.add_argument("--trans-dim", type=int, default=64)
    parser.add_argument("--embed-dim", type=int, default=64,
                        help="must match the frozen-tower embedding dim")
    parser.add_argument("--num-group", type=int, default=16)
    parser.add_argument("--group-size", type=int, default=8)
    parser.add_argument("--encoder-dim", type=int, default=32)
    parser.add_argument("--heads", type=int, default=4)
    parser.add_argument("--parallel", default="dp",
                        choices=["dp", "pp", "sp"],
                        help="dp: data-parallel over the launched "
                             "processes (negatives gathered, gradients "
                             "averaged; one process: the plain step).  pp: "
                             "pipeline stages over the launched processes "
                             "(depth divisible by the stage count; every "
                             "rank reads the whole batch).  sp: the trunk's "
                             "tokens over the launched processes, exact "
                             "ring attention (every rank reads the whole "
                             "batch)")
    parser.add_argument("--pp-microbatches", type=int, default=None,
                        help="GPipe microbatch count (default: one per "
                             "stage); the batch must divide by it")
    parser.add_argument("--pp-stages", type=int, default=None,
                        help="pipeline stage count (default: the world "
                             "over --pp-tp-size); the model depth must "
                             "divide by it")
    parser.add_argument("--pp-interleave", type=int, default=1,
                        help="virtual chunks per stage (interleaved "
                             "schedule, parallel/pp_interleave.py): the "
                             "fill/drain bubble shrinks ~V x; depth must "
                             "divide by stages x V")
    parser.add_argument("--pp-tp-size", type=int, default=1,
                        help="compose PP x TP: Megatron-shard each "
                             "stage's block matrices over this many "
                             "processes; heads and the SwiGLU hidden dim "
                             "must divide by it")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (needs a GPU) or cpu")
    args = parser.parse_args(argv)

    import torch

    from uni_adapter_torch import checkpoint
    from uni_adapter_torch.cli.tta import resolve_device, set_numerics
    from uni_adapter_torch.config import ModelConfig
    from uni_adapter_torch.data.streaming import (ShardedCorpus,
                                                  StreamingLoader,
                                                  global_batch)
    from uni_adapter_torch.models.uni3d import create_uni3d
    from uni_adapter_torch.parallel import collectives
    from uni_adapter_torch.parallel import pp as ppar
    from uni_adapter_torch.parallel import sp as spar
    from uni_adapter_torch.parallel.bootstrap import (init_distributed_device,
                                                      world_info_from_env)
    from uni_adapter_torch.parallel.mesh import make_mesh
    from uni_adapter_torch.train import (init_train_state, load_train_state,
                                         make_dp_train_step, make_optimizer,
                                         train_step)
    from uni_adapter_torch.utils.logging import setup_logging

    pipelined = args.parallel == "pp"
    if pipelined:
        # the launch's layout is checked before any process group exists
        n_stages, tp_size = _pp_layout(args, world_info_from_env()[2])
    # before anything touches the device (one process: a no-op); without
    # it every process of a launch would stream the same rows
    boot = init_distributed_device(args.device)
    device = boot["device"] or resolve_device(args.device)
    set_numerics()
    world = make_mesh()
    primary = world.rank == 0
    os.makedirs(args.out, exist_ok=True)
    setup_logging(os.path.join(args.out, "pretrain.log") if primary else None,
                  level=logging.INFO if primary else logging.WARNING)
    if boot["distributed"]:
        logging.info("distributed: process %d/%d, backend %s, device %s",
                     boot["rank"], boot["world_size"], boot["backend"],
                     device)

    if args.pc_shards:
        pc = sorted(glob.glob(args.pc_shards))
        tx = sorted(glob.glob(args.text_shards)) if args.text_shards else None
        im = (sorted(glob.glob(args.image_shards))
              if args.image_shards else None)
        if not pc:
            raise FileNotFoundError(f"no shards match {args.pc_shards!r}")
        if not tx:
            raise ValueError(
                "--text-shards is required with --pc-shards: the "
                "contrastive objective distils into the frozen TEXT tower "
                "embeddings (pc<->image alone is the masked secondary leg)")
    else:
        logging.info("no --pc-shards: synthetic corpus under %s/synthetic",
                     args.out)
        synth_root = os.path.join(args.out, "synthetic")
        # one writer on a shared filesystem; the others wait, then derive
        # the (now existing) shard paths
        if primary:
            pc, tx, im = _synthetic_corpus(synth_root, dim=args.embed_dim)
        if world.group is not None:
            torch.distributed.barrier(world.group)
        if not primary:
            pc, tx, im = _synthetic_corpus(synth_root, dim=args.embed_dim)
    corpus = ShardedCorpus(pc, tx, im)
    # PP and SP: every rank reads the whole batch (JAX's batch replicates)
    loader = StreamingLoader(corpus, args.batch_size, seed=args.seed,
                             prefetch=args.prefetch,
                             **(dict(process_index=0, process_count=1)
                                if args.parallel != "dp" else {}))
    logging.info("corpus: %d samples in %d shards; %d steps/epoch "
                 "(global batch %d, local %d)", len(corpus), len(corpus.pc),
                 loader.steps_per_epoch, args.batch_size,
                 loader.local_batch_size)

    cfg = ModelConfig(pc_feat_dim=args.trans_dim, embed_dim=args.embed_dim,
                      num_group=args.num_group, group_size=args.group_size,
                      pc_encoder_dim=args.encoder_dim, eva_depth=args.depth,
                      eva_heads=args.heads, compute_dtype="float32")
    model = create_uni3d(cfg, device, torch.float32, seed=args.seed,
                         trainable=True)
    tx_opt = make_optimizer(lr=args.lr, weight_decay=args.weight_decay,
                            total_steps=args.steps,
                            warmup_steps=args.warmup_steps)
    tp_group = None
    if pipelined:
        # this rank's stage (and model shard); the whole model goes
        grid = ppar.make_pp_grid(n_stages, tp_size, 1, world)
        tp_group = grid.model_group
        model, pp_step = ppar.make_pp_train_step(
            model, tx_opt, grid.stages, n_micro=args.pp_microbatches,
            tp_group=tp_group, interleave=args.pp_interleave)
        logging.info("pipeline parallel: %d stages x %d chunks/stage x "
                     "%d blocks/chunk, %d microbatches%s", n_stages,
                     args.pp_interleave,
                     args.depth // (n_stages * args.pp_interleave),
                     args.pp_microbatches or n_stages,
                     f", x {tp_size}-way tensor" if tp_size > 1 else "")
    elif args.parallel == "sp":
        # every rank holds the whole model, a shard of the tokens
        sp_step = spar.make_sp_train_step(model, tx_opt, world.group)
        logging.info("sequence parallel: %d tokens over %d devices "
                     "(ring attention)", args.num_group + 1, world.size)
    state = init_train_state(model, tx_opt)

    ckpt_path = os.path.join(args.out, "ckpt")
    start_step = 0
    if args.resume and os.path.exists(ckpt_path + ".npz"):
        blob = checkpoint.restore_state(ckpt_path, device=device)
        # refuse every silent-divergence vector, not just the batch
        # schedule: a depth mismatch would drop or add trunk blocks, and a
        # weight-decay-recipe change would silently alter the trajectory
        checks = [("data_seed", args.seed), ("global_batch", args.batch_size),
                  ("depth", args.depth),
                  # the corpus SIZE shapes the schedule too: the epoch
                  # permutation is rng.permutation(len(corpus)) and the
                  # resume cursor derives from steps_per_epoch — shards
                  # added/removed under the same glob would silently skip
                  # or repeat samples
                  ("corpus_size", len(corpus)),
                  # the optimizer recipe shapes the whole trajectory: lr /
                  # decay scale the updates, warmup reshapes the schedule.
                  # --steps is deliberately NOT checked: continuing a run
                  # with a longer horizon is the resume workflow, and it
                  # re-stretches the cosine tail by documented design
                  ("lr", args.lr), ("weight_decay", args.weight_decay),
                  ("warmup_steps", args.warmup_steps)]
        if pipelined:
            checks.append(("pp_stages", n_stages))
            checks.append(("pp_interleave", args.pp_interleave))
            # tp resizing is layout-safe (the checkpoint holds one
            # process's whole tree; each rank cuts its shards) but
            # unstamped provenance is not — default 1 for pre-tp ones
            if int(blob.get("pp_tp_size", 1)) != args.pp_tp_size:
                logging.info("resuming a pp checkpoint trained at "
                             "pp_tp_size=%d with --pp-tp-size %d (layout "
                             "identical; re-sharding onto the new mesh)",
                             int(blob.get("pp_tp_size", 1)),
                             args.pp_tp_size)
        for key, now in checks:
            if key not in blob:
                # a missing stamp means unknown provenance — exactly when
                # the guard matters most (consistent with the wd_mask
                # refusal below)
                raise ValueError(
                    f"the checkpoint carries no {key!r} stamp, so the "
                    f"resume guard cannot verify it matches {key}={now}; "
                    "restart training or re-stamp the checkpoint if its "
                    "recipe is known")
            was = type(now)(blob[key])
            if was != now:
                raise ValueError(
                    f"--resume with {key}={now} but the checkpoint was "
                    f"trained with {key}={was}: the run would silently "
                    "diverge (batch schedule, trunk-block layout, or "
                    "optimizer trajectory)")
        was_par = str(blob.get("parallel", "dp"))
        if was_par != args.parallel:
            raise ValueError(
                f"--resume with --parallel {args.parallel} but the "
                f"checkpoint was trained with {was_par}: the param trees "
                "are laid out differently (PP stacks the trunk blocks)")
        was_mask = str(blob.get("wd_mask", "unstamped"))
        if was_mask != "name":
            raise ValueError(
                f"the checkpoint's weight-decay-mask recipe is "
                f"{was_mask!r} (current: 'name', train.decay_mask); an "
                "unstamped checkpoint may predate the name-based mask, and "
                "resuming across a mask change silently alters which "
                "params decay — restart training or re-stamp the "
                "checkpoint if its recipe is known")
        saved = blob["train"]
        if pipelined:
            saved = ppar.local_train_state(saved, model, tp_group)
        state = load_train_state(model, saved)
        # the cursor is DERIVED from the checkpointed step — one atomic
        # artifact, nothing to desynchronize on a crash mid-save
        start_step = int(state.step)
        loader.load_state_dict({
            "epoch": start_step // loader.steps_per_epoch,
            "step": start_step % loader.steps_per_epoch,
            "seed": args.seed})
        logging.info("resumed at train step %d (loader %s)", start_step,
                     loader.state_dict())

    if world.group is not None:
        # ranks must agree on the resume point: a disagreement (an --out
        # that not every rank sees) would run mismatched step ranges whose
        # collectives deadlock; fail loudly instead
        steps = collectives.all_gather_rows(
            torch.tensor([start_step], device=device), world.group)
        if int(steps.min()) != int(steps.max()):
            raise ValueError(
                f"ranks disagree on the resume step ({steps.tolist()}): "
                "--out must be a SHARED filesystem so every process sees "
                "the rank-0 checkpoint")
    if pipelined:
        step_fn = pp_step
    elif args.parallel == "sp":
        step_fn = sp_step
    elif world.group is not None:
        step_fn = make_dp_train_step(model, tx_opt, world)
    else:
        def step_fn(state, pc, text_embed, image_embed, mask):
            return train_step(model, tx_opt, state, pc, text_embed,
                              image_embed, mask)

    snapshotter = checkpoint.AsyncSnapshotter() if args.ckpt_async else None
    last_saved_step = [start_step - 1]

    def save(at_step: int):
        if at_step == last_saved_step[0]:
            return   # final save already landed on a --ckpt-every boundary
        last_saved_step[0] = at_step
        train_state = state
        if pipelined:
            # one process's whole tree on rank 0 (every rank takes part)
            train_state = ppar.gather_train_state(state, model, tp_group)
        if not primary:
            return   # replicated state: one writer (shared-filesystem safe)
        blob = {"train": train_state, "data_seed": args.seed,
                "global_batch": args.batch_size, "parallel": args.parallel,
                "depth": args.depth, "wd_mask": "name",
                "corpus_size": len(corpus),
                "lr": args.lr, "weight_decay": args.weight_decay,
                "warmup_steps": args.warmup_steps}
        if pipelined:
            blob["pp_stages"] = n_stages
            blob["pp_interleave"] = args.pp_interleave
            blob["pp_tp_size"] = args.pp_tp_size
        if snapshotter is not None:
            # at most one in-flight snapshot: wait for the previous first
            # so writes land in order and a slow disk backpressures
            # cleanly; a failed write raises here or at the final wait
            snapshotter.wait()
            snapshotter.save(ckpt_path, blob)
        else:
            checkpoint.save_state(ckpt_path, blob)

    t0 = time.perf_counter()
    try:
        for step in range(start_step, args.steps):
            batch = global_batch(next(loader), device)
            state, metrics = step_fn(state, batch["pc"], batch["text_embed"],
                                     batch["image_embed"], batch["mask"])
            if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                logging.info("step %d/%d  loss %.4f  scale %.2f  "
                             "%.1f samples/s", step + 1, args.steps, loss,
                             float(torch.exp(state.logit_scale)),
                             args.batch_size * (step + 1 - start_step) / dt)
            if (step + 1) % args.ckpt_every == 0:
                save(step + 1)
        save(args.steps)
    finally:
        if snapshotter is not None:
            snapshotter.close()  # drain the in-flight write, surface failure
        loader.close()
    if world.group is not None:
        # the ranks leave together, once rank 0's checkpoint is on disk: a
        # `--resume` launched next finds it on every rank
        torch.distributed.barrier(world.group)
    logging.info("done: %d steps, checkpoint at %s.npz", args.steps,
                 ckpt_path)
    return state


def cli() -> int:
    """Console-script entry: exit 0 on success — main()'s return value is
    in-process API, not an exit code."""
    main()
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
