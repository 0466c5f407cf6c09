"""Distributed evaluation over a `torch.distributed` world (mirror of
`uni_adapter_tpu/parallel/mesh.py`).

The JAX package runs one program over a mesh of devices; here the "mesh"
is the process group, one process a rank, each on its own device or
sharing one (`parallel/bootstrap.py`).  The two documented semantics of
the order-dependent online state are the JAX package's:

  * 'sharded': the stream is split into contiguous shards, one a rank;
    each rank runs its own adaptation trajectory over its shard (seed
    `seed + rank`), and the accuracy counts are all-reduced at the end;
  * 'psum': the state is replicated and every step consumes one batch a
    rank; the fits' sufficient statistics are all-reduced
    (`engine.make_step_fn(axis_name=group)`), so every rank applies the
    exact global streaming update, n_ranks·B samples a step.

Each rank runs its part through the stream's scan (`engine.run_stream_scan`
or `run_streams_scan`): on the card its step is captured as CUDA graphs
and replayed; under 'psum' the step is captured in segments with the
all-reduces issued between their replays.  Without an initialised process
group the world is this one process.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from uni_adapter_torch import engine
from uni_adapter_torch.config import Config
from uni_adapter_torch.parallel import collectives


class World(NamedTuple):
    """The processes a run spreads over: this one's rank, their number,
    and their process group (None for a world of one without one)."""
    rank: int
    size: int
    group: Optional[object]


def make_mesh(group=None) -> World:
    """The world of `group` (the default process group if one is
    initialised, else this process alone)."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return World(0, 1, None)
    return World(dist.get_rank(group), dist.get_world_size(group), group)


class Grid(NamedTuple):
    """A 2-D grid of a world's ranks, rows × cols, rank = i·cols + j:
    this rank's row i and column j, the group of its row (the cols ranks
    of row i; None where a row is one rank) and of its column (the rows
    ranks of column j; None where a column is one rank)."""
    rows: int
    cols: int
    row: int
    col: int
    row_group: Optional[object]
    col_group: Optional[object]


def make_grid(rows: int, world: Optional[World] = None) -> Grid:
    """The grid of `world` (default: the process group) with `rows` rows.
    A grid of one row (or one column) takes the world's group for its
    rows (or its columns); otherwise every rank makes every group, in the
    same order (as `dist.new_group` requires)."""
    world = world or make_mesh()
    if rows < 1 or world.size % rows:
        raise ValueError(f"a world of {world.size} ranks does not divide "
                         f"into {rows} rows")
    cols = world.size // rows
    i, j = divmod(world.rank, cols)
    if rows == 1:
        return Grid(1, cols, 0, j, world.group, None)
    if cols == 1:
        return Grid(rows, 1, i, 0, None, world.group)
    row_groups = [dist.new_group([a * cols + b for b in range(cols)])
                  for a in range(rows)]
    col_groups = [dist.new_group([a * cols + b for a in range(rows)])
                  for b in range(cols)]
    return Grid(rows, cols, i, j, row_groups[i], col_groups[j])


def is_primary() -> bool:
    """The rank-0 gate for logging and writing results."""
    return make_mesh().rank == 0


def shard_stream(pcs: np.ndarray, rgbs: np.ndarray, targets: np.ndarray,
                 n_shards: int):
    """Split a (T, B, ...) stream into (n_shards, T//n_shards, B, ...)
    contiguous per-device shards, truncating the remainder."""
    T = (pcs.shape[0] // n_shards) * n_shards
    if T == 0:
        raise ValueError(
            f"stream of {pcs.shape[0]} steps is shorter than the "
            f"{n_shards}-device mesh — sharding would truncate to zero "
            f"steps (NaN accuracies); run unsharded or shrink the mesh")
    def r(a):
        return np.asarray(a)[:T].reshape(n_shards, T // n_shards,
                                         *a.shape[1:])
    return r(pcs), r(rgbs), r(targets), T


def _all_reduce(t: torch.Tensor, world: World) -> torch.Tensor:
    if world.group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=world.group)
    return t


def _summary(correct: list, n_samples: int) -> dict:
    return {"acc1": 100.0 * correct[0] / n_samples,
            "acc3": 100.0 * correct[1] / n_samples,
            "acc5": 100.0 * correct[2] / n_samples,
            "n_samples": n_samples}


def run_stream_sharded(cfg: Config, model, text_features_initial, pcs, rgbs,
                       targets, mesh: Optional[World] = None, seed: int = 42,
                       scan_fn: Optional[engine.ScanFn] = None):
    """'sharded' mode: this rank's contiguous shard of the (T, B, ...)
    stream through `engine.run_stream_scan` from a fresh state seeded
    `seed + rank`, the (3,) correct counts all-reduced.

    Returns (this rank's final EngineState, summary: acc1/acc3/acc5 over
    the whole truncated stream, n_samples)."""
    world = mesh or make_mesh()
    pcs_s, rgbs_s, targets_s, T = shard_stream(pcs, rgbs, targets, world.size)
    r = world.rank
    state, outs = engine.run_stream_scan(
        cfg, model, text_features_initial, pcs_s[r], rgbs_s[r], targets_s[r],
        seed=seed + r, scan_fn=scan_fn)
    correct = _all_reduce(outs.correct.sum(0), world)
    return state, _summary(correct.tolist(), T * pcs.shape[1])


def run_streams_sharded(cfg: Config, model, text_features_initial, pcs, rgbs,
                        targets, mesh: Optional[World] = None, seed: int = 42,
                        scan_fn: Optional[engine.ScanFn] = None):
    """Independent STREAMS (the 15 corruptions) over the ranks: this rank's
    C/n contiguous streams through `engine.run_streams_scan` (stream i
    seeded seed + i, as in the replicated run), the (C/n, 3) counts
    all-gathered in stream order.

    Args:
      pcs, rgbs: (C, T, B, N, 3); targets: (C, T, B).  C must be a multiple
        of the world's size (pad with repeated streams if needed).
    Returns:
      (this rank's streams' final EngineState, summary with a per-stream
       acc1 list over all C streams).
    """
    world = mesh or make_mesh()
    n = world.size
    C, T, B = pcs.shape[0], pcs.shape[1], pcs.shape[2]
    if C % n:
        raise ValueError(f"stream count {C} must divide over {n} devices")
    per = C // n
    lo = world.rank * per
    state, outs = engine.run_streams_scan(
        cfg, model, text_features_initial, pcs[lo:lo + per],
        rgbs[lo:lo + per], targets[lo:lo + per], seed=seed + lo,
        scan_fn=scan_fn)
    correct = outs.correct.sum(0)                           # (C/n, 3)
    if world.group is not None:
        correct = collectives.all_gather_rows(correct, world.group)
    correct = correct.cpu().numpy()                         # (C, 3)
    n_samples = T * B
    summary = {
        "acc1_per_stream": (100.0 * correct[:, 0] / n_samples).tolist(),
        "acc1": float(100.0 * correct[:, 0].sum() / (C * n_samples)),
        "acc3": float(100.0 * correct[:, 1].sum() / (C * n_samples)),
        "acc5": float(100.0 * correct[:, 2].sum() / (C * n_samples)),
        "n_samples": C * n_samples,
    }
    return state, summary


def _regroup_for_rank(a, n: int, rank: int):
    """Rank `rank`'s part of a (T, B, ...) stream read as (T//n, n·B, ...):
    step t's samples t·n·B + rank·B … + B − 1, i.e. the B samples of
    original step t·n + rank."""
    a = np.asarray(a)
    T, B = (a.shape[0] // n) * n, a.shape[1]
    g = a[:T].reshape(T // n, n * B, *a.shape[2:])
    return np.ascontiguousarray(g[:, rank * B:(rank + 1) * B])


def run_stream_psum(cfg: Config, model, text_features_initial, pcs, rgbs,
                    targets, mesh: Optional[World] = None, seed: int = 42,
                    scan_fn: Optional[engine.ScanFn] = None):
    """'psum' mode: replicated state, n_ranks batches a step, the exact
    global streaming update through the all-reduced sufficient statistics.

    The (T, B, ...) stream is read as (T//n, n·B, ...): step t consumes
    samples t·n … t·n+n−1, one batch a rank.  The state starts from
    `seed` on every rank; each rank's noise generator is then seeded
    `seed + rank` (the JAX step folds the device index into its noise
    key).  `scan_fn`, if given, is `engine.make_scan_fn(cfg, model,
    axis_name=group)`.

    Returns (the final EngineState, the same on every rank, summary)."""
    if engine.uses_cache(cfg):
        raise ValueError(
            "psum mode requires an adaptation method with additive "
            "sufficient statistics (DOTA family); the prototype cache's "
            "insert-or-merge update is order-dependent and cannot be "
            "psum-merged — use dist_mode='sharded' instead")
    world = mesh or make_mesh()
    n = world.size
    T = (pcs.shape[0] // n) * n
    if T == 0:
        raise ValueError(
            f"stream of {pcs.shape[0]} steps is shorter than the "
            f"{n}-device mesh — psum regrouping would truncate to zero "
            f"steps (NaN accuracies); run unsharded or shrink the mesh")
    B = pcs.shape[1]
    local = [_regroup_for_rank(a, n, world.rank)
             for a in (pcs, rgbs, targets)]
    scan_fn = (scan_fn if scan_fn is not None else
               engine.make_scan_fn(cfg, model, axis_name=world.group))
    state = engine.init_state(cfg, text_features_initial, seed)
    state.generator.manual_seed(seed + world.rank)
    state, outs = engine.run_stream_scan(cfg, model, text_features_initial,
                                         *local, initial_state=state,
                                         scan_fn=scan_fn)
    correct = _all_reduce(outs.correct.sum(0), world)
    return state, _summary(correct.tolist(), T * B)
