"""Pipeline parallelism for the encoder trunks over a torch.distributed
process group (mirror of `uni_adapter_tpu/parallel/pp.py`): the GPipe
microbatch schedule, and the interleaved one of `pp_interleave.py`.

The JAX module stacks the L trunk blocks' parameters into (S, L/S, ...)
leaves sharded over a `stage` mesh axis and scans a tick program inside
`shard_map`, rotating one activation buffer a tick with `ppermute` and
broadcasting the last stage's output with a `psum`.  Here one process is
one stage (`Stages`): `shard_model_pp` keeps a copy of the model that
holds only this rank's blocks, under their global names
(`point_encoder.blocks.{i}`, `ppat.layers.{i}`), so `train.decay_mask`
and a checkpoint's keys are one process's; the executor
(`pp_interleave.run_ticks`) is a parts generator that yields a 'shift'
request after each tick where this rank sends or receives, and the
forward yields a 'broadcast' of the last stage's microbatches at the
end (`collectives.Collective`), so a captured step replays its segments
with the collectives between them, as TP's sums are.

  * pre (the embedding: grouping, mini-PointNet, tokens) and post (the
    head) run on every rank, as JAX's replicated pre and post do,
    through the models' own `embed` and `head`;
  * the per-microbatch constants never ride the ring: ULIP's positional
    embedding (re-added at every block) and PPTA's rel-pe centroid
    deltas are taken on each rank by the index of the microbatch it
    computes;
  * `data_group` composes PP × DP (each data rank runs its rows of
    every microbatch; the trunk's output is gathered over it, as JAX's
    out_spec P(None, data)), and `tp_group` PP × TP (`tp.shard_model_tp`
    shards the stage's blocks; their sums over it are yielded too);
  * ranks beyond the S stages of a world (`make_stages`) hold no blocks
    and take the trunk's output from the broadcast: JAX's mesh of the
    first S devices.

Training (`make_pp_train_step`): the forward is one autograd function
over the schedule (`_Pipeline`) whose backward runs the ticks in
reverse, each tick's reverse shift (the shift's transpose: the gradient
of what a rank received goes back to the sender) before its blocks'
vector-Jacobian product, so every rank's sequence of collectives is
static; the broadcast's gradient hands the last stage one copy
(`collectives.broadcast_from`).  Each stage's block gradients and AdamW
moments stay on its rank.  Pre's gradient arises only where the
microbatches are injected (stage 0) and where the extras are read (every
stage): the cotangents of the microbatch store and of the extras are
summed over the stage group, so the replicated pre and post parameters
get the same gradient on every rank and stay replicated; the clipping
norm is the global one, summed over the stages (and the model shards).
"""
from __future__ import annotations

import copy
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

from uni_adapter_torch import engine
from uni_adapter_torch.parallel import collectives
from uni_adapter_torch.parallel import mesh as pmesh
from uni_adapter_torch.parallel.collectives import Collective
from uni_adapter_torch.parallel.pp_interleave import (
    build_interleaved_schedule, gpipe_schedule, interleaved_block_order,
    pipeline_interleaved, rank_plan, run_ticks)


def stage_blocks(depth: int, n_stages: int, stage: int,
                 interleave: int = 1) -> list:
    """The global block indices of stage `stage`'s chunks: GPipe's one
    chunk [s·L/S, (s+1)·L/S) (JAX `stack_trunk_params[s]`), or the
    interleaved V chunks (`interleaved_block_order`).  Raises JAX's
    ValueError when the depth does not divide."""
    if interleave > 1:
        return interleaved_block_order(depth, n_stages, interleave)[stage]
    if depth % n_stages:
        raise ValueError(f"depth {depth} not divisible by {n_stages} stages")
    n = depth // n_stages
    return [list(range(stage * n, (stage + 1) * n))]


class Stages(NamedTuple):
    """This rank's place in a pipeline of `n` stages: its stage `index`
    (None: it holds no blocks), the stage ring's `group` (None for one
    stage), and the group the last stage's output is broadcast over
    (`out_group`, None: no broadcast) from its rank `out_src` there."""
    n: int
    index: Optional[int]
    group: Optional[object]
    out_group: Optional[object]
    out_src: int

    @property
    def ring(self) -> tuple:
        """(group, rank, size) of the stage ring, for `run_ticks`."""
        return self.group, self.index, self.n


def make_stages(n_stages: Optional[int] = None,
                world: Optional[pmesh.World] = None) -> Stages:
    """A pipeline over the first `n_stages` ranks of `world` (default: the
    process group; `n_stages` default: all of them), the last stage's
    output broadcast over the whole world, as JAX takes the first S
    devices for its stage mesh.  Every rank makes the stage group."""
    world = world or pmesh.make_mesh()
    S = world.size if n_stages is None else n_stages
    if not 1 <= S <= world.size:
        raise ValueError(f"--trunk-stages {S} must be in [1, {world.size}]")
    group = None
    if 1 < S < world.size:
        group = dist.new_group(list(range(S)))
    elif S == world.size:
        group = world.group
    index = world.rank if world.rank < S else None
    return Stages(S, index, group if S > 1 else None,
                  world.group if world.size > 1 else None, S - 1)


class PPGrid(NamedTuple):
    """A 3-D grid of a world's ranks, stages × model × data, rank =
    (s·n_model + m)·n_data + d (JAX's mesh reshape(S, tp, dp), data
    last): this rank's pipeline (its stage group: the ranks that share
    its m and d), its model rank m and the groups of its model row and
    data row (None where one rank)."""
    stages: Stages
    model_rank: int
    model_group: Optional[object]
    data_group: Optional[object]


def make_pp_grid(n_stages: int, n_model: int = 1, n_data: int = 1,
                 world: Optional[pmesh.World] = None) -> PPGrid:
    """The (stage, model, data) grid of `world` (default: the process
    group), whose size must be n_stages·n_model·n_data.  Every rank makes
    every group, in the same order (as `dist.new_group` requires)."""
    world = world or pmesh.make_mesh()
    S, M, D = n_stages, n_model, n_data
    if S * M * D != world.size:
        raise ValueError(f"a ({S}, {M}, {D}) grid of stages, model and data "
                         f"ranks needs {S * M * D} processes, the world has "
                         f"{world.size}")
    rank = lambda s, m, d: (s * M + m) * D + d  # noqa: E731
    s, rem = divmod(world.rank, M * D)
    m, d = divmod(rem, D)

    def groups(axis_ranks):
        # one group a line of the axis, made by every rank in one order
        made = {}
        for key, ranks in axis_ranks:
            made[key] = (world.group if len(ranks) == world.size
                         else dist.new_group(ranks)) if len(ranks) > 1 \
                else None
        return made

    stage_groups = groups(((mm, dd), [rank(ss, mm, dd) for ss in range(S)])
                          for mm in range(M) for dd in range(D))
    model_groups = groups(((ss, dd), [rank(ss, mm, dd) for mm in range(M)])
                          for ss in range(S) for dd in range(D))
    data_groups = groups(((ss, mm), [rank(ss, mm, dd) for dd in range(D)])
                         for ss in range(S) for mm in range(M))
    sg = stage_groups[(m, d)]
    return PPGrid(Stages(S, s, sg, sg, S - 1), m, model_groups[(s, d)],
                  data_groups[(s, m)])


# ---------------------------------------------------------------------------
# the backbones: where the trunk is, pre, the block, post
# ---------------------------------------------------------------------------

class _Backbone(NamedTuple):
    kind: str
    owner: Callable          # model -> the module holding the trunk
    attr: str                # its trunk's attribute
    pre: Callable            # (model, *inputs) -> (carry, extras or None)
    apply: Callable          # (block, x, extras) -> parts
    post: Callable           # (model, x) -> (B, D) fp32


def _uni3d_pre(model, pc):
    return model.point_encoder.embed(pc[:, :, :3], pc[:, :, 3:]), None


def _ulip_pre(model, pts):
    return model.point_encoder.embed(pts)      # (x, pos): pos at every block


def _openshape_pre(model, xyz, features):
    return model.ppat.embed(xyz, features)     # (x, rel-pe deltas or None)


def _backbone(model: nn.Module) -> _Backbone:
    from uni_adapter_torch.models.pointbert import ULIP
    from uni_adapter_torch.models.ppta import Projected
    from uni_adapter_torch.models.uni3d import Uni3D

    if isinstance(model, Uni3D):
        return _Backbone(
            "uni3d", lambda m: m.point_encoder, "blocks", _uni3d_pre,
            lambda blk, x, e: blk.parts(x),
            lambda m, x: m.point_encoder.head(x).to(torch.float32))
    if isinstance(model, ULIP):
        return _Backbone(
            "ulip", lambda m: m.point_encoder, "blocks", _ulip_pre,
            lambda blk, x, pos: blk.parts(x + pos),
            lambda m, x: torch.matmul(m.point_encoder.head(x).to(
                torch.float32), m.pc_projection))
    if isinstance(model, Projected):
        if model.cache_type != "global":
            raise ValueError("pipeline forward covers cache_type='global' "
                             "(the TTA path)")
        return _Backbone(
            "openshape", lambda m: m.ppat, "layers", _openshape_pre,
            lambda layer, x, delta: layer.parts(x, delta),
            lambda m, x: m.proj(x[:, 0].to(torch.float32)))
    raise ValueError(f"no pipeline forward for {type(model).__name__}")


class StageBlocks(nn.Module):
    """A stage's trunk blocks under their global indices (its children are
    named `str(i)`, so its parameters keep one process's names);
    `blocks[i]` is global block i, iteration is in index order."""

    def __init__(self, blocks: dict):
        super().__init__()
        for i in sorted(blocks):
            self.add_module(str(i), blocks[i])

    def __getitem__(self, i: int) -> nn.Module:
        return self._modules[str(i)]

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self) -> int:
        return len(self._modules)


def shard_model_pp(model: nn.Module, stages: Stages, interleave: int = 1):
    """This rank's module of `model` in the pipeline `stages`: a copy that
    holds only its stage's blocks (`stage_blocks`), under their global
    names, and everything outside the trunk.  A rank beyond the stages
    holds no block.  One stage returns `model` itself.  Raises JAX's
    ValueError when the depth does not divide."""
    bb = _backbone(model)
    owner = bb.owner(model)
    blocks = owner._modules[bb.attr]
    depth = len(blocks)
    stage_blocks(depth, stages.n, 0, interleave)         # raise before copying
    if stages.n == 1:
        return model
    keep = ([] if stages.index is None else
            [i for c in stage_blocks(depth, stages.n, stages.index,
                                     interleave) for i in c])
    owner._modules[bb.attr] = StageBlocks({})
    try:
        rank_model = copy.deepcopy(model)
    finally:
        owner._modules[bb.attr] = blocks
    bb.owner(rank_model)._modules[bb.attr] = StageBlocks(
        {i: copy.deepcopy(blocks[i]) for i in keep})
    return rank_model


def _split_micro(t: torch.Tensor, n_micro: int) -> torch.Tensor:
    B = t.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible into {n_micro} "
                         f"microbatches")
    return t.reshape(n_micro, B // n_micro, *t.shape[1:])


def _merge_micro(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])


def _pipeline(chunks: list, micro_carry: torch.Tensor, ring: tuple,
              micro_extras: Optional[torch.Tensor] = None,
              record: Optional[dict] = None):
    """Parts: the GPipe executor (JAX `_pipeline`) on this rank of `ring` =
    (group, rank, size): at tick t rank 0 injects microbatch t and rank s
    applies its blocks (`chunks[0]`) to microbatch t − s, M + S − 1 ticks;
    the microbatches' outputs returned on rank S−1 (`run_ticks`)."""
    sched = gpipe_schedule(ring[2], micro_carry.shape[0])
    return (yield from run_ticks(rank_plan(sched, ring[1]), chunks,
                                 micro_carry, micro_extras, ring, record))


# ---------------------------------------------------------------------------
# the data axis (PP × DP): each data rank's rows of every microbatch
# ---------------------------------------------------------------------------

def _data_rows(mc: torch.Tensor, group) -> tuple:
    r, n = dist.get_rank(group), dist.get_world_size(group)
    if mc.shape[1] % n:
        raise ValueError(f"a microbatch of {mc.shape[1]} does not divide "
                         f"over the {n}-rank data axis")
    b = mc.shape[1] // n
    return r, n, b


def _ungather(flat: torch.Tensor, n: int) -> torch.Tensor:
    """(n·M, b, ...) in data-rank order → (M, n·b, ...)."""
    M = flat.shape[0] // n
    t = flat.reshape(n, M, *flat.shape[1:]).transpose(0, 1)
    return t.reshape(M, n * flat.shape[1], *flat.shape[2:])


class _TakeRows(torch.autograd.Function):
    """This data rank's rows of each replicated microbatch; the gradient is
    the rows' cotangents gathered from every data rank (the whole
    store's, so the replicated pre gets the whole gradient everywhere)."""

    @staticmethod
    def forward(ctx, mc, group):
        r, n, b = _data_rows(mc, group)
        ctx.group, ctx.n = group, n
        return mc[:, r * b:(r + 1) * b].contiguous()

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        out = grad.new_empty((ctx.n * grad.shape[0], *grad.shape[1:]))
        collectives.issue(collectives.Collective("gather", grad, out),
                          ctx.group)
        return _ungather(out, ctx.n), None


class _GatherMicro(torch.autograd.Function):
    """The data ranks' rows of each microbatch gathered back into whole
    microbatches; every rank computes the same loss on them, so the
    gradient is this rank's rows of the cotangent (not summed)."""

    @staticmethod
    def forward(ctx, t, group):
        n = dist.get_world_size(group)
        ctx.r, ctx.b = dist.get_rank(group), t.shape[1]
        req = collectives.gather_request(t, n)
        collectives.issue(req, group)
        return _ungather(req.out, n)

    @staticmethod
    def backward(ctx, grad):
        r, b = ctx.r, ctx.b
        return grad[:, r * b:(r + 1) * b].contiguous(), None


# ---------------------------------------------------------------------------
# the differentiable schedule
# ---------------------------------------------------------------------------

class _Run(NamedTuple):
    """A rank's schedule and what its ticks compute."""
    plan: list
    chunks: list             # chunks[v](x, extras) -> parts
    ring: tuple              # (group, rank, size)
    params: list             # this rank's trunk parameters


class _Pipeline(torch.autograd.Function):
    """The schedule as one autograd function of (the microbatch store, the
    extras, this rank's trunk parameters): the last stage's (M, Bm, ...)
    outputs there, zeros elsewhere (JAX's buffer before its psum).  The
    forward records each tick's leaves and output; the backward runs the
    ticks in reverse: the tick's reverse shift (the gradient of what this
    rank received at that tick goes back to the sender, the gradient of
    what it sent comes back from the receiver), then the tick's
    vector-Jacobian product.  The store's and the extras' cotangents are
    summed over the stage group."""

    @staticmethod
    def forward(ctx, run, micro_carry, micro_extras, *params):
        record = {}
        with torch.enable_grad():
            outs = engine.drive(run_ticks(run.plan, run.chunks,
                                          micro_carry, micro_extras,
                                          run.ring, record), None)
        ctx.run, ctx.record = run, record
        ctx.has_extras = micro_extras is not None
        ctx.save_for_backward(micro_carry, *(
            (micro_extras,) if micro_extras is not None else ()))
        return _stacked(outs, micro_carry)

    @staticmethod
    def backward(ctx, g_outs):
        run, record = ctx.run, ctx.record
        saved = ctx.saved_tensors
        g_carry = torch.zeros_like(saved[0])
        g_extras = torch.zeros_like(saved[1]) if ctx.has_extras else None
        g_params = [None] * len(run.params)
        group, rank, size = run.ring
        to, frm = (rank + 1) % size, (rank - 1) % size
        pending = {}
        for t in reversed(range(len(run.plan))):
            tick = run.plan[t]
            g_y = None
            if size == 1:
                if tick.recv >= 0:
                    g_y = pending.pop(tick.recv)
            elif tick.send or tick.recv >= 0:
                back = pending.pop(tick.recv) if tick.recv >= 0 else None
                g_y = (torch.empty_like(record[t][2]) if tick.send
                       else None)
                collectives.shift(back, g_y, group,
                                  frm if back is not None else None,
                                  to if tick.send else None)
            if tick.m < 0:
                continue
            x, e, y = record.pop(t)
            if tick.final:
                g_y = g_outs[tick.m]
            wrt = [x] + ([e] if e is not None else []) + run.params
            grads = torch.autograd.grad(y, wrt, g_y, allow_unused=True)
            if tick.src < 0:
                g_carry[tick.m] += grads[0]
            else:
                pending[tick.src] = grads[0]
            if e is not None:
                g_extras[tick.m] += grads[1]
            for i, g in enumerate(grads[len(wrt) - len(run.params):]):
                if g is not None:
                    g_params[i] = g if g_params[i] is None else g_params[i] + g
        if size > 1:
            pair = [g_carry] + ([g_extras] if g_extras is not None else [])
            flat = collectives.pack(pair)
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            pair = collectives.unpack(flat, pair)
            g_carry = pair[0]
            g_extras = pair[1] if g_extras is not None else None
        return (None, g_carry, g_extras, *g_params)


def _stacked(outs: dict, micro_carry: torch.Tensor) -> torch.Tensor:
    """The microbatches' outputs on the rank that holds them, zeros on the
    others (the broadcast's buffer)."""
    if outs:
        return torch.stack([outs[m] for m in range(micro_carry.shape[0])])
    return torch.zeros_like(micro_carry)


def make_pp_forward(model: nn.Module, stages: Stages,
                    n_micro: Optional[int] = None, data_group=None,
                    tp_group=None, interleave: int = 1):
    """(this rank's module, forward) for a pipeline-parallel backbone (Uni3D,
    ULIP-2, or OpenShape's PPTA with cache_type 'global'; JAX
    `make_pp_forward_uni3d`, `_ulip`, `_openshape`).

    `stages`: this rank's pipeline (`make_stages`, `make_pp_grid`).
    forward(*inputs) is a parts
    generator of the model's inputs ((B, N, 6) for Uni3D, (B, N, 3) for
    ULIP, (xyz, features) for OpenShape) returning its (B, D) fp32
    features on every rank, equal to the model's forward: pre on every
    rank, the trunk over the schedule in `n_micro` microbatches (default:
    one a stage), the shifts and the final broadcast yielded, post on
    every rank.  Under autograd (grad enabled, the parameters requiring
    it) the trunk is the differentiable `_Pipeline` and the forward
    yields nothing.  `interleave=V` runs the interleaved schedule (depth
    divisible by S·V); `data_group` and `tp_group` compose PP × DP and
    PP × TP (heads and hidden widths divisible by the model group).
    """
    bb = _backbone(model)
    S = stages.n
    M = n_micro or S
    depth = len(bb.owner(model)._modules[bb.attr])
    rank_model = shard_model_pp(model, stages, interleave)
    if tp_group is not None:
        from uni_adapter_torch.parallel import tp

        rank_model = tp.shard_model_tp(rank_model, tp_group)
    trunk = bb.owner(rank_model)._modules[bb.attr]
    run = sched = None
    if stages.index is not None:
        sched = (build_interleaved_schedule(S, interleave, M)
                 if interleave > 1 else gpipe_schedule(S, M))

        def chunk_of(blocks):
            def chunk(x, e):
                for blk in blocks:
                    x = yield from bb.apply(blk, x, e)
                return x
            return chunk

        chunks = [chunk_of([trunk[i] for i in c]) for c in
                  stage_blocks(depth, S, stages.index, interleave)]
        run = _Run(rank_plan(sched, stages.index), chunks, stages.ring,
                   list(trunk.parameters()))

    def forward(*inputs):
        carry, extras = bb.pre(rank_model, *inputs)
        mc = _split_micro(carry, M)
        me = None if extras is None else _split_micro(extras, M)
        grad = torch.is_grad_enabled() and any(
            p.requires_grad for p in rank_model.parameters())
        if data_group is not None:
            if grad:
                mc = _TakeRows.apply(mc, data_group)
                me = None if me is None else _TakeRows.apply(me, data_group)
            else:
                r, _, b = _data_rows(mc, data_group)
                mc = mc[:, r * b:(r + 1) * b]
                me = None if me is None else me[:, r * b:(r + 1) * b]
        if grad:
            if run is None:
                raise ValueError("a rank beyond the pipeline's stages does "
                                 "not train")
            outs = _Pipeline.apply(run, mc, me, *run.params)
            outs = collectives.broadcast_from(outs, stages.out_src,
                                              stages.out_group)
            if data_group is not None:
                outs = _GatherMicro.apply(outs, data_group)
        else:
            outs = {}
            if run is not None and interleave > 1:
                outs = yield from pipeline_interleaved(run.chunks, mc, sched,
                                                       run.ring, me)
            elif run is not None:
                outs = yield from _pipeline(run.chunks, mc, run.ring, me)
            outs = _stacked(outs, mc)
            if stages.out_group is not None:
                yield Collective("broadcast", outs, group=stages.out_group,
                                 peers=(stages.out_src,))
            if data_group is not None:
                n = dist.get_world_size(data_group)
                req = collectives.gather_request(outs, n)._replace(
                    group=data_group)
                yield req
                outs = _ungather(req.out, n)
        return bb.post(rank_model, _merge_micro(outs))

    return rank_model, forward


def make_pp_encode_fn(model: nn.Module, stages: Stages, kind: str = "uni3d",
                      n_micro: Optional[int] = None, tp_group=None,
                      interleave: int = 1):
    """(this rank's module, encode) for a pipeline-parallel TTA encoder:
    `encode` has `engine.encode_with`'s contract as a parts generator
    (`engine.encode_parts`), for `encode_fn=` of the steps and of
    `serve.TTAServer`.  n_micro defaults to 1: TTA steps are batch 1 (2
    with the noise-augmented double fit), too small to microbatch, and PP
    here is a capacity feature.  `tp_group` composes PP × TP for Uni3D
    only (JAX's ValueError otherwise)."""
    n_micro = 1 if n_micro is None else n_micro
    if tp_group is not None and kind != "uni3d":
        raise ValueError(f"tp_group is supported for kind='uni3d' only "
                         f"(got kind={kind!r}) — silently stage-only "
                         "sharding would defeat the point of asking for TP")
    if _backbone(model).kind != kind:
        raise ValueError(f"a {type(model).__name__} is not kind {kind!r}")
    rank_model, forward = make_pp_forward(model, stages, n_micro,
                                          tp_group=tp_group,
                                          interleave=interleave)
    return rank_model, engine.encode_parts(kind, forward)


# ---------------------------------------------------------------------------
# pipeline-parallel pretraining
# ---------------------------------------------------------------------------

def _trunk_names(rank_model: nn.Module) -> set:
    bb = _backbone(rank_model)
    owner = bb.owner(rank_model)
    prefix = next(n for n, m in rank_model.named_modules() if m is owner)
    head = f"{prefix}.{bb.attr}." if prefix else f"{bb.attr}."
    return {n for n, _ in rank_model.named_parameters() if n.startswith(head)}


def make_pp_train_step(model: nn.Module, tx, stages: Stages,
                       n_micro: Optional[int] = None, tp_group=None,
                       data_group=None, interleave: int = 1):
    """(this rank's module, train_step) for pipeline-parallel contrastive
    pretraining (JAX `make_pp_train_step_uni3d`, `_ulip`, `_openshape`):
    train_step(state, *model_inputs, text_embed, image_embed, mask=None)
    -> (state, metrics), `state` from `train.init_train_state(rank
    module, tx)`.  Every rank takes the whole batch (JAX's PP batch is
    replicated) and computes the loss on the replicated features; the
    backward runs the schedule in reverse (`_Pipeline`), each stage's
    block gradients on its rank, the replicated parameters' gradients
    equal everywhere; the clipping norm is the global one (the trunk's
    squares summed over the model group where TP shards them, then over
    the stages, and over the data group where it splits the rows); then
    `train.apply_grads` on every rank."""
    from uni_adapter_torch import train
    from uni_adapter_torch.models.ppta import Projected

    rank_model, forward = make_pp_forward(model, stages, n_micro, data_group,
                                          tp_group, interleave)
    n_inputs = 2 if isinstance(rank_model, Projected) else 1
    decay = train.decay_mask(rank_model) if tx.masked else None
    trunk = _trunk_names(rank_model)
    split = set()
    if tp_group is not None:
        from uni_adapter_torch.parallel import tp

        split = {n for n, s in tp.tp_param_specs(rank_model).items()
                 if n in trunk and any(a is not None for a in s)}

    def model_fn(*inputs):
        return engine.drive(forward(*inputs), None)

    # in a fixed order: a set's order changes with the process's hash seed
    split, whole = sorted(split), sorted(trunk - split)

    def global_norm(grads: dict) -> torch.Tensor:
        zero = torch.zeros((), device=grads[train.LOGIT_SCALE].device)
        sq = lambda names: sum((torch.sum(grads[n] * grads[n])  # noqa: E731
                                for n in names), zero)
        parts = torch.stack([sq(split), sq(whole)])
        if tp_group is not None:
            dist.all_reduce(parts[:1], group=tp_group)
        local = parts.sum().reshape(1)
        if stages.group is not None:
            dist.all_reduce(local, group=stages.group)
        return torch.sqrt(local[0] + sq([n for n in grads if n not in trunk]))

    def step(state, *args):
        inputs = args[:n_inputs]
        text_embed, image_embed = args[n_inputs:n_inputs + 2]
        mask = args[n_inputs + 2] if len(args) > n_inputs + 2 else None
        if mask is None:
            mask = torch.ones(text_embed.shape[0], device=text_embed.device)
        grads, metrics = train.loss_grads(model_fn, state, inputs,
                                          text_embed, image_embed, mask)
        if data_group is not None:
            names = sorted(trunk)
            summed = collectives.pack([grads[n] for n in names])
            dist.all_reduce(summed, group=data_group)
            grads.update(zip(names, collectives.unpack(
                summed, [grads[n] for n in names])))
        return train.apply_grads(state, tx, grads, decay,
                                 g_norm=global_norm(grads)), metrics

    return rank_model, step


def _owned(state, rank_model, tp_group) -> dict:
    """{name: (parameter, μ, ν) on the host} of what this rank holds of
    the whole tree: its trunk blocks (a tensor-parallel shard each, or the
    whole block parameter on model rank 0) and, on the world's rank 0,
    everything else (replicated)."""
    from uni_adapter_torch.parallel import tp

    trunk = _trunk_names(rank_model)
    specs = tp.tp_param_specs(rank_model) if tp_group is not None else {}
    mr = dist.get_rank(tp_group) if tp_group is not None else 0
    first = not dist.is_initialized() or dist.get_rank() == 0
    opt = state.opt_state
    out = {}
    for n, p in state.params.items():
        split = n in specs and tp._split_dim(specs[n]) is not None
        if (n in trunk and (split or mr == 0)) or (n not in trunk and first):
            out[n] = (mr, split, *(t.detach().cpu() for t in (
                p, opt.mu[n], opt.nu[n])))
    return out


def gather_train_state(state, rank_model: nn.Module, tp_group=None):
    """The whole `TrainState` of a pipeline (and tensor) parallel run, one
    process's names and shapes, on the world's rank 0 (None on the
    others, which must call it too): each stage's blocks and their AdamW
    moments gathered, tensor-parallel shards reassembled (`tp.unshard`).
    On the host."""
    from uni_adapter_torch import train
    from uni_adapter_torch.parallel import tp

    mine = _owned(state, rank_model, tp_group)
    world = pmesh.make_mesh()
    if world.group is None:
        parts = [mine]
    else:
        parts = [None] * world.size if world.rank == 0 else None
        dist.gather_object(mine, parts, dst=0)
        if world.rank != 0:
            return None
    pieces: dict = {}
    for part in parts:
        for n, (mr, split, *ts) in part.items():
            pieces.setdefault(n, {})[mr] = (split, ts)
    params, mu, nu = {}, {}, {}
    for n in pieces:
        by_rank = pieces[n]
        split = by_rank[min(by_rank)][0]
        if split:
            d = tp._split_dim(tp._spec_for(n.split("."),
                                           by_rank[0][1][0].dim(), "model"))
            whole = [tp.unshard([by_rank[r][1][i] for r in sorted(by_rank)],
                                n, d) for i in range(3)]
        else:
            whole = by_rank[min(by_rank)][1]
        params[n], mu[n], nu[n] = whole
    opt = state.opt_state
    lsn = train.LOGIT_SCALE
    mu[lsn], nu[lsn] = (opt.mu[lsn].detach().cpu(),
                        opt.nu[lsn].detach().cpu())
    return train.TrainState(params, state.logit_scale.detach().cpu(),
                            train.AdamWState(opt.count, mu, nu), state.step)


def local_train_state(saved, rank_model: nn.Module, tp_group=None):
    """A whole restored `TrainState` (`gather_train_state`'s, or one
    process's) cut to this rank's module: its blocks' parameters and
    moments, tensor-parallel shards cut as `tp.shard_model_tp` cuts them;
    then `train.load_train_state(rank_model, ...)` takes it."""
    from uni_adapter_torch import train
    from uni_adapter_torch.parallel import tp

    specs = tp.tp_param_specs(rank_model) if tp_group is not None else {}
    r, n_tp = tp.group_rank_size(tp_group)

    def cut(name, t):
        d = tp._split_dim(specs[name]) if name in specs else None
        return t if d is None else tp._shard(t, name, d, r, n_tp)

    names = [n for n, _ in rank_model.named_parameters()]
    opt = saved.opt_state
    keep = lambda d: {n: cut(n, d[n]) for n in names}  # noqa: E731
    lsn = train.LOGIT_SCALE
    mu, nu = keep(opt.mu), keep(opt.nu)
    mu[lsn], nu[lsn] = opt.mu[lsn], opt.nu[lsn]
    return train.TrainState(keep(saved.params), saved.logit_scale,
                            train.AdamWState(opt.count, mu, nu), saved.step)
