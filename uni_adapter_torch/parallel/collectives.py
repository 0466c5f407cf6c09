"""The collectives of the data-parallel paths over a `torch.distributed`
process group: what the JAX package's `jax.lax.psum`, `all_gather` and
`pmean` are inside its `shard_map` programs.

A group is any process group (the default one after
`init_process_group`); a world of one process runs each collective all
the same (NCCL's or gloo's copy), but for the loss's gathers, which are
the identity there (`gather_rows`, `sum_across`).

  * `Collective` is what a step's parts generator yields between two of
    its parts (`engine.drive`, a captured step's segments): a sum or a
    max in place, or a gather of the ranks' rows into a buffer the part
    allocated; `issue` runs it on the step's group, or on its own
    `group` where it names one (a tensor-parallel trunk's sums over its
    model group inside a step whose own group is the data's or the
    classes').  A sum takes a tuple
    of tensors packed into one flat fp32 buffer (`pack`, `unpack`), one
    all-reduce, as a data-parallel step merges its fits' sufficient
    statistics (`engine._fit`) and the train step averages its gradients
    (`pmean`);
  * `gather_rows` and `sum_across` carry their gradient, as JAX's AD
    transposes its collectives: the gathered rows' gradient is summed
    over the ranks and each rank keeps its own rows (all_gather's
    transpose, psum_scatter), a sum's gradient is summed over the ranks
    (psum's transpose under `check_vma=False`).

Gloo takes CUDA tensors too (it copies them through the host), which is
how ranks that share one card run; NCCL needs a card a rank.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist


def pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors as one flat fp32 buffer, in order."""
    return torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])


def unpack(flat: torch.Tensor, like: Sequence[torch.Tensor]) -> tuple:
    """`pack`'s inverse: views of `flat` of the shapes (and dtypes) of
    `like`."""
    out, i = [], 0
    for t in like:
        n = t.numel()
        out.append(flat[i:i + n].reshape(t.shape).to(t.dtype))
        i += n
    return tuple(out)


class Collective(NamedTuple):
    """A request of a step's parts, issued between two parts: `kind`
    'sum' ('max') sums (maximises) `buf` over the group in place;
    'gather' writes the ranks' `buf`s, concatenated on axis 0 in rank
    order, into `out` (the part allocates both, so that a captured part's
    buffers stay where the next part reads them).  `group`: the process
    group it runs over, where not the step's."""
    kind: str
    buf: torch.Tensor
    out: Optional[torch.Tensor] = None
    group: Optional[object] = None


def gather_request(buf: torch.Tensor, n: int) -> Collective:
    """A gather of `n` ranks' `buf`s on axis 0 (`buf` made contiguous)."""
    buf = buf.contiguous()
    return Collective("gather", buf,
                      buf.new_empty((n * buf.shape[0], *buf.shape[1:])))


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def issue(req: Collective, group) -> None:
    """Run a part's request over its own group, else over `group` (None: a
    world of this process alone, where a sum or a max is the identity and
    a gather a copy)."""
    if req.group is not None:
        group = req.group
    if req.kind in _REDUCE_OPS:
        if group is not None:
            dist.all_reduce(req.buf, op=_REDUCE_OPS[req.kind], group=group)
        return
    if req.kind != "gather":
        raise ValueError(f"unknown collective {req.kind!r}")
    if group is None:
        req.out.copy_(req.buf)
    elif dist.get_backend(group) == "nccl":
        dist.all_gather_into_tensor(req.out, req.buf, group=group)
    else:
        dist.all_gather(list(req.out.chunk(dist.get_world_size(group))),
                        req.buf, group=group)


def pmean(tensors: Sequence[torch.Tensor], group) -> tuple:
    """The tensors averaged over the group: their sum divided by the
    group's size, in fp32 (JAX's pmean)."""
    flat = pack(tensors)
    issue(Collective("sum", flat), group)
    return unpack(flat / dist.get_world_size(group), tensors)


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' (B, ...) tensors concatenated on axis 0 in rank order
    (no gradient)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.rows = group, t.shape[0]
        return all_gather_rows(t, group)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return g[r * ctx.rows:(r + 1) * ctx.rows], None


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def gather_rows(t: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """All ranks' rows of `t` (rank order), differentiable; the identity
    without a group or in a world of one."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    return _GatherRows.apply(t, group)


def sum_across(t: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """`t` summed over the ranks, differentiable; the identity without a
    group or in a world of one."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    return _SumAcross.apply(t, group)
