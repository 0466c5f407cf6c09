"""The collectives of the data-parallel paths over a `torch.distributed`
process group: what the JAX package's `jax.lax.psum`, `all_gather` and
`pmean` are inside its `shard_map` programs.

A group is any process group (the default one after
`init_process_group`); a world of one process runs each collective all
the same (NCCL's or gloo's copy), but for the loss's gathers, which are
the identity there (`gather_rows`, `sum_across`).

  * `psum_` sums a tuple of tensors, packed into one flat fp32 buffer
    (`pack`, `unpack`), over the group in one all-reduce in place, as a
    data-parallel step merges its fits' sufficient statistics
    (`engine._fit`) and the train step averages its gradients (`pmean`);
  * `gather_rows` and `sum_across` carry their gradient, as JAX's AD
    transposes its collectives: the gathered rows' gradient is summed
    over the ranks and each rank keeps its own rows (all_gather's
    transpose, psum_scatter), a sum's gradient is summed over the ranks
    (psum's transpose under `check_vma=False`).

Gloo takes CUDA tensors too (it copies them through the host), which is
how ranks that share one card run; NCCL needs a card a rank.
"""
from __future__ import annotations

from typing import Optional, Sequence

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


def psum_(flat: torch.Tensor, group) -> torch.Tensor:
    """Sum `flat` over the group, in place (one all-reduce)."""
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return flat


def pmean(tensors: Sequence[torch.Tensor], group) -> tuple:
    """The tensors averaged over the group: their sum divided by the
    group's size, in fp32 (JAX's pmean)."""
    flat = psum_(pack(tensors), group)
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
