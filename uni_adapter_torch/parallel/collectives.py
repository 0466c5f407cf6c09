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
    (psum's transpose under `check_vma=False`);
  * the pipeline's collectives (`parallel/pp.py`): a 'shift' request
    sends a part's buffer to the next rank of a ring and receives the
    previous rank's (JAX's `ppermute` over `ring_perm`), a 'broadcast'
    request copies the last stage's output to every rank (JAX's `psum`
    of zeros elsewhere); `ring_shift` is the differentiable shift, its
    gradient the reverse shift (ppermute's transpose), and
    `broadcast_from` the differentiable broadcast, whose gradient hands
    the source one copy of the cotangent (every rank computes the same
    loss on the replicated output, so a sum would count it once a rank);
  * under autograd a part's 'sum' is differentiable in place: its
    gradient is the identity where the summed buffer's consumer is
    replicated (a row-parallel product), and is summed over the group
    with `sum_grads` (a sharded consumer: the hidden LayerNorm's row
    statistics); `sum_grads_across` is the identity whose gradient is
    summed (the input of a column-parallel product, Megatron's f).

Gloo takes CUDA tensors for its collectives (it copies them through the
host), which is how ranks that share one card run; its point-to-point
send and receive take host tensors only, so a shift of CUDA tensors over
gloo goes through host copies.  NCCL needs a card a rank.
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
    buffers stay where the next part reads them); 'shift' sends `buf` to
    the group's rank `peers[0]` and receives `out` from rank `peers[1]`
    (either None: no send, no receive); 'broadcast' copies `buf` of the
    group's rank `peers[0]` into every rank's `buf`.  `group`: the
    process group it runs over, where not the step's.  `sum_grads`: under
    autograd a sum's gradient is summed over the group too."""
    kind: str
    buf: Optional[torch.Tensor]
    out: Optional[torch.Tensor] = None
    group: Optional[object] = None
    peers: Optional[tuple] = None
    sum_grads: bool = False


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
        if group is None:
            return
        if req.kind == "sum" and req.buf.requires_grad and \
                torch.is_grad_enabled():
            _SumInPlace.apply(req.buf, group, req.sum_grads)
        else:
            dist.all_reduce(req.buf, op=_REDUCE_OPS[req.kind], group=group)
        return
    if req.kind == "shift":
        shift(req.buf, req.out, group, *req.peers)
        return
    if req.kind == "broadcast":
        if group is not None:
            dist.broadcast(req.buf, src=dist.get_global_rank(
                group, req.peers[0]), group=group)
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


class _SumInPlace(torch.autograd.Function):
    """A part's 'sum' under autograd: `buf` summed over the group in place
    (its history rebased here); the gradient passes as it is, or summed
    over the group with `sum_grads`."""

    @staticmethod
    def forward(ctx, buf, group, sum_grads):
        ctx.group, ctx.sum_grads = group, sum_grads
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        ctx.mark_dirty(buf)
        return buf

    @staticmethod
    def backward(ctx, grad):
        if ctx.sum_grads:
            grad = grad.contiguous().clone()
            dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def sum_grads_across(t: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """`t` itself, its gradient summed over the group (the replicated input
    of a column-parallel product); `t` where nothing tracks its gradient,
    without a group or in a world of one."""
    if group is None or dist.get_world_size(group) == 1 or not (
            t.requires_grad and torch.is_grad_enabled()):
        return t
    return _SumGrads.apply(t, group)


def shift(buf: Optional[torch.Tensor], out: Optional[torch.Tensor], group,
          to: Optional[int], frm: Optional[int]) -> None:
    """Send `buf` to the group's rank `to` and receive `out` from rank
    `frm` (either None: that side is skipped), both posted before either
    is waited on, so a ring of them does not deadlock.  NCCL takes the
    pair as one `batch_isend_irecv`; over gloo a CUDA tensor goes through
    a host copy (gloo's send and receive take host tensors)."""
    nccl = dist.get_backend(group) == "nccl"
    send = None if to is None else buf.contiguous()
    recv = out
    host = not nccl and any(t is not None and t.is_cuda for t in (send, out))
    if host:
        send = None if send is None else send.cpu()
        recv = None if out is None else torch.empty(
            out.shape, dtype=out.dtype, device="cpu")
    peer = lambda r: dist.get_global_rank(group, r)  # noqa: E731
    if nccl:
        ops = ([] if send is None else
               [dist.P2POp(dist.isend, send, peer(to), group)]) + (
            [] if recv is None else
            [dist.P2POp(dist.irecv, recv, peer(frm), group)])
        works = dist.batch_isend_irecv(ops) if ops else []
    else:
        works = ([] if send is None else
                 [dist.isend(send, peer(to), group=group)]) + (
            [] if recv is None else [dist.irecv(recv, peer(frm), group=group)])
    for w in works:
        w.wait()
    if host and out is not None:
        out.copy_(recv)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        r, n = dist.get_rank(group), dist.get_world_size(group)
        out = torch.empty_like(t, memory_format=torch.contiguous_format)
        shift(t, out, group, (r + 1) % n, (r - 1) % n)
        return out

    @staticmethod
    def backward(ctx, grad):
        group = ctx.group
        r, n = dist.get_rank(group), dist.get_world_size(group)
        out = torch.empty_like(grad, memory_format=torch.contiguous_format)
        shift(grad, out, group, (r - 1) % n, (r + 1) % n)
        return out, None


def ring_shift(t: torch.Tensor, group: Optional[object]) -> torch.Tensor:
    """The previous rank's `t` (rank r sends to r+1 mod n and receives from
    r−1: JAX's ppermute over `ring_perm`), differentiable: its gradient
    is the reverse shift.  The identity without a group or in a world of
    one."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    return _RingShift.apply(t, group)


class _BroadcastFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, src, group):
        ctx.mine = dist.get_rank(group) == src
        out = t.contiguous().clone()
        dist.broadcast(out, src=dist.get_global_rank(group, src), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.mine else torch.zeros_like(grad)), None, None


def broadcast_from(t: torch.Tensor, src: int,
                   group: Optional[object]) -> torch.Tensor:
    """The group's rank `src`'s `t` on every rank, differentiable: every
    rank computes the same function of the copy, so the gradient hands
    `src` one copy of the cotangent (its own) and the other ranks none.
    `t` itself without a group or in a world of one."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    return _BroadcastFrom.apply(t, src, group)
