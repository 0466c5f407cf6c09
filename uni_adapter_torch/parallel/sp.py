"""Sequence parallelism for the encoder trunks over a torch.distributed
process group (mirror of `uni_adapter_tpu/parallel/sp.py`): the trunk's
tokens sharded over the ranks, attention an exact ring.

The JAX module scans the trunk inside `shard_map` with the token axis
over a `seq` mesh axis, the block weights replicated, and rotates each
block's K/V shard around the devices with `lax.ppermute` while every
device folds the arriving key block into a running online softmax.  Here
one process is one shard of the sequence (`seq_group`):

  * pre (the embedding) and post (the head) run on every rank, through
    the models' own `embed` and `head` (`pp._backbone`); the tokens are
    right-padded to a multiple of S (the flagship's 513 → 514 at S = 2,
    516 at S = 4), each rank takes its contiguous shard and the shard's
    validity mask, and the trunk's output is gathered back over the
    group with the padding sliced off before post (ULIP's head
    max-pools over the tokens);
  * `_sp_block` restates `EvaBlock` / `ViTBlock` on a (B, n_loc, D)
    shard from the block's own submodules (`norm1`, the q/k/v or fused
    qkv projections, `q_norm`/`k_norm`, `proj`, `norm2`, `mlp`), so
    `weights.from_jax_params` carries the weights unchanged; ULIP's
    positions are sharded with the tokens and re-added at every block;
  * `ring_attention` folds S key blocks into fp32 (m, l, o), with S − 1
    hops: the last block to arrive folds after the loop.  K ‖ V ‖ the
    keys' mask ride one packed buffer, so a hop is one request.  Padded
    keys score the finite `_NEG`: with -inf a rank whose own shard is all
    padding would compute exp(-inf − -inf) = NaN on its first fold; with
    -1e30 that fold's garbage is wiped exactly by exp(m − m_new) = 0 once
    a real key arrives.  The products are fp32 with TF32 off, so fp32
    features stay within PERF.md §2's 1 − 1e-4.

Every forward is a parts generator: without autograd each hop yields a
'shift' request (`collectives.Collective`) and the gather a 'gather', so
a captured step replays its segments with the collectives between them,
as PP's shifts are.  Under autograd the hops are `collectives.ring_shift`
(its gradient the reverse shift, ppermute's transpose) and the take and
gather of the shards are autograd functions, so the forward yields
nothing and `engine.drive` runs it.  `data_group` composes SP × DP on a
(data, seq) grid (`make_sp_grid`, rank = d·S + s, JAX's mesh
reshape(n_data, n_seq)).  int8 trunks and OpenShape raise the JAX
module's ValueErrors.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

from uni_adapter_torch import engine
from uni_adapter_torch.models.common import EvaAttention
from uni_adapter_torch.parallel import collectives
from uni_adapter_torch.parallel import mesh as pmesh
from uni_adapter_torch.parallel.collectives import Collective
from uni_adapter_torch.parallel.pp import _backbone, _trunk_names
from uni_adapter_torch.parallel.tp import group_rank_size

_NEG = -1e30   # finite -inf stand-in: exp(_NEG - m) == 0, no NaN from inf-inf


@contextlib.contextmanager
def _exact_fp32():
    """fp32 products on the card without TF32 (the JAX fold's
    preferred_element_type=float32 at full precision)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _fold(acc: tuple, qf: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor,
          vmask: torch.Tensor, scale: float) -> tuple:
    """One key block folded into the running softmax (m, l, o), fp32."""
    m, l, o = acc
    with _exact_fp32():
        s = torch.matmul(qf, kb.to(torch.float32).transpose(-1, -2)) * scale
        s = torch.where(vmask > 0.5, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)           # padded keys: exp(≤ _NEG-m) == 0
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        o = o * corr + torch.matmul(p, vb.to(torch.float32))
    return m_new, l, o


def _pack(k: torch.Tensor, v: torch.Tensor, vmask: torch.Tensor):
    """K ‖ V ‖ mask as one flat buffer in K's dtype (the mask's 0 and 1
    are exact in bf16)."""
    return torch.cat([k.reshape(-1), v.reshape(-1), vmask.to(k.dtype)])


def _unpack(buf: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    nk, nv = k.numel(), v.numel()
    return (buf[:nk].view(k.shape), buf[nk:nk + nv].view(v.shape),
            buf[nk + nv:])


def request_hop(group):
    """A ring hop as a part: the buffer sent to the next rank of `group`
    and the previous rank's received, through a yielded 'shift' request
    (the receive buffer allocated here, where the next part reads it)."""
    r, n = group_rank_size(group)

    def hop(buf):
        out = torch.empty_like(buf)
        yield Collective("shift", buf, out, group, peers=((r + 1) % n,
                                                          (r - 1) % n))
        return out
    return hop


def autograd_hop(group):
    """A ring hop under autograd: `collectives.ring_shift`, whose gradient
    is the reverse shift; it yields nothing."""
    def hop(buf):
        return collectives.ring_shift(buf, group)
        yield
    return hop


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float, group=None,
                   kv_valid: Optional[torch.Tensor] = None, hop=None):
    """Parts: exact attention over the token shards of `group` (JAX
    `ring_attention`).  q, k, v: (B, H, n_loc, hd), this rank's shard;
    kv_valid: (n_loc,) mask of this shard's keys (1 real, 0 padding),
    None for all real.  Returns (B, H, n_loc, hd) in v.dtype:
    softmax(q·kᵀ·scale)·v over every rank's keys, after S folds and S − 1
    hops; rows whose queries are padding are garbage.  `hop` (default
    `request_hop(group)`, or `autograd_hop(group)` for training) moves
    the packed K ‖ V ‖ mask buffer one rank round the ring; a group of
    one (or None) neither yields nor shifts."""
    _, S = group_rank_size(group)
    hop = hop or request_hop(group)
    B, H, n_loc, hd = q.shape
    qf = q.to(torch.float32)
    valid = (torch.ones(n_loc, device=q.device) if kv_valid is None
             else kv_valid.to(torch.float32))
    acc = (torch.full((B, H, n_loc, 1), _NEG, device=q.device),
           q.new_zeros((B, H, n_loc, 1), dtype=torch.float32),
           q.new_zeros((B, H, n_loc, hd), dtype=torch.float32))
    kb, vb, vmask = k, v, valid
    if S > 1:
        buf = _pack(k, v, valid)
    for _ in range(S - 1):
        acc = _fold(acc, qf, kb, vb, vmask, scale)
        buf = yield from hop(buf)
        kb, vb, vmask = _unpack(buf, k, v)
    _, l, o = _fold(acc, qf, kb, vb, vmask, scale)
    return (o / torch.clamp_min(l, 1e-30)).to(v.dtype)


def _qkv(attn: nn.Module, h: torch.Tensor) -> tuple:
    """q, k, v (B, H, n, hd) of an `EvaAttention` (separate projections,
    the per-head q/k LayerNorms) or a `ViTAttention` (fused qkv) on h."""
    B, n, _ = h.shape
    H = attn.num_heads
    if isinstance(attn, EvaAttention):
        def heads(t):
            return t.reshape(B, n, H, -1).transpose(1, 2)
        return (attn.q_norm(heads(attn.q_proj(h))),
                attn.k_norm(heads(attn.k_proj(h))), heads(attn.v_proj(h)))
    q, k, v = attn.qkv(h).reshape(B, n, 3, H, -1).permute(2, 0, 3, 1, 4)
    return q, k, v


def _sp_block(blk: nn.Module, x: torch.Tensor, valid: torch.Tensor, group,
              hop):
    """Parts: an `EvaBlock` or `ViTBlock` on a (B, n_loc, D) token shard
    from its own submodules, ring attention in place of the dense
    softmax (JAX `_sp_eva_block`, `_sp_vit_block`)."""
    q, k, v = _qkv(blk.attn, blk.norm1(x))
    out = yield from ring_attention(q, k, v, q.shape[-1] ** -0.5, group,
                                    valid, hop)
    B, n, _ = x.shape
    x = x + blk.attn.proj(out.transpose(1, 2).reshape(B, n, -1))
    return x + blk.mlp(blk.norm2(x))


# ---------------------------------------------------------------------------
# the shards: a rank's block of a replicated tensor, and the blocks gathered
# ---------------------------------------------------------------------------

def _gathered(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's `t`s concatenated along `dim` in rank order."""
    out = collectives.all_gather_rows(t.movedim(dim, 0), group)
    return out.movedim(0, dim)


def _block_size(t: torch.Tensor, group, dim: int, what: str) -> tuple:
    r, n = group_rank_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"a {what} of {t.shape[dim]} does not divide over "
                         f"the {n}-rank {'data' if dim == 0 else 'seq'} "
                         "axis")
    return r, t.shape[dim] // n


class _Take(torch.autograd.Function):
    """This rank's block of a replicated tensor along `dim`; the gradient
    is the cotangent's blocks gathered from every rank, so the replicated
    pre gets the whole gradient on each."""

    @staticmethod
    def forward(ctx, t, group, dim, what):
        r, b = _block_size(t, group, dim, what)
        ctx.group, ctx.dim = group, dim
        return t.narrow(dim, r * b, b).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gathered(grad.contiguous(), ctx.group, ctx.dim), None, None, \
            None


class _Gather(torch.autograd.Function):
    """The ranks' blocks gathered along `dim`; every rank computes the same
    loss on the whole, so the gradient is this rank's block of the
    cotangent (not summed)."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.r, ctx.b, ctx.dim = dist.get_rank(group), t.shape[dim], dim
        return _gathered(t, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.r * ctx.b, ctx.b), None, None


def _take(t: torch.Tensor, group, dim: int, what: str):
    if group is None or dist.get_world_size(group) == 1:
        return t
    return _Take.apply(t, group, dim, what)


def _gather(t: torch.Tensor, group, dim: int, grad: bool):
    """Parts: the group's blocks of `t` along `dim`, in rank order: a
    yielded 'gather' request, or under autograd `_Gather`."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    if grad:
        return _Gather.apply(t, group, dim)
    req = collectives.gather_request(t.movedim(dim, 0),
                                     dist.get_world_size(group))
    yield req._replace(group=group)
    return req.out.movedim(0, dim)


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

class SPGrid(NamedTuple):
    """A (data, seq) grid of a world's ranks, rank = d·n_seq + s: this
    rank's seq group (the n_seq ranks of its data row) and data group
    (the n_data ranks of its seq column), None where one rank."""
    n_seq: int
    n_data: int
    seq_rank: int
    data_rank: int
    seq_group: Optional[object]
    data_group: Optional[object]


def make_sp_grid(n_seq: int, n_data: int = 1,
                 world: Optional[pmesh.World] = None) -> SPGrid:
    """The (data, seq) grid of `world` (default: the process group), whose
    size must be n_seq·n_data.  Every rank makes every group."""
    world = world or pmesh.make_mesh()
    if n_seq * n_data != world.size:
        raise ValueError(f"a ({n_data}, {n_seq}) grid of data and seq ranks "
                         f"needs {n_seq * n_data} processes, the world has "
                         f"{world.size}")
    g = pmesh.make_grid(n_data, world)
    return SPGrid(n_seq, n_data, g.col, g.row,
                  g.row_group if n_seq > 1 else None,
                  g.col_group if n_data > 1 else None)


def _covers(kind: str) -> ValueError:
    return ValueError(f"sequence parallelism covers kind='uni3d'|'ulip' "
                      f"(got {kind!r})")


def make_sp_forward(model: nn.Module, seq_group=None, data_group=None):
    """forward(*inputs) for a sequence-parallel Uni3D or ULIP-2 (JAX
    `make_sp_forward_uni3d`, `_ulip`): a parts generator of the model's
    inputs ((B, N, 6) for Uni3D, (B, N, 3) for ULIP) returning its
    (B, D) fp32 features on every rank, equal to the model's forward:
    pre on every rank, the trunk on this rank's token shard over
    `seq_group` (its hops and the final gather yielded), post on every
    rank.  Under autograd (grad enabled, the parameters requiring it) it
    yields nothing.  `data_group` composes SP × DP (each data rank runs
    its rows; the output is gathered over it too).  An int8 trunk and
    OpenShape raise the JAX module's ValueErrors."""
    from uni_adapter_torch.models.ppta import Projected

    if isinstance(model, Projected):
        raise _covers("openshape")
    if any(getattr(m, "quantize", False) for m in model.modules()):
        raise ValueError("sequence parallelism does not support the int8 "
                         "trunk (see module docstring)")
    bb = _backbone(model)
    blocks = list(bb.owner(model)._modules[bb.attr])
    s, S = group_rank_size(seq_group)

    def forward(*inputs):
        carry, extras = bb.pre(model, *inputs)
        grad = torch.is_grad_enabled() and any(
            p.requires_grad for p in model.parameters())
        hop = autograd_hop(seq_group) if grad else request_hop(seq_group)
        n_tok = carry.shape[1]
        pad = -n_tok % S
        n_loc = (n_tok + pad) // S
        valid = (torch.arange(s * n_loc, (s + 1) * n_loc,
                              device=carry.device) < n_tok).to(torch.float32)
        x, pos = (None if t is None else _take(_take(
            nn.functional.pad(t, (0, 0, 0, pad)), seq_group, 1, "sequence"),
            data_group, 0, "batch") for t in (carry, extras))
        for blk in blocks:
            x = yield from _sp_block(blk, x if pos is None else x + pos,
                                     valid, seq_group, hop)
        x = yield from _gather(x, seq_group, 1, grad)
        x = yield from _gather(x, data_group, 0, grad)
        return bb.post(model, x[:, :n_tok])

    return forward


def make_sp_encode_fn(model: nn.Module, kind: str = "uni3d",
                      seq_group=None):
    """(the module, encode) for a sequence-parallel TTA encoder (JAX
    `make_sp_encode_fn`): `encode` has `engine.encode_with`'s contract as
    a parts generator (`engine.encode_parts`), for `encode_fn=` of the
    steps and of `serve.TTAServer`.  The module is `model` itself: every
    rank holds the whole trunk.  kind 'uni3d' or 'ulip'; OpenShape's
    PPTA raises the JAX module's ValueError (its trunk is the smallest of
    the three and its rel-pe bias couples query and key centroids)."""
    if kind not in ("uni3d", "ulip"):
        raise _covers(kind)
    if _backbone(model).kind != kind:
        raise ValueError(f"a {type(model).__name__} is not kind {kind!r}")
    return model, engine.encode_parts(kind, make_sp_forward(model,
                                                            seq_group))


def make_sp_train_step(model: nn.Module, tx, seq_group=None,
                       data_group=None):
    """train_step(state, pc, text_embed, image_embed, mask=None) -> (state,
    metrics) for sequence-parallel contrastive pretraining of a Uni3D
    (JAX `make_sp_train_step_uni3d`), `state` from
    `train.init_train_state(model, tx)`: every rank takes the whole batch
    and computes the same loss on the gathered features.  Gradients flow
    through the ring (`ring_shift`'s reverse shifts), each rank's share
    of the trunk's parameter gradients from its tokens (and rows), summed
    over the seq (and data) group; the gather hands each rank its own
    block of the cotangent and the take gathers the blocks back, so pre's
    and post's gradients are whole on every rank.  Then the global
    clipping norm and `train.apply_grads`, the same update everywhere."""
    from uni_adapter_torch import train

    forward = make_sp_forward(model, seq_group, data_group)
    decay = train.decay_mask(model) if tx.masked else None
    trunk = sorted(_trunk_names(model))
    groups = [g for g in (seq_group, data_group)
              if g is not None and dist.get_world_size(g) > 1]

    def model_fn(*inputs):
        return engine.drive(forward(*inputs), None)

    def step(state, pc, text_embed, image_embed, mask=None):
        if mask is None:
            mask = torch.ones(text_embed.shape[0], device=text_embed.device)
        grads, metrics = train.loss_grads(model_fn, state, (pc,),
                                          text_embed, image_embed, mask)
        if groups:
            summed = collectives.pack([grads[n] for n in trunk])
            for g in groups:
                dist.all_reduce(summed, group=g)
            grads.update(zip(trunk, collectives.unpack(
                summed, [grads[n] for n in trunk])))
        return train.apply_grads(state, tx, grads, decay), metrics

    return step
