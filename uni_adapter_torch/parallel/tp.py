"""Tensor parallelism for the encoder trunks over a torch.distributed
process group (mirror of `uni_adapter_tpu/parallel/tp.py`).

The Megatron pattern of the JAX module, its `PartitionSpec` rules read
on the port's parameter names (`tp_param_specs`; weights are (out, in),
so JAX's P(None, model) on a kernel is ("model", None) on a weight):

  * column-sharded producers: q/k/v (`q_proj`, `k_proj`, `v_proj`, the
    fused `qkv`), `fc1_g`, `fc1_x` and `fc1`, with their biases: each
    rank holds its heads, its hidden columns;
  * row-sharded consumers: the attention's `proj` and the MLP's `fc2`,
    whose partial products the ranks sum;
  * the SwiGLU hidden LayerNorm (`mlp.norm`) shards with the hidden axis;
  * replicated: the per-head `q_norm`/`k_norm`, the block LayerNorms and
    everything outside the trunk (mini-PointNet, pos-embed, projections).

Where GSPMD's layout and the port's differ, computing the same function:

  * the fused `qkv` of ULIP's and OpenShape's `ViTAttention`: P(None,
    model) splits the concatenated [q|k|v] columns contiguously and
    GSPMD reshards at the head reshape; here each rank holds its own
    heads' columns of q, k and v;
  * a rank holds whole heads: the head count must divide over the group
    (GSPMD would cut inside a head and reshard); OpenShape's `rel_pe`
    bias is (B, 1, N, N), the same for every head, and a per-head
    (B, H, N, N) bias is sliced to the rank's heads;
  * GSPMD inserts the collectives; here the blocks' `parts`
    (`models/common.py`) yield them: three sums a block of the EVA trunk
    (the attention's partial out projection, the hidden LayerNorm's row
    statistics (Σx, Σx²) in fp32, `fc2`'s partial product) and two a
    ViT block (no hidden LayerNorm); int8 `QuantDense` consumers add a
    max of their activations' rows.  A partial product is fp32,
    unrounded (the block kernel's head-sharded entry, `Dense.row_parts`),
    and the sum is rounded and biased once: one process's rounding
    points up to the summation order.

A group of one process (or none) holds the whole model: `shard_model_tp`
returns it unchanged, and its forward issues no collective.  The
adaptation state stays replicated; only the trunk forward is sharded.
`make_tp_forward(..., data_group=...)` composes with a data axis on a
(data, model) grid (`make_tp_grid`), as EP does on a (classes, model)
one (`ep.run_stream_ep(encode_fn=...)`).
"""
from __future__ import annotations

import copy
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

from uni_adapter_torch import engine
from uni_adapter_torch.models.common import (EvaAttention, Mlp, QuantDense,
                                             SwiGLU, ViTAttention)
from uni_adapter_torch.parallel import collectives
from uni_adapter_torch.parallel import mesh as pmesh

#: Column-sharded producers (llama naming too: w1 = gate and w3 = up) and
#: row-sharded consumers, by the parent module's name (JAX `_spec_for`).
_COL = ("q_proj", "k_proj", "v_proj", "qkv", "fc1", "fc1_g", "fc1_x", "w1",
        "w3", "w12", "gate")
_ROW_ATTN = ("proj", "out", "out_proj")
_ROW_MLP = ("fc2", "w2", "down")


def _spec_for(names: list, ndim: int, axis: str) -> tuple:
    """The spec of the parameter at `names` (its dotted name split): one
    entry a dimension, `axis` where that dimension is split; () for a
    replicated one."""
    parent = names[-2] if len(names) >= 2 else ""
    grandparent = names[-3] if len(names) >= 3 else ""
    in_attn = "attn" in names
    in_mlp = "mlp" in names or "ff" in names
    col = parent in _COL
    row = (in_attn and parent in _ROW_ATTN) or (in_mlp and parent in _ROW_MLP)
    if names[-1] == "weight" and ndim == 2 and (in_attn or in_mlp):
        if col:
            return (axis, None)
        if row:
            return (None, axis)
    if names[-1] in ("bias", "weight", "mean", "var", "scale") and ndim == 1 \
            and (in_attn or in_mlp):
        if col:
            return (axis,)
        # the EVA02 SwiGLU hidden LayerNorm follows the sharded hidden axis
        if in_mlp and parent == "norm" and grandparent in ("mlp", "ff"):
            return (axis,)
    return ()


def tp_param_specs(model: nn.Module, axis: str = "model") -> dict:
    """{parameter name: spec} for Megatron-style trunk sharding; a
    parameter that no rule matches is replicated, so the specs cover the
    whole model."""
    return {name: _spec_for(name.split("."), p.dim(), axis)
            for name, p in model.named_parameters()}


def group_rank_size(group) -> tuple:
    """(this process's rank in `group`, its size); (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _split_dim(spec: tuple) -> Optional[int]:
    return next((d for d, a in enumerate(spec) if a is not None), None)


def _blocks(name: str, shape, d: int, n: int) -> tuple:
    """(blocks, block size) of a parameter split along dim d over n ranks:
    a fused qkv is three blocks (q, k, v), each split; raises ValueError
    where a block does not divide."""
    blocks = 3 if name.split(".")[-2] == "qkv" else 1
    size = shape[d] // blocks
    if shape[d] % blocks or size % n:
        raise ValueError(f"{name} of shape {tuple(shape)}: {size} does not "
                         f"divide over {n} ranks")
    return blocks, size


def _shard(t: torch.Tensor, name: str, d: int, r: int, n: int):
    """Rank r's block of `t` along dim d; a fused qkv's rank holds its
    heads' columns of each of q, k and v."""
    blocks, size = _blocks(name, t.shape, d, n)
    c = size // n
    return torch.cat([t.narrow(d, b * size + r * c, c)
                      for b in range(blocks)], dim=d).contiguous()


def unshard(pieces: list, name: str, d: int) -> torch.Tensor:
    """`_shard`'s inverse: the whole parameter `name` from its ranks'
    blocks along dim d, in rank order (a fused qkv's q, k and v each
    reassembled from the ranks' heads)."""
    blocks = 3 if name.split(".")[-2] == "qkv" else 1
    c = pieces[0].shape[d] // blocks
    return torch.cat([p.narrow(d, b * c, c) for b in range(blocks)
                      for p in pieces], dim=d)


def shard_model_tp(model: nn.Module, group, axis: str = "model"):
    """This rank's module of `model` over `group`: a copy that holds only
    its shards of the trunk's parameters (`tp_param_specs`) and whose
    attention and MLP modules sum over `group` (`tp_group`).  A group of
    one (or None) returns `model` itself.  Raises ValueError when the
    head count or a sharded width does not divide over the group."""
    r, n = group_rank_size(group)
    if n == 1:
        return model
    for name, m in model.named_modules():
        if isinstance(m, (EvaAttention, ViTAttention)) and m.num_heads % n:
            raise ValueError(f"{name}: {m.num_heads} heads do not divide "
                             f"over {n} ranks")
    specs = tp_param_specs(model, axis)
    for name, p in model.named_parameters():       # raise before copying
        d = _split_dim(specs[name])
        if d is not None:
            _blocks(name, p.shape, d, n)
    rank_model = copy.deepcopy(model)
    for name, p in list(rank_model.named_parameters()):
        d = _split_dim(specs[name])
        if d is None:
            continue
        owner, _, pname = name.rpartition(".")
        mod = rank_model.get_submodule(owner)
        if isinstance(mod, QuantDense) and pname == "weight" and d == 1:
            # a row shard quantises by its whole rows' maxima
            mod.register_buffer("weight_amax", p.detach().to(
                torch.float32).abs().amax(dim=1, keepdim=True))
        mod._parameters[pname] = nn.Parameter(
            _shard(p.detach(), name, d, r, n), requires_grad=p.requires_grad)
    for prefix, m in rank_model.named_modules():
        if isinstance(m, (EvaAttention, ViTAttention, SwiGLU, Mlp)) and any(
                _split_dim(specs[f"{prefix}.{n}"]) is not None
                for n, _ in m.named_parameters()):
            m.tp_group = group
            if isinstance(m, (EvaAttention, ViTAttention)):
                m.num_heads //= n
            if isinstance(m, ViTAttention):
                m.inner //= n
                m.head_offset = r * m.num_heads
    return rank_model


def make_tp_forward(model: nn.Module, group, data_group=None) -> Callable:
    """forward(*inputs): a parts generator of this rank's module `model`
    (`shard_model_tp(full_model, group)`): its trunk's sums over `group`
    yielded (`engine.drive` issues them; a captured step replays the
    segments between them).  With `data_group` (a (data, model) grid's
    column, `make_tp_grid`) each data rank takes its block of the batch's
    rows and the outputs are gathered back over it, so every rank
    returns the whole batch's output, as JAX's replicated out_sharding.
    """
    del group               # the modules of `model` carry it

    def forward(*inputs):
        dr, dn = group_rank_size(data_group)
        if dn > 1:
            rows = inputs[0].shape[0]
            if rows % dn:
                raise ValueError(f"a batch of {rows} does not divide over "
                                 f"the {dn}-rank data axis")
            b = rows // dn
            inputs = tuple(x[dr * b:(dr + 1) * b] for x in inputs)
        out = yield from model.forward_parts(*inputs)
        if dn > 1:
            req = collectives.gather_request(out, dn)._replace(
                group=data_group)
            yield req
            out = req.out
        return out

    return forward


def make_tp_encode_fn(model: nn.Module, group, kind: str = "uni3d"):
    """(this rank's module, encode) for a tensor-parallel TTA encoder:
    `encode` has `engine.encode_with`'s contract as a parts generator
    (`engine.encode_parts`), for `encode_fn=` of `engine.make_step_fn`,
    `make_scan_fn`, `ep.run_stream_ep` and `serve.TTAServer`.  The JAX
    function returns (prepare, encode) with prepare(params) the sharded
    params; the port's module holds its weights, so it is sharded here
    (`shard_model_tp`) and returned in prepare's place."""
    rank_model = shard_model_tp(model, group)
    return rank_model, engine.encode_parts(kind,
                                           make_tp_forward(rank_model, group))


class TPGrid(NamedTuple):
    """A 2-D grid of ranks, n_outer × n_model, rank = o·n_model + m (the
    JAX mesh's reshape(n // tp, tp), the model axis last): this rank's
    outer index (the data row or the class shard) and model rank, the
    group of its outer column (the ranks that share its model rank) and
    of its model row."""
    n_outer: int
    n_model: int
    outer_index: int
    model_rank: int
    outer_group: Optional[object]
    model_group: Optional[object]

    @property
    def outer_world(self) -> pmesh.World:
        """The outer axis as a world (`ep.run_stream_ep`'s `mesh`)."""
        return pmesh.World(self.outer_index, self.n_outer, self.outer_group)


def make_tp_grid(n_model: int, world: Optional[pmesh.World] = None) -> TPGrid:
    """The (data or classes, model) grid of `world` (default: the process
    group) with model groups of `n_model` ranks."""
    world = world or pmesh.make_mesh()
    if n_model < 1 or world.size % n_model:
        raise ValueError(f"a world of {world.size} ranks does not divide "
                         f"into model groups of {n_model}")
    g = pmesh.make_grid(world.size // n_model, world)
    return TPGrid(g.rows, g.cols, g.row, g.col, g.col_group, g.row_group)
