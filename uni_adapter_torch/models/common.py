"""Transformer building blocks (mirror of `uni_adapter_tpu/models/
common.py`): the EVA02 trunk of Uni3D, and the fused-qkv ViT blocks of
ULIP-2's Point-BERT, OpenShape's PPTA and the CLIP text tower.

Numerics follow the flax modules: dense layers run in the compute dtype
and round before their bias; LayerNorm and BatchNorm keep fp32 parameters
and fp32 arithmetic and round their output to the compute dtype.  Module
and parameter names follow the flax tree (`q_proj`, `k_norm`, `fc1_g`,
...) so `weights.from_jax_params` is a flatten plus a transpose.

Tensor parallelism (`parallel/tp.py`): `EvaAttention`, `SwiGLU`,
`ViTAttention` and `Mlp` hold a rank's shards once `tp_group` is set
(their heads, their hidden columns, the rows of the consumer layers that
read them), and the blocks' `parts(x)` are generators that yield each
sum over the group as a `collectives.Collective` where one is due: the
attention's partial out projection, the SwiGLU hidden LayerNorm's row
statistics and `fc2`'s partial product (`Dense.row_parts`).  A block
without a group yields nothing and computes `forward`.  Under autograd
(pipeline-parallel training of a tensor-parallel stage, `parallel/pp.py`)
a shard's replicated input has its gradient summed over the group
(`collectives.sum_grads_across`, Megatron's f), the row-parallel sums
pass their gradient as it is, and the LayerNorm's row statistics have
theirs summed (`sum_grads`).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from uni_adapter_torch.ops.attention import eva_attn_block
from uni_adapter_torch.ops.attention_heads import attention_heads
from uni_adapter_torch.ops.eva_attention import eva_attention_fused
from uni_adapter_torch.parallel.collectives import (Collective,
                                                    sum_grads_across)

#: flax's lecun_normal: a normal truncated at ±2σ, rescaled to unit variance.
_TRUNC_STD = 0.87962566103423978
#: EVA02's SwiGLU hidden width over the model width (1024 → 2730).
MLP_RATIO = 4 * 2 / 3


class Dense(nn.Module):
    """flax `nn.Dense` in PyTorch's layout: weight (out, in), optional bias.

    The product rounds to the compute dtype before the bias is added, as
    flax does (F.linear with a bias would fuse the add before rounding).
    """

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        std = 1.0 / math.sqrt(self.weight.shape[1]) / _TRUNC_STD
        nn.init.trunc_normal_(self.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight)
        return y if self.bias is None else y + self.bias

    def row_parts(self, x: torch.Tensor, group):
        """Parts: this layer on a row shard (its input features split over
        `group`, `x` holding this rank's): the fp32 partial sums of x·Wᵀ
        summed over the group, then rounded to x's dtype and biased, one
        process's rounding points up to the summation order."""
        part = partial_product(x, self.weight)
        yield Collective("sum", part, group=group)
        y = part.to(x.dtype)
        return y if self.bias is None else y + self.bias


def partial_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x·wᵀ summed in fp32 and not rounded: bf16 operands on the card in
    one tensor-core product with fp32 out, otherwise on fp32 copies (a
    bf16 product is exact in fp32)."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        lead = x.shape[:-1]
        return torch.mm(x.reshape(-1, x.shape[-1]), w.T,
                        out_dtype=torch.float32).reshape(*lead, -1)
    return F.linear(x.to(torch.float32), w.to(torch.float32))


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq @ wqᵀ for int8 xq (M, K) and wq (N, K), summed exactly in int32
    (|Σ| ≤ 127²·K fits for K < 133,000): on the card `int_mm_padded`, on
    the CPU an int32 product."""
    if xq.is_cuda:
        return int_mm_padded(xq, wq)
    return torch.matmul(xq.to(torch.int32), wq.to(torch.int32).T)


def int_mm_padded(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq @ wqᵀ through one `torch._int_mm` (on the card cuBLASLt's int8
    GEMM), which takes M > 16 and K, N multiples of 8: K is zero-padded
    (exact), M and N are padded and the extra rows and columns dropped."""
    (m, k), n = xq.shape, wq.shape[0]
    pm, pk, pn = max(m, 17) - m, -k % 8, -n % 8
    if pk or pm:
        xq = F.pad(xq, (0, pk, 0, pm))
    if pk or pn:
        wq = F.pad(wq, (0, pk, 0, pn))
    return torch._int_mm(xq, wq.T)[:m, :n]


def quantize_rows(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric abs-max int8 quantisation of each row of an fp32 (R, C):
    scale max|row| / 127 + 1e-12, values rounded half to even and clipped
    to ±127.  Returns (int8 (R, C), fp32 scales (R, 1)).  The divisions
    are by tensors: PyTorch's CUDA division by a Python number multiplies
    by its reciprocal, which can move a scale by an ulp and a quantised
    value across a rounding boundary."""
    return quantize_with(t, t.abs().amax(dim=1, keepdim=True))


def quantize_with(t: torch.Tensor, amax: torch.Tensor):
    """`quantize_rows` with the rows' abs-max given (R, 1): a row shard's
    quantisation by its whole rows' maxima."""
    scale = amax / torch.full_like(amax, 127.0) + 1e-12
    return torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8), scale


class LN(nn.Module):
    """LayerNorm with eps 1e-5, fp32 parameters and statistics; the output
    takes the input's dtype (the residual stream's compute dtype)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.to(torch.float32), (x.shape[-1],), self.weight,
                         self.bias, eps=1e-5)
        return y.to(x.dtype)

    def sharded_parts(self, x: torch.Tensor, width: int, group):
        """Parts: this LayerNorm over features split over `group` (x and
        the parameters hold this rank's of `width`): each row's (Σx, Σx²)
        in fp32 summed over the group in one request, then
        var = Σx²/width − mean²."""
        xf = x.to(torch.float32)
        stats = torch.stack([xf.sum(dim=-1), (xf * xf).sum(dim=-1)], dim=-1)
        yield Collective("sum", stats, group=group, sum_grads=True)
        mean = stats[..., :1] / width
        var = (stats[..., 1:] / width - mean * mean).clamp_min(0.0)
        y = (xf - mean) * torch.rsqrt(var + 1e-5) * self.weight + self.bias
        return y.to(x.dtype)


class QuantDense(Dense):
    """`Dense` with dynamic int8 × int8 arithmetic (the JAX `QuantDense`):
    activations quantised per row (token), the weight per output column,
    both symmetric abs-max in fp32 (`quantize_rows`); the int8 product
    summed in int32 (`int8_matmul`), rescaled in fp32, the bias added in
    fp32 and the result cast to the input's (compute) dtype.  The weight
    is requantised each call and kept in fp32 (`finish_model`), as the
    JAX layer quantises its fp32 parameter.  Parameter names and shapes
    are `Dense`'s, so checkpoints and `weights.from_jax_params` map
    unchanged."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        xq, sx = quantize_rows(x.reshape(-1, x.shape[-1]).to(torch.float32))
        wq, sw = quantize_rows(self.weight.to(torch.float32))
        return self._rescale(int8_matmul(xq, wq), sx, sw, lead, x.dtype)

    def _rescale(self, acc, sx, sw, lead, dtype):
        out = acc.to(torch.float32) * sx * sw.T
        if self.bias is not None:
            out = out + self.bias.to(torch.float32)
        return out.reshape(*lead, -1).to(dtype)

    def row_parts(self, x: torch.Tensor, group):
        """Parts: this layer on a row shard, as JAX's sharded program
        computes it: the activations' row maxima (max over the group) and
        the weight's whole-row maxima (`weight_amax`, kept when the layer
        was sharded) quantise as one process does, and the int32 partial
        products are summed over the group exactly before the rescale."""
        lead = x.shape[:-1]
        xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
        amax = xf.abs().amax(dim=1, keepdim=True)
        yield Collective("max", amax, group=group)
        xq, sx = quantize_with(xf, amax)
        wq, sw = quantize_with(self.weight.to(torch.float32),
                               self.weight_amax)
        acc = int8_matmul(xq, wq).contiguous()
        yield Collective("sum", acc, group=group)
        return self._rescale(acc, sx, sw, lead, x.dtype)


def make_dense(quantize: bool) -> type:
    """The dense layer of an EVA trunk: `QuantDense` or `Dense` (JAX
    `make_dense`)."""
    return QuantDense if quantize else Dense


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """The erf GELU (flax `nn.gelu(approximate=False)`)."""
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU, x·sigmoid(1.702x), in the compute dtype."""
    return x * torch.sigmoid(1.702 * x)


class BatchNormInference(nn.Module):
    """BatchNorm with running statistics, fp32 arithmetic; parameters named
    as the flax module's (mean, var, scale, bias)."""

    def __init__(self, features: int):
        super().__init__()
        self.mean = nn.Parameter(torch.zeros(features))
        self.var = nn.Parameter(torch.ones(features))
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.var + 1e-5) * self.scale
        return (x.to(torch.float32) * inv + (self.bias - self.mean * inv)
                ).to(x.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           scale: float, bias: Optional[torch.Tensor] = None,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention on (B, H, N, hd) tensors, the JAX `_attend(use_pallas=True)`:
    with neither a bias nor a mask, `ops.attention_heads` (the kernel on
    the card, the plain version on the CPU); with a bias (B, 1 or H, N, N)
    or an additive mask (broadcast to (B, H, N, N); the CLIP text tower's
    causal mask), which the JAX function never sends to its kernel, plain
    PyTorch on either device: softmax((q·kᵀ + bias)·scale + mask)·v, the
    logits stored as `attn_probs` stores them."""
    if bias is None and mask is None:
        return attention_heads(q, k, v, scale)
    p = attn_probs(q, k, scale, bias, mask).to(v.dtype)
    if v.dtype == torch.bfloat16:
        return torch.matmul(p, v)
    return torch.matmul(p.to(torch.float32),
                        v.to(torch.float32)).to(v.dtype)


def attn_probs(q: torch.Tensor, k: torch.Tensor, scale: float,
               bias: Optional[torch.Tensor] = None,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The softmax map that `attend` applies, recomputed for extraction (the
    JAX `_attn_probs`): under bf16 the q·kᵀ logits are stored in bf16
    (fp32 accumulation, as XLA's bf16 einsum) before the fp32 softmax; in
    fp32 they stay fp32.  In fp32 then: `+ bias`, `× scale`, `+ mask`, in
    the JAX order (a mask of 0 and -inf added before the scale would give
    the same map only by luck).  Returns (B, H, N, N) fp32.  The unbiased
    maps do not come from the kernel, which keeps fp32 scores."""
    if q.dtype == torch.bfloat16:
        s = torch.matmul(q, k.transpose(-1, -2))
    else:
        s = torch.matmul(q.to(torch.float32),
                         k.to(torch.float32).transpose(-1, -2))
    s = s.to(torch.float32)
    if bias is not None:
        s = s + bias
    s = s * scale
    if mask is not None:
        s = s + mask
    return torch.softmax(s, dim=-1)


class EvaAttention(nn.Module):
    """EVA02 attention: separate q/k/v projections (k without bias),
    per-head q/k LayerNorm, out projection.  Its path is the
    `ops.attention.eva_attn_block` kernel (the plain version on the CPU);
    with `return_attn`, or with `quantize` (int8 `QuantDense`
    projections, which the block kernel does not compute), it takes the
    JAX module's transposed branch instead: the projections applied as
    modules, the LayerNorms on (B, H, N, hd), `attend` (on the card the
    `ops.attention_heads` kernel), then `proj`, and with `return_attn`
    the maps from `attn_probs` on the normalised q, k.  The heads' width
    is the q projection's, which a head shard (`tp_group` set) holds for
    its `num_heads` heads only."""

    def __init__(self, dim: int, num_heads: int, quantize: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.quantize = quantize
        self.tp_group = None
        hd = dim // num_heads
        dense = make_dense(quantize)
        self.q_proj = dense(dim, dim)
        self.k_proj = dense(dim, dim, bias=False)
        self.v_proj = dense(dim, dim)
        self.q_norm = LN(hd)
        self.k_norm = LN(hd)
        self.proj = dense(dim, dim)

    def _block(self, x: torch.Tensor, bo) -> torch.Tensor:
        H = self.num_heads
        hd = self.q_proj.weight.shape[0] // H
        # the head LayerNorms are shared by every head: on a head shard
        # their gradient is this rank's heads' part, summed over the group
        norms = (sum_grads_across(t, self.tp_group) for t in (
            self.q_norm.weight, self.q_norm.bias, self.k_norm.weight,
            self.k_norm.bias))
        return eva_attn_block(
            x, self.q_proj.weight, self.q_proj.bias, self.k_proj.weight,
            self.v_proj.weight, self.v_proj.bias, *norms,
            self.proj.weight, bo, num_heads=H, scale=hd ** -0.5)

    def _heads(self, x: torch.Tensor):
        """The transposed branch up to `proj`: q̂, k̂ (B, H, N, hd) and the
        head concat (B, N, Dh)."""
        B, N, _ = x.shape
        H = self.num_heads
        Dh = self.q_proj.weight.shape[0]
        hd = Dh // H

        def heads(t):                                       # (B, H, N, hd)
            return t.reshape(B, N, H, hd).transpose(1, 2)

        q = self.q_norm(heads(self.q_proj(x)))
        k = self.k_norm(heads(self.k_proj(x)))
        v = heads(self.v_proj(x))
        out = attend(q, k, v, hd ** -0.5)
        return q, k, out.transpose(1, 2).reshape(B, N, Dh)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        if not return_attn and not self.quantize:
            return self._block(x, self.proj.bias)
        q, k, cat = self._heads(x)
        out = self.proj(cat)
        if not return_attn:
            return out
        hd = q.shape[-1]
        return out, attn_probs(q, k, hd ** -0.5)

    def parts(self, x: torch.Tensor):
        """Parts: `forward(x)`; on a head shard the block kernel's head-
        sharded entry (no `bo`: the fp32 partial sum) or, with `quantize`,
        the transposed branch and `proj.row_parts`, the partial sums
        summed over `tp_group`, then rounded and biased."""
        if self.tp_group is None:
            return self(x)
        x = sum_grads_across(x, self.tp_group)
        if self.quantize:
            return (yield from self.proj.row_parts(self._heads(x)[2],
                                                   self.tp_group))
        part = self._block(x, None)
        yield Collective("sum", part, group=self.tp_group)
        return part.to(x.dtype) + self.proj.bias


class SwiGLU(nn.Module):
    """EVA02 SwiGLU MLP with its mid LayerNorm (its dense layers int8
    `QuantDense` with `quantize`).  `hidden_dim` stays the whole width on
    a shard of the hidden columns (`tp_group` set)."""

    def __init__(self, dim: int, hidden_dim: int, quantize: bool = False):
        super().__init__()
        dense = make_dense(quantize)
        self.hidden_dim = hidden_dim
        self.tp_group = None
        self.fc1_g = dense(dim, hidden_dim)
        self.fc1_x = dense(dim, hidden_dim)
        self.norm = LN(hidden_dim)
        self.fc2 = dense(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.fc1_g(x)) * self.fc1_x(x)
        return self.fc2(self.norm(x))

    def parts(self, x: torch.Tensor):
        """Parts: `forward(x)`; on a shard of the hidden columns the
        LayerNorm's row statistics and `fc2`'s partial product summed
        over `tp_group`."""
        if self.tp_group is None:
            return self(x)
        x = sum_grads_across(x, self.tp_group)
        h = F.silu(self.fc1_g(x)) * self.fc1_x(x)
        h = yield from self.norm.sharded_parts(h, self.hidden_dim,
                                               self.tp_group)
        return (yield from self.fc2.row_parts(h, self.tp_group))


class EvaBlock(nn.Module):
    """Pre-norm EVA02 block.  Rope is inactive, as in the reference's
    Uni3D path (the JAX `EvaBlock` omits it for the same reason).
    `quantize`: the int8 trunk (`QuantDense` in the attention and MLP)."""

    def __init__(self, dim: int, num_heads: int,
                 mlp_ratio: float = MLP_RATIO, quantize: bool = False):
        super().__init__()
        self.norm1 = LN(dim)
        self.attn = EvaAttention(dim, num_heads, quantize=quantize)
        self.norm2 = LN(dim)
        self.mlp = SwiGLU(dim, int(dim * mlp_ratio), quantize=quantize)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        a = self.attn(self.norm1(x), return_attn=return_attn)
        attn = None
        if return_attn:
            a, attn = a
        x = x + a
        x = x + self.mlp(self.norm2(x))
        return (x, attn) if return_attn else x

    def parts(self, x: torch.Tensor):
        """Parts: `forward(x)`, with its sums over the group of a
        tensor-parallel shard yielded (three, five with int8 layers)."""
        x = x + (yield from self.attn.parts(self.norm1(x)))
        return x + (yield from self.mlp.parts(self.norm2(x)))


class Mlp(nn.Module):
    """Two-layer MLP: the erf GELU by default (Point-BERT / PPTA
    feed-forward), `act=quick_gelu` in the CLIP text tower."""

    def __init__(self, dim: int, hidden_dim: int,
                 act: Callable[[torch.Tensor], torch.Tensor] = gelu_exact):
        super().__init__()
        self.act = act
        self.tp_group = None
        self.fc1 = Dense(dim, hidden_dim)
        self.fc2 = Dense(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))

    def parts(self, x: torch.Tensor):
        """Parts: `forward(x)`; on a shard of the hidden columns `fc2`'s
        partial product summed over `tp_group`."""
        if self.tp_group is None:
            return self(x)
        x = sum_grads_across(x, self.tp_group)
        return (yield from self.fc2.row_parts(self.act(self.fc1(x)),
                                              self.tp_group))


class ViTAttention(nn.Module):
    """Fused-qkv multi-head attention (Point-BERT / PPTA / CLIP text): a
    `qkv` Dense to 3·inner_dim (biased with `qkv_bias`, as in the text
    tower), `ops.eva_attention.eva_attention_fused` on its three column
    slices (the kernel on the card, the plain version on the CPU), then
    `proj` back to dim.  As in the JAX module, a mask, an attention bias
    (B, 1 or H, N, N), `return_attn` and head dims that are not a multiple
    of 8 take the (B, H, N, hd) transpose of `qkv` through `attend`
    instead, and `return_attn` adds the maps of `attn_probs`.  Its
    `project_out=False` (one head of width dim, which no preset of any
    model builds) is left out.  On a head shard (`tp_group` set) `qkv`
    holds the q, k and v columns of heads `head_offset` ... and `inner`
    is their width."""

    def __init__(self, dim: int, num_heads: int,
                 inner_dim: Optional[int] = None, qkv_bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.inner = inner_dim or dim
        self.tp_group = None
        self.head_offset = 0
        self.qkv = Dense(dim, 3 * self.inner, bias=qkv_bias)
        self.proj = Dense(self.inner, dim)

    def _attention(self, x, mask, attn_bias, return_attn: bool):
        """The heads' concat (B, N, inner) before `proj`, and with
        `return_attn` the maps."""
        qkv = self.qkv(x)                                  # (B, N, 3·inner)
        i, H = self.inner, self.num_heads
        hd = i // H
        if attn_bias is not None and attn_bias.shape[1] > 1:
            attn_bias = attn_bias[:, self.head_offset:self.head_offset + H]
        if (not return_attn and attn_bias is None and mask is None
                and hd % 8 == 0):
            return eva_attention_fused(qkv[..., :i], qkv[..., i:2 * i],
                                       qkv[..., 2 * i:], num_heads=H,
                                       scale=hd ** -0.5), None
        B, N = x.shape[:2]
        q, k, v = qkv.reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        out = attend(q, k, v, hd ** -0.5, attn_bias, mask)  # (B, H, N, hd)
        out = out.transpose(1, 2).reshape(B, N, i)
        if return_attn:
            return out, attn_probs(q, k, hd ** -0.5, attn_bias, mask)
        return out, None

    def forward(self, x: torch.Tensor, mask=None, attn_bias=None,
                return_attn: bool = False):
        out, maps = self._attention(x, mask, attn_bias, return_attn)
        out = self.proj(out)
        return (out, maps) if return_attn else out

    def parts(self, x: torch.Tensor, mask=None, attn_bias=None):
        """Parts: `forward(x, ...)`; on a head shard this rank's heads (a
        per-head `attn_bias` sliced to them), then `proj`'s partial
        product summed over `tp_group`."""
        if self.tp_group is None:
            return self(x, mask, attn_bias)
        x = sum_grads_across(x, self.tp_group)
        out, _ = self._attention(x, mask, attn_bias, False)
        return (yield from self.proj.row_parts(out, self.tp_group))


class ViTBlock(nn.Module):
    """Pre-norm transformer block (Point-BERT), MLP hidden width 4·dim."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.norm1 = LN(dim)
        self.attn = ViTAttention(dim, num_heads)
        self.norm2 = LN(dim)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x: torch.Tensor, return_attn: bool = False):
        a = self.attn(self.norm1(x), return_attn=return_attn)
        attn = None
        if return_attn:
            a, attn = a
        x = x + a
        x = x + self.mlp(self.norm2(x))
        return (x, attn) if return_attn else x

    def parts(self, x: torch.Tensor):
        """Parts: `forward(x)`, with a tensor-parallel shard's two sums
        yielded."""
        x = x + (yield from self.attn.parts(self.norm1(x)))
        return x + (yield from self.mlp.parts(self.norm2(x)))


def finish_model(model: nn.Module, device: torch.device | str,
                 dtype: torch.dtype, seed: int, state_dict: Optional[dict],
                 init_bare: Callable[[torch.Generator], None],
                 keep_fp32: tuple = (), trainable: bool = False) -> nn.Module:
    """The weights of a freshly built backbone, then frozen in eval mode
    (with `trainable`, every parameter requires grad instead: the trainer's
    parameters are the whole flax `params` tree, BatchNorm's mean and var
    included, as optax updates them).

    The weights are `state_dict` (e.g. from `weights.from_jax_params`) or,
    without one, random from `seed`: every Dense kernel lecun-normal as
    flax draws it, in module order, then `init_bare(generator)` for the
    bare parameters; the rest keep the flax defaults.  Dense layers are
    stored in the compute dtype `dtype`, except the modules in `keep_fp32`
    (heads that the JAX package runs in fp32) and `QuantDense` layers
    (which quantise their fp32 weight); LayerNorm and BatchNorm
    parameters stay fp32.
    """
    if state_dict is not None:
        model.load_state_dict(state_dict)
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        for m in model.modules():
            if isinstance(m, Dense):
                m.reset_parameters(gen)
        init_bare(gen)
    for m in model.modules():
        if (isinstance(m, Dense) and not isinstance(m, QuantDense)
                and not any(m is k for k in keep_fp32)):
            m.to(dtype)
    return model.eval().requires_grad_(trainable)
