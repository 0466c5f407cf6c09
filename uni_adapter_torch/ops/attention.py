"""The EVA attention side of a block: the Hopper kernel
`csrc/eva_attn_block.cu` and its plain PyTorch version.

Replaces `uni_adapter_tpu/ops/attention_pallas.py::eva_attn_block_fused`:
q = xn·Wqᵀ + bq, k = xn·Wkᵀ (no bias), v = xn·Wvᵀ + bv, each accumulated
in fp32 and rounded to the compute dtype before its bias; per-head
LayerNorm on q and k (fp32 statistics, one γ/β shared by all heads);
fp32 scores, p = exp((s − max)·scale), o = (p·v)/Σp with p·v on p rounded
to the compute dtype; heads concatenated; then ·Woᵀ + bo.

Weights are in PyTorch's (out, in) layout; `weights.from_jax_params`
transposes the flax (in, out) kernels.  Two widths: D, the tokens', and
Dh = hd·H, the heads'.  The whole attention has D == Dh; a rank's head
shard under tensor parallelism (`parallel/tp.py`) has q/k/v weights
(Dh, D) and biases (Dh,) of its heads and the out projection's (D, Dh)
columns, and passes no `bo`: it then gets the out projection's partial
sum in fp32, unrounded and unbiased, which the ranks sum before the
rounding and the bias that one process applies.  On the card bf16 and fp32 each
have their entry of the kernel; the fp32 one (`eva_attn_block_fp32_cuda`)
rounds nothing below fp32: FFMA projections, and the attention step on
the tensor cores in split TF32 (three TF32 products per fp32 product, a
few fp32 ulps).

Under autograd (grad mode on and an input that requires grad) an fp32
block runs `EvaAttnBlockFunction`: the same forward, its q̂/k̂/v and head
concat kept, and a backward whose attention step and per-head LayerNorm
are the Hopper kernels of `csrc/eva_attn_block_bwd.cu` on the card
(`eva_attn_block_bwd_cuda`) and `eva_attn_block_bwd_plain` on the CPU;
the projections' products around them are `torch.matmul`.  The JAX
package has no bf16 training: a bf16 block under autograd raises on the
card (`build.require_no_grad`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from uni_adapter_torch.ops import build

#: The kernel's head dim: one 64-column GEMM tile per head.
HEAD_DIM = 64


def eva_attn_block_plain(xn: torch.Tensor, wq: torch.Tensor,
                         bq: torch.Tensor, wk: torch.Tensor,
                         wv: torch.Tensor, bv: torch.Tensor,
                         gq: torch.Tensor, bqh: torch.Tensor,
                         gk: torch.Tensor, bkh: torch.Tensor,
                         wo: torch.Tensor, bo: torch.Tensor,
                         num_heads: int, scale: Optional[float] = None,
                         eps: float = 1e-5) -> torch.Tensor:
    """The plain version, at the rounding points of the Pallas kernel.

    Products run on fp32 copies of the operands (exact for bf16 inputs, so
    they equal an fp32-accumulating bf16 product up to summation order);
    `xn.dtype` is the compute dtype.  With `bo` None the out projection's
    fp32 partial sum is returned, unrounded (a head shard's).
    """
    return _plain_parts(xn, wq, bq, wk, wv, bv, gq, bqh, gk, bkh, wo, bo,
                        num_heads, scale, eps)[0]


def _plain_parts(xn, wq, bq, wk, wv, bv, gq, bqh, gk, bkh, wo, bo,
                 num_heads: int, scale: Optional[float], eps: float):
    """`eva_attn_block_plain`'s output, and its q̂, k̂, v (B, H, N, hd) and
    head concat (B, N, Dh) in the compute dtype."""
    B, N, _ = xn.shape
    Dh = wq.shape[0]
    hd = Dh // num_heads
    scale = float(scale if scale is not None else hd ** -0.5)
    dt = xn.dtype
    x = xn.to(torch.float32)

    def proj(w, b):
        y = torch.matmul(x, w.to(torch.float32).T).to(dt)
        return y if b is None else y + b.to(dt)

    def ln(t, g, b):
        t = t.to(torch.float32).reshape(B, N, num_heads, hd)
        mu = t.mean(dim=-1, keepdim=True)
        var = ((t - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (t - mu) * torch.rsqrt(var + eps) * g.to(torch.float32) \
            + b.to(torch.float32)
        return y.to(dt).transpose(1, 2)                     # (B, H, N, hd)

    q = ln(proj(wq, bq), gq, bqh)
    k = ln(proj(wk, None), gk, bkh)
    v = proj(wv, bv).reshape(B, N, num_heads, hd).transpose(1, 2)
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp((s - m) * scale)
    o = torch.matmul(p.to(dt).to(torch.float32), v.to(torch.float32))
    o = o / p.sum(dim=-1, keepdim=True)
    cat = o.transpose(1, 2).reshape(B, N, Dh).to(dt)
    out = torch.matmul(cat.to(torch.float32), wo.to(torch.float32).T)
    if bo is None:
        return out, q, k, v, cat
    return out.to(dt) + bo.to(dt), q, k, v, cat


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument types of a built `csrc/eva_attn_block.cu`."""
    args = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    lib.uat_eva_attn_block.argtypes = args
    # the fp32 entry also reports the kernel its attention step ran
    lib.uat_eva_attn_block_fp32.argtypes = [*args,
                                            ctypes.POINTER(ctypes.c_int)]
    lib.uat_eva_attn_block.restype = lib.uat_eva_attn_block_fp32.restype = \
        ctypes.c_int
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(build.load("eva_attn_block"))


def _launch(entry: str, dtype: torch.dtype, tensors, num_heads: int,
            scale: Optional[float], eps: float, *report) -> torch.Tensor:
    """Check the block's twelve tensors (activations, projection weights
    and biases of `dtype`, fp32 LayerNorm parameters; `bo` may be None),
    then launch `entry` of `csrc/eva_attn_block.cu`: three kernels on the
    current stream; `report` (the fp32 entry's out-parameter) is passed
    last.  xn is (B, N, D); the q/k/v weights (Dh, D) and the out
    projection (D, Dh), Dh = 64·num_heads; with `bo` None the output is
    the fp32 partial sum."""
    xn, wq, bq, wk, wv, bv, gq, bqh, gk, bkh, wo, bo = tensors
    build.require_cuda(xn, dtype, 3, "eva_attn_block xn")
    B, N, D = xn.shape
    Dh = num_heads * HEAD_DIM
    if wq.dim() == 2 and wq.shape[0] != Dh:
        raise ValueError(f"eva_attn_block: the kernel needs head dim "
                         f"{HEAD_DIM}, got {wq.shape[0]} q/k/v columns "
                         f"with {num_heads} heads")
    if D % HEAD_DIM:
        raise ValueError(f"eva_attn_block: the input width D={D} must be a "
                         f"multiple of {HEAD_DIM}")
    for name, w, shape in (("wq", wq, (Dh, D)), ("wk", wk, (Dh, D)),
                           ("wv", wv, (Dh, D)), ("wo", wo, (D, Dh))):
        build.require_cuda(w, dtype, 2, f"eva_attn_block {name}")
        if tuple(w.shape) != shape:
            raise ValueError(f"eva_attn_block {name}: expected {shape}, "
                             f"got {tuple(w.shape)}")
    for name, b, n in (("bq", bq, Dh), ("bv", bv, Dh), ("bo", bo, D)):
        if b is None and name == "bo":
            continue
        build.require_cuda(b, dtype, 1, f"eva_attn_block {name}")
        if b.shape[0] != n:
            raise ValueError(f"eva_attn_block {name}: expected ({n},)")
    for name, p in (("gq", gq), ("bqh", bqh), ("gk", gk), ("bkh", bkh)):
        build.require_cuda(p, torch.float32, 1, f"eva_attn_block {name}")
        if p.shape[0] != HEAD_DIM:
            raise ValueError(f"eva_attn_block {name}: expected ({HEAD_DIM},)")
    given = [t for t in tensors if t is not None]
    if any(t.device != xn.device for t in given):
        raise ValueError("eva_attn_block: tensors on different devices")
    if any(t.data_ptr() % 16 for t in (xn, wq, wk, wv, wo)):
        # the kernels move activations and weights in 16-byte vectors
        raise ValueError("eva_attn_block: xn and weights must be 16-byte "
                         "aligned")
    build.require_no_grad(entry, *given)
    scale = float(scale if scale is not None else HEAD_DIM ** -0.5)
    qkv = torch.empty(B * N, 3 * Dh, dtype=dtype, device=xn.device)
    attn = torch.empty(B * N, Dh, dtype=dtype, device=xn.device)
    out = torch.empty(B, N, D, device=xn.device,
                      dtype=dtype if bo is not None else torch.float32)
    with torch.cuda.device(xn.device):
        rc = getattr(_lib(), entry)(
            *(0 if t is None else t.data_ptr() for t in tensors),
            qkv.data_ptr(), attn.data_ptr(), out.data_ptr(), B, N, D,
            num_heads, scale, eps, build.stream_of(xn), *report)
    build.check(rc, entry)
    return out, qkv, attn


def eva_attn_block_cuda(xn, wq, bq, wk, wv, bv, gq, bqh, gk, bkh, wo, bo,
                        num_heads: int, scale: Optional[float] = None,
                        eps: float = 1e-5) -> torch.Tensor:
    """Launch `csrc/eva_attn_block.cu` (three kernels on the current
    stream).  Takes bf16 activations and projection weights and fp32
    LayerNorm parameters, all contiguous on one CUDA device; with `bo`
    None (a head shard) returns the fp32 partial sum."""
    out, _, _ = _launch("uat_eva_attn_block", torch.bfloat16,
                        (xn, wq, bq, wk, wv, bv, gq, bqh, gk, bkh, wo, bo),
                        num_heads, scale, eps)
    eva_attn_block.launches += 3            # q/k/v GEMM, attention, out GEMM
    if bo is None:                          # of them, a head shard's
        eva_attn_block.head_shard_launches += 3
    return out


def eva_attn_block_fp32_cuda(xn, wq, bq, wk, wv, bv, gq, bqh, gk, bkh, wo,
                             bo, num_heads: int,
                             scale: Optional[float] = None,
                             eps: float = 1e-5, workspaces: bool = False):
    """Launch the fp32 entry of `csrc/eva_attn_block.cu`: a hand-written
    FFMA GEMM for the projections, the fp32 attention in split TF32.
    Takes fp32 activations, weights and LayerNorm parameters, all
    contiguous on one CUDA device (`bo` None: a head shard's partial sum,
    unbiased).  With `workspaces`, returns (out, qkv, attn): also
    q̂ | k̂ | v (B·N, 3Dh) and the head concat (B·N, Dh) that the kernel
    wrote on the way."""
    ran_tc = ctypes.c_int(0)
    out, qkv, attn = _launch(
        "uat_eva_attn_block_fp32", torch.float32,
        (xn, wq, bq, wk, wv, bv, gq, bqh, gk, bkh, wo, bo), num_heads, scale,
        eps, ctypes.byref(ran_tc))
    eva_attn_block_fp32_cuda.launches += 3  # q/k/v GEMM, attention, out GEMM
    if bo is None:                          # of them, a head shard's
        eva_attn_block_fp32_cuda.head_shard_launches += 3
    build.attn_f32_tc.launches += ran_tc.value
    return (out, qkv, attn) if workspaces else out


eva_attn_block_fp32_cuda.launches = 0
eva_attn_block_fp32_cuda.head_shard_launches = 0


def cuda_kernel(dtype: torch.dtype):
    """The card's kernel for `dtype`: bf16 or fp32; any other raises."""
    return build.kernel_for("eva_attn_block", {
        torch.bfloat16: eva_attn_block_cuda,
        torch.float32: eva_attn_block_fp32_cuda}, dtype)


def eva_attn_block(xn, wq, bq, wk, wv, bv, gq, bqh, gk, bkh, wo, bo,
                   num_heads: int, scale: Optional[float] = None,
                   eps: float = 1e-5) -> torch.Tensor:
    """The EVA attention side on post-norm1 tokens xn (B, N, D).

    A CUDA `xn` runs the Hopper kernel of its dtype (bf16 or fp32); a CPU
    `xn` runs `eva_attn_block_plain` in its dtype.  An fp32 block under
    autograd runs `EvaAttnBlockFunction` on either device.  Returns (B, N,
    D) in xn's dtype; with `bo` None (a rank's head shard: (Dh, D) q/k/v
    weights, a (D, Dh) out projection) the fp32 partial sum.
    """
    tensors = (xn, wq, bq, wk, wv, bv, gq, bqh, gk, bkh, wo, bo)
    if xn.dtype == torch.float32 and build.needs_grad(
            *(t for t in tensors if t is not None)):
        hd = HEAD_DIM if xn.is_cuda else wq.shape[0] // num_heads
        return EvaAttnBlockFunction.apply(
            *(t if t is None else t.contiguous() for t in tensors), num_heads,
            float(scale if scale is not None else hd ** -0.5), eps)
    if xn.is_cuda:
        c = lambda t: t.contiguous()
        return cuda_kernel(xn.dtype)(
            c(xn), c(wq), c(bq), c(wk), c(wv), c(bv),
            c(gq.to(torch.float32)), c(bqh.to(torch.float32)),
            c(gk.to(torch.float32)), c(bkh.to(torch.float32)),
            c(wo), None if bo is None else c(bo), num_heads=num_heads,
            scale=scale, eps=eps)
    return eva_attn_block_plain(xn, wq, bq, wk, wv, bv, gq, bqh, gk, bkh,
                                wo, bo, num_heads=num_heads, scale=scale,
                                eps=eps)


eva_attn_block.launches = 0
eva_attn_block.head_shard_launches = 0


# ---------------------------------------------------------------- backward


def attn_step_bwd_plain(qkv: torch.Tensor, attn: torch.Tensor,
                        dout: torch.Tensor, B: int, N: int, num_heads: int,
                        scale: float) -> torch.Tensor:
    """The attention step's backward, the arithmetic of
    `csrc/eva_attn_block_bwd.cu`'s kernels (1) and (2) before their
    LayerNorm epilogues: from q̂ | k̂ | v (B·N, 3D), the step's output O
    (B·N, D) and dO (B·N, D), with s = q̂·k̂ᵀ unscaled, P = exp((s − max s)·scale) / ℓ and Δ = rowsum(dO ∘ O):
    dv = Pᵀ·dO, dS = P ∘ (dO·vᵀ − Δ), dq̂ = scale·dS·k̂, dk̂ = scale·dSᵀ·q̂.
    Returns dq̂ | dk̂ | dv (B·N, 3D) in the same layout."""
    D = attn.shape[1]
    hd = D // num_heads

    def heads(t):                                           # (B, H, N, hd)
        return t.reshape(B, N, -1, hd).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.split(D, dim=1))
    o, do = heads(attn), heads(dout)
    s = torch.matmul(q, k.transpose(-1, -2))
    p = torch.exp((s - s.amax(dim=-1, keepdim=True)) * scale)
    p = p / p.sum(dim=-1, keepdim=True)
    delta = (do * o).sum(dim=-1, keepdim=True)
    dv = torch.matmul(p.transpose(-1, -2), do)
    ds = p * (torch.matmul(do, v.transpose(-1, -2)) - delta)
    dq = scale * torch.matmul(ds, k)
    dk = scale * torch.matmul(ds.transpose(-1, -2), q)
    return torch.cat([t.transpose(1, 2).reshape(B * N, D)
                      for t in (dq, dk, dv)], dim=1)


def head_ln_bwd_plain(raw: torch.Tensor, dqkv: torch.Tensor,
                      gq: torch.Tensor, gk: torch.Tensor, num_heads: int,
                      eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-head q/k LayerNorm's backward, the epilogues of kernels (1)
    and (2) of `csrc/eva_attn_block_bwd.cu` with the γ/β sum of (3): x̂
    recomputed from the raw q | k (B·N, 2D), dx̂ = dy·γ, dx = rstd·(dx̂ −
    mean(dx̂) − x̂·mean(dx̂·x̂)).  Returns dq | dk | dv (B·N, 3D), dqkv with
    its dq̂ and dk̂ replaced, and (4, 64) dγq, dβq, dγk, dβk."""
    M, D2 = raw.shape
    D = D2 // 2
    hd = D // num_heads
    x = raw.reshape(M, 2, num_heads, hd)
    dy = dqkv[:, :D2].reshape(M, 2, num_heads, hd)
    g = torch.stack([gq, gk])[None, :, None, :]             # (1, 2, 1, hd)
    mu = x.mean(dim=-1, keepdim=True)
    d = x - mu
    rstd = 1.0 / torch.sqrt((d * d).mean(dim=-1, keepdim=True) + eps)
    xh = d * rstd
    dxh = dy * g
    dx = rstd * (dxh - dxh.mean(dim=-1, keepdim=True)
                 - xh * (dxh * xh).mean(dim=-1, keepdim=True))
    dg = (dy * xh).sum(dim=(0, 2))                          # (2, hd)
    db = dy.sum(dim=(0, 2))
    dln = torch.stack([dg[0], db[0], dg[1], db[1]])
    return torch.cat([dx.reshape(M, D2), dqkv[:, D2:]], dim=1), dln


def eva_attn_block_bwd_plain(qkv, attn, dout, raw, gq, gk, B: int, N: int,
                             num_heads: int, scale: float, eps: float):
    """What `eva_attn_block_bwd_cuda` computes, in plain PyTorch: the
    attention step's backward, then the per-head LayerNorm's.  Returns
    (dq | dk | dv (B·N, 3D), dγq, dβq, dγk, dβk (4, 64))."""
    eva_attn_block_bwd_plain.calls += 1
    return head_ln_bwd_plain(
        raw, attn_step_bwd_plain(qkv, attn, dout, B, N, num_heads, scale),
        gq, gk, num_heads, eps)


#: Calls of the plain backward: a training run on the card makes none.
eva_attn_block_bwd_plain.calls = 0


def _bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument types of a built `csrc/eva_attn_block_bwd.cu`."""
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.uat_eva_attn_block_bwd.argtypes = (
        [ptr] * 8 + [i64, ptr, i64, ptr] + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_float, ptr])
    lib.uat_eva_attn_block_bwd.restype = ctypes.c_int
    lib.uat_eva_attn_block_bwd_workspace.argtypes = (
        [ctypes.c_int] * 3 + [ctypes.POINTER(i64)] * 2)
    lib.uat_eva_attn_block_bwd_workspace.restype = ctypes.c_int
    return lib


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    return _bind_bwd(build.load("eva_attn_block_bwd"))


def eva_attn_block_bwd_cuda(qkv, attn, dout, raw, gq, gk, B: int, N: int,
                            num_heads: int, scale: float, eps: float):
    """Launch `csrc/eva_attn_block_bwd.cu` (three kernels on the current
    stream).  Takes the fp32 block's q̂ | k̂ | v (B·N, 3D) and head concat
    O (B·N, D) workspaces, dO (B·N, D), the raw q | k (B·N, 2D) and the
    LayerNorms' γ (64,), all fp32 and contiguous on one CUDA device.
    Returns (dq | dk | dv (B·N, 3D), dγq, dβq, dγk, dβk (4, 64))."""
    M = B * N
    D = num_heads * HEAD_DIM
    for name, t, cols in (("qkv", qkv, 3 * D), ("attn", attn, D),
                          ("dout", dout, D), ("raw", raw, 2 * D)):
        build.require_cuda(t, torch.float32, 2, f"eva_attn_block_bwd {name}")
        if tuple(t.shape) != (M, cols):
            raise ValueError(f"eva_attn_block_bwd {name}: expected "
                             f"{(M, cols)}, got {tuple(t.shape)} (head dim "
                             f"{HEAD_DIM}, {num_heads} heads)")
    for name, t in (("gq", gq), ("gk", gk)):
        build.require_cuda(t, torch.float32, 1, f"eva_attn_block_bwd {name}")
        if t.shape[0] != HEAD_DIM:
            raise ValueError(f"eva_attn_block_bwd {name}: expected "
                             f"({HEAD_DIM},)")
    tensors = (qkv, attn, dout, raw, gq, gk)
    if any(t.device != qkv.device for t in tensors):
        raise ValueError("eva_attn_block_bwd: tensors on different devices")
    if any(t.data_ptr() % 16 for t in tensors[:4]):
        # the kernels read rows as float4
        raise ValueError("eva_attn_block_bwd: tensors must be 16-byte "
                         "aligned")
    lib = _lib_bwd()
    dev = qkv.device
    dqkv = torch.empty_like(qkv)
    n_stats, n_partials = ctypes.c_int64(), ctypes.c_int64()
    build.check(lib.uat_eva_attn_block_bwd_workspace(
        B, N, num_heads, ctypes.byref(n_stats), ctypes.byref(n_partials)),
        "uat_eva_attn_block_bwd_workspace")
    n_stats, n_partials = n_stats.value, n_partials.value
    stats = torch.empty(n_stats, device=dev)
    partials = torch.empty(n_partials, device=dev)
    dln = torch.empty(4, HEAD_DIM, device=dev)
    with torch.cuda.device(dev):
        rc = lib.uat_eva_attn_block_bwd(
            *(t.data_ptr() for t in tensors), dqkv.data_ptr(),
            stats.data_ptr(), n_stats, partials.data_ptr(), n_partials,
            dln.data_ptr(), B, N, D, num_heads, scale, eps,
            build.stream_of(qkv))
    build.check(rc, "uat_eva_attn_block_bwd")
    eva_attn_block_bwd_cuda.launches += 3   # dq, dk/dv, the γ/β sum
    return dqkv, dln


eva_attn_block_bwd_cuda.launches = 0


def eva_attn_block_backward(dy, xn, wq, bq, wk, wv, gq, gk, wo, qkv, attn,
                            num_heads: int, scale: float, eps: float,
                            step=None) -> tuple:
    """The twelve gradients of the fp32 block (xn, wq, bq, wk, wv, bv, gq,
    bqh, gk, bkh, wo, bo) from dy (B, N, D) and what its forward kept:
    dO = dy·Wo, dWo = dyᵀ·O, dbo = Σdy (a head shard's wq (Dh, D): the
    heads' width Dh throughout, the partial sum's bo None); `step` (the
    attention step and
    q/k LayerNorm backward: `eva_attn_block_bwd_cuda` on the card,
    `eva_attn_block_bwd_plain` on the CPU by default) on the raw q | k,
    recomputed as xn·[Wq|Wk]ᵀ + [bq|0] from the kept xn; then dxn =
    [dq|dk|dv]·[Wq;Wk;Wv], [dWq;dWk;dWv] = [dq|dk|dv]ᵀ·xn, dbq = Σdq,
    dbv = Σdv.  Products in fp32 (`torch.matmul`; TF32 as the caller set
    it, off on the port's paths)."""
    B, N, D = xn.shape
    Dh = wq.shape[0]
    M = B * N
    if step is None:
        step = eva_attn_block_bwd_cuda if xn.is_cuda else \
            eva_attn_block_bwd_plain
    x2, dy2 = xn.reshape(M, D), dy.reshape(M, D)
    dout = torch.matmul(dy2, wo)
    dwo = torch.matmul(dy2.T, attn)
    dbo = dy2.sum(dim=0)
    raw = torch.matmul(x2, torch.cat([wq, wk]).T)
    raw[:, :Dh] += bq
    dqkv, dln = step(qkv, attn, dout.contiguous(), raw, gq, gk, B, N,
                     num_heads, scale, eps)
    w = torch.cat([wq, wk, wv])
    dxn = torch.matmul(dqkv, w).reshape(B, N, D)
    dw = torch.matmul(dqkv.T, x2)
    dq, dv = dqkv[:, :Dh], dqkv[:, 2 * Dh:]
    return (dxn, dw[:Dh], dq.sum(dim=0), dw[Dh:2 * Dh], dw[2 * Dh:],
            dv.sum(dim=0), dln[0], dln[1], dln[2], dln[3], dwo, dbo)


class EvaAttnBlockFunction(torch.autograd.Function):
    """The fp32 EVA attention side with its gradient.  Forward: the fp32
    entry of `csrc/eva_attn_block.cu` unchanged on the card (its q̂ | k̂ | v
    and head-concat workspaces kept), `eva_attn_block_plain`'s arithmetic
    on the CPU.  Backward: `eva_attn_block_backward` (the kernels of
    `csrc/eva_attn_block_bwd.cu` on the card, the plain version on the
    CPU).  Saves xn, the weights and the two workspaces: 4·B·N·D floats a
    block beyond its input."""

    @staticmethod
    def forward(ctx, xn, wq, bq, wk, wv, bv, gq, bqh, gk, bkh, wo, bo,
                num_heads: int, scale: float, eps: float):
        args = (xn, wq, bq, wk, wv, bv, gq, bqh, gk, bkh, wo, bo)
        if xn.is_cuda:
            out, qkv, attn = eva_attn_block_fp32_cuda(
                *args, num_heads=num_heads, scale=scale, eps=eps,
                workspaces=True)
        else:
            out, q, k, v, cat = _plain_parts(*args, num_heads, scale, eps)
            B, N, _ = xn.shape
            Dh = wq.shape[0]
            qkv = torch.cat([t.transpose(1, 2).reshape(B * N, Dh)
                             for t in (q, k, v)], dim=1)
            attn = cat.reshape(B * N, Dh)
        ctx.save_for_backward(xn, wq, bq, wk, wv, gq, gk, wo, qkv, attn)
        ctx.consts = (num_heads, scale, eps)
        ctx.partial = bo is None
        return out

    @staticmethod
    def backward(ctx, dy):
        grads = eva_attn_block_backward(dy.contiguous(), *ctx.saved_tensors,
                                        *ctx.consts)
        if ctx.partial:                     # a head shard's: no bo
            grads = (*grads[:-1], None)
        return (*grads, None, None, None)
