"""The EVA attention side of a block: the Hopper kernel
`csrc/eva_attn_block.cu` and its plain PyTorch version.

Replaces `uni_adapter_tpu/ops/attention_pallas.py::eva_attn_block_fused`:
q = xn·Wqᵀ + bq, k = xn·Wkᵀ (no bias), v = xn·Wvᵀ + bv, each accumulated
in fp32 and rounded to the compute dtype before its bias; per-head
LayerNorm on q and k (fp32 statistics, one γ/β shared by all heads);
fp32 scores, p = exp((s − max)·scale), o = (p·v)/Σp with p·v on p rounded
to the compute dtype; heads concatenated; then ·Woᵀ + bo.

Weights are in PyTorch's (out, in) layout; `weights.from_jax_params`
transposes the flax (in, out) kernels.  On the card bf16 and fp32 each
have their entry of the kernel; the fp32 one (`eva_attn_block_fp32_cuda`)
rounds nothing below fp32: FFMA projections, and the attention step on
the tensor cores in split TF32 (three TF32 products per fp32 product, a
few fp32 ulps).
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
    `xn.dtype` is the compute dtype.
    """
    B, N, D = xn.shape
    hd = D // num_heads
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
    cat = o.transpose(1, 2).reshape(B, N, D).to(dt)
    out = torch.matmul(cat.to(torch.float32), wo.to(torch.float32).T).to(dt)
    return out + bo.to(dt)


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
    and biases of `dtype`, fp32 LayerNorm parameters), then launch `entry`
    of `csrc/eva_attn_block.cu`: three kernels on the current stream;
    `report` (the fp32 entry's out-parameter) is passed last."""
    xn, wq, bq, wk, wv, bv, gq, bqh, gk, bkh, wo, bo = tensors
    build.require_cuda(xn, dtype, 3, "eva_attn_block xn")
    B, N, D = xn.shape
    if D != num_heads * HEAD_DIM:
        raise ValueError(f"eva_attn_block: the kernel needs head dim "
                         f"{HEAD_DIM}, got D={D} with {num_heads} heads")
    for name, w in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
        build.require_cuda(w, dtype, 2, f"eva_attn_block {name}")
        if tuple(w.shape) != (D, D):
            raise ValueError(f"eva_attn_block {name}: expected {(D, D)}, "
                             f"got {tuple(w.shape)}")
    for name, b in (("bq", bq), ("bv", bv), ("bo", bo)):
        build.require_cuda(b, dtype, 1, f"eva_attn_block {name}")
        if b.shape[0] != D:
            raise ValueError(f"eva_attn_block {name}: expected ({D},)")
    for name, p in (("gq", gq), ("bqh", bqh), ("gk", gk), ("bkh", bkh)):
        build.require_cuda(p, torch.float32, 1, f"eva_attn_block {name}")
        if p.shape[0] != HEAD_DIM:
            raise ValueError(f"eva_attn_block {name}: expected ({HEAD_DIM},)")
    if any(t.device != xn.device for t in tensors):
        raise ValueError("eva_attn_block: tensors on different devices")
    if any(t.data_ptr() % 16 for t in (xn, wq, wk, wv, wo)):
        # the kernels move activations and weights in 16-byte vectors
        raise ValueError("eva_attn_block: xn and weights must be 16-byte "
                         "aligned")
    scale = float(scale if scale is not None else HEAD_DIM ** -0.5)
    qkv = torch.empty(B * N, 3 * D, dtype=dtype, device=xn.device)
    attn = torch.empty(B * N, D, dtype=dtype, device=xn.device)
    out = torch.empty_like(xn)
    with torch.cuda.device(xn.device):
        rc = getattr(_lib(), entry)(
            *(t.data_ptr() for t in tensors), qkv.data_ptr(),
            attn.data_ptr(), out.data_ptr(), B, N, D, num_heads, scale, eps,
            build.stream_of(xn), *report)
    build.check(rc, entry)
    return out


def eva_attn_block_cuda(xn, wq, bq, wk, wv, bv, gq, bqh, gk, bkh, wo, bo,
                        num_heads: int, scale: Optional[float] = None,
                        eps: float = 1e-5) -> torch.Tensor:
    """Launch `csrc/eva_attn_block.cu` (three kernels on the current
    stream).  Takes bf16 activations and projection weights and fp32
    LayerNorm parameters, all contiguous on one CUDA device."""
    out = _launch("uat_eva_attn_block", torch.bfloat16,
                  (xn, wq, bq, wk, wv, bv, gq, bqh, gk, bkh, wo, bo),
                  num_heads, scale, eps)
    eva_attn_block.launches += 3            # q/k/v GEMM, attention, out GEMM
    return out


def eva_attn_block_fp32_cuda(xn, wq, bq, wk, wv, bv, gq, bqh, gk, bkh, wo,
                             bo, num_heads: int,
                             scale: Optional[float] = None,
                             eps: float = 1e-5) -> torch.Tensor:
    """Launch the fp32 entry of `csrc/eva_attn_block.cu`: a hand-written
    FFMA GEMM for the projections, the fp32 attention in split TF32.
    Takes fp32 activations, weights and LayerNorm parameters, all
    contiguous on one CUDA device."""
    ran_tc = ctypes.c_int(0)
    out = _launch("uat_eva_attn_block_fp32", torch.float32,
                  (xn, wq, bq, wk, wv, bv, gq, bqh, gk, bkh, wo, bo),
                  num_heads, scale, eps, ctypes.byref(ran_tc))
    eva_attn_block_fp32_cuda.launches += 3  # q/k/v GEMM, attention, out GEMM
    build.attn_f32_tc.launches += ran_tc.value
    return out


eva_attn_block_fp32_cuda.launches = 0


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
    `xn` runs `eva_attn_block_plain` in its dtype.  Returns (B, N, D) in
    xn's dtype.
    """
    if xn.is_cuda:
        c = lambda t: t.contiguous()
        return cuda_kernel(xn.dtype)(
            c(xn), c(wq), c(bq), c(wk), c(wv), c(bv),
            c(gq.to(torch.float32)), c(bqh.to(torch.float32)),
            c(gk.to(torch.float32)), c(bkh.to(torch.float32)),
            c(wo), c(bo), num_heads=num_heads, scale=scale, eps=eps)
    return eva_attn_block_plain(xn, wq, bq, wk, wv, bv, gq, bqh, gk, bkh,
                                wo, bo, num_heads=num_heads, scale=scale,
                                eps=eps)


eva_attn_block.launches = 0
