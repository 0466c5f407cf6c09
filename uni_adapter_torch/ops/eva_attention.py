"""Natural-layout multi-head attention: the Hopper kernel
`csrc/eva_attention.cu` and its plain PyTorch version.

Replaces `uni_adapter_tpu/ops/attention_pallas.py::eva_attention_fused`.
q, k and v are (B, N, D) with heads as D-slices of width D / H.  With γ/β
given, q and k of each head first go through a LayerNorm (fp32
statistics, one γ/β shared by all heads) and are rounded to the compute
dtype (v's).  Scores are fp32, the maximum is taken over the keys,
p = exp((s − m)·scale); p·v runs on p rounded to the compute dtype and is
divided by the fp32 Σp.  The output is (B, N, D) in v's dtype.  On the
card bf16 and fp32 each have their entry of the kernel, the fp32 one
(`eva_attention_fp32_cuda`) with no rounding below fp32 anywhere.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from uni_adapter_torch.ops import build

#: The kernel's head dim.
HEAD_DIM = 64


def eva_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        gq: Optional[torch.Tensor] = None,
                        bq: Optional[torch.Tensor] = None,
                        gk: Optional[torch.Tensor] = None,
                        bk: Optional[torch.Tensor] = None, *,
                        num_heads: int, scale: Optional[float] = None,
                        eps: float = 1e-5) -> torch.Tensor:
    """The plain version, at the rounding points of the Pallas kernel.  k
    and v may hold another number of tokens than q.

    Products run on fp32 copies of the operands (exact for bf16 inputs, so
    they equal an fp32-accumulating bf16 product up to summation order).
    """
    B, N, D = q.shape
    hd = D // num_heads
    scale = float(scale if scale is not None else hd ** -0.5)
    dt = v.dtype
    f32 = torch.float32

    def heads(t):                                       # (B, H, n, hd) fp32
        return t.to(f32).reshape(B, t.shape[1], num_heads, hd).transpose(1, 2)

    def ln(t, g, b):
        mu = t.mean(dim=-1, keepdim=True)
        var = ((t - mu) ** 2).mean(dim=-1, keepdim=True)
        return (t - mu) * torch.rsqrt(var + eps) * g.to(f32) + b.to(f32)

    qh, kh = heads(q), heads(k)
    if gq is not None:
        qh, kh = ln(qh, gq, bq), ln(kh, gk, bk)
    qh, kh = qh.to(dt).to(f32), kh.to(dt).to(f32)
    s = torch.matmul(qh, kh.transpose(-1, -2))                  # (B, H, N, N)
    p = torch.exp((s - s.amax(dim=-1, keepdim=True)) * scale)
    o = torch.matmul(p.to(dt).to(f32), heads(v)) / p.sum(dim=-1, keepdim=True)
    return o.transpose(1, 2).reshape(B, N, D).to(dt)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` (a build of `csrc/eva_attention.cu`) with its entries'
    argument types declared."""
    args = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6
            + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    lib.uat_eva_attention.argtypes = args
    # the fp32 entry also reports the kernel it ran
    lib.uat_eva_attention_fp32.argtypes = [*args,
                                           ctypes.POINTER(ctypes.c_int)]
    lib.uat_eva_attention.restype = lib.uat_eva_attention_fp32.restype = \
        ctypes.c_int
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(build.load("eva_attention"))


def _launch(entry: str, dtype: torch.dtype, q, k, v, ln, num_heads: int,
            scale: Optional[float], eps: float, *report) -> torch.Tensor:
    """Check q, k, v (of `dtype`) and the LayerNorm parameters `ln`, then
    launch `entry` of `csrc/eva_attention.cu`, passing `report` (the fp32
    entry's out-parameter) last."""
    per_vector = 16 // (torch.finfo(dtype).bits // 8)   # elements
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.require_cuda(t, dtype, 3, f"eva_attention {name}",
                           contiguous=False)
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"eva_attention: {name} is {tuple(t.shape)} on "
                             f"{t.device}, q {tuple(q.shape)} on {q.device}")
        if t.stride(2) != 1 or t.stride(0) % per_vector \
                or t.stride(1) % per_vector or t.data_ptr() % 16:
            # the kernel moves rows in 16-byte vectors
            raise ValueError(f"eva_attention {name}: needs unit column "
                             f"stride and 16-byte aligned rows, got strides "
                             f"{t.stride()}")
    B, N, D = q.shape
    if D != num_heads * HEAD_DIM:
        raise ValueError(f"eva_attention: the kernel needs head dim "
                         f"{HEAD_DIM}, got D={D} with {num_heads} heads")
    if any(p is None for p in ln) and any(p is not None for p in ln):
        raise ValueError("eva_attention: give all four of gq/bq/gk/bk or none")
    if ln[0] is not None:
        for name, p in zip(("gq", "bq", "gk", "bk"), ln):
            build.require_cuda(p, torch.float32, 1, f"eva_attention {name}")
            if p.shape[0] != HEAD_DIM or p.device != q.device:
                raise ValueError(f"eva_attention {name}: expected "
                                 f"({HEAD_DIM},) on {q.device}")
    build.require_no_grad("eva_attention", q, k, v,
                          *(p for p in ln if p is not None))
    scale = float(scale if scale is not None else HEAD_DIM ** -0.5)
    out = torch.empty(B, N, D, dtype=dtype, device=q.device)
    ptrs = [None if p is None else p.data_ptr() for p in ln]
    with torch.cuda.device(q.device):
        rc = getattr(_lib(), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(1),
            k.stride(1), v.stride(1), q.stride(0), k.stride(0), v.stride(0),
            *ptrs, out.data_ptr(), B, N, D, num_heads, scale, eps,
            build.stream_of(q), *report)
    build.check(rc, entry)
    return out


def eva_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       gq: Optional[torch.Tensor] = None,
                       bq: Optional[torch.Tensor] = None,
                       gk: Optional[torch.Tensor] = None,
                       bk: Optional[torch.Tensor] = None, *,
                       num_heads: int, scale: Optional[float] = None,
                       eps: float = 1e-5) -> torch.Tensor:
    """Launch `csrc/eva_attention.cu`.  Takes bf16 q, k, v of one (B, N, D)
    shape on one CUDA device, each with unit column stride and rows on
    16-byte boundaries (e.g. the three column slices of a fused qkv
    product), and fp32 LayerNorm parameters or none."""
    out = _launch("uat_eva_attention", torch.bfloat16, q, k, v,
                  (gq, bq, gk, bk), num_heads, scale, eps)
    eva_attention_fused.launches += 1
    return out


def eva_attention_fp32_cuda(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            gq: Optional[torch.Tensor] = None,
                            bq: Optional[torch.Tensor] = None,
                            gk: Optional[torch.Tensor] = None,
                            bk: Optional[torch.Tensor] = None, *,
                            num_heads: int, scale: Optional[float] = None,
                            eps: float = 1e-5) -> torch.Tensor:
    """Launch the fp32 entry of `csrc/eva_attention.cu` (fp32 throughout,
    split TF32 without the LayerNorm, FFMA with it).  Takes fp32 q, k, v
    laid out as `eva_attention_cuda`
    takes bf16 ones, and fp32 LayerNorm parameters or none."""
    ran_tc = ctypes.c_int(0)
    out = _launch("uat_eva_attention_fp32", torch.float32, q, k, v,
                  (gq, bq, gk, bk), num_heads, scale, eps,
                  ctypes.byref(ran_tc))
    eva_attention_fp32_cuda.launches += 1
    build.attn_f32_tc.launches += ran_tc.value
    return out


eva_attention_fp32_cuda.launches = 0


def cuda_kernel(dtype: torch.dtype):
    """The card's kernel for `dtype`: bf16 or fp32; any other raises."""
    return build.kernel_for("eva_attention", {
        torch.bfloat16: eva_attention_cuda,
        torch.float32: eva_attention_fp32_cuda}, dtype)


def eva_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        gq: Optional[torch.Tensor] = None,
                        bq: Optional[torch.Tensor] = None,
                        gk: Optional[torch.Tensor] = None,
                        bk: Optional[torch.Tensor] = None, *,
                        num_heads: int, scale: Optional[float] = None,
                        eps: float = 1e-5) -> torch.Tensor:
    """Attention over heads as D-slices of q, k, v (B, N, D), with the
    optional per-head q/k LayerNorm (γ/β of shape (D / H,)).

    CUDA tensors run the Hopper kernel of their dtype (bf16 or fp32, head
    dim 64; column slices pass without a copy), CPU tensors
    `eva_attention_plain` in their dtype.  Returns (B, N, D) in v's dtype.
    """
    if q.is_cuda:
        f = lambda p: None if p is None else p.to(torch.float32).contiguous()
        return cuda_kernel(q.dtype)(q, k, v, f(gq), f(bq), f(gk), f(bk),
                                    num_heads=num_heads, scale=scale, eps=eps)
    return eva_attention_plain(q, k, v, gq, bq, gk, bk, num_heads=num_heads,
                               scale=scale, eps=eps)


eva_attention_fused.launches = 0
