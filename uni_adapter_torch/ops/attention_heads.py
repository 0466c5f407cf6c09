"""(B, H, N, hd) multi-head attention: the Hopper kernel
`csrc/attention_heads.cu` and its plain PyTorch version.

Replaces `uni_adapter_tpu/ops/attention_pallas.py::attention_pallas_heads`:
fp32 scores from the operands, the maximum taken over the real keys,
p = exp((s − m)·scale) in fp32; p·v runs on p rounded to v's dtype with
fp32 accumulation and is divided by the fp32 Σp.  The output is
(B, H, N, hd) in v's dtype.  The models reach it through
`models.common.attend` wherever the JAX package calls
`_attend(use_pallas=True)`: the attention-map extraction path
(`return_attn`) and head dims that are not a multiple of 8.  On the card
bf16 tensors run this kernel and fp32 tensors `ops.attention_fp32` (the
port of `attention_pallas`, which with fp32 operands is this function in
fp32); on the CPU both run `attention_heads_plain`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from uni_adapter_torch.ops import build
from uni_adapter_torch.ops.attention_fp32 import attention_fp32_cuda

#: The widest head the kernel takes.
MAX_HEAD_DIM = 128
#: Head dims whose rows the kernel loads as 16-byte vectors (the others
#: element by element into a tile padded to the next of these).
VECTOR_HEAD_DIMS = (16, 32, 64, 128)


def attention_heads_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The plain version, at the rounding points of the Pallas kernel.

    Products run on fp32 copies of the operands (exact for bf16 inputs, so
    they equal an fp32-accumulating bf16 product up to summation order).
    """
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    dt, f32 = v.dtype, torch.float32
    s = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2))   # (B, H, N, N)
    p = torch.exp((s - s.amax(dim=-1, keepdim=True)) * scale)
    o = torch.matmul(p.to(dt).to(f32), v.to(f32)) / p.sum(dim=-1, keepdim=True)
    return o.to(dt)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("attention_heads")
    lib.uat_attention_heads.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p])
    lib.uat_attention_heads.restype = ctypes.c_int
    return lib


def attention_heads_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Launch `csrc/attention_heads.cu`.  Takes bf16 q, k, v of one
    (B, H, N, hd) shape on one CUDA device, contiguous, with hd ≤ 128, and
    16-byte aligned when hd is 16, 32, 64 or 128."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.require_cuda(t, torch.bfloat16, 4, f"attention_heads {name}")
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"attention_heads: {name} is {tuple(t.shape)} on "
                             f"{t.device}, q {tuple(q.shape)} on {q.device}")
    B, H, N, hd = q.shape
    if hd in VECTOR_HEAD_DIMS and any(t.data_ptr() % 16 for t in (q, k, v)):
        # rows of these widths move in 16-byte vectors
        raise ValueError(f"attention_heads: head dim {hd} needs 16-byte "
                         f"aligned tensors")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"attention_heads: the kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}, got {hd}")
    if B * H > 65535:
        raise ValueError(f"attention_heads: B·H = {B * H} exceeds the grid's "
                         f"65535")
    build.require_no_grad("attention_heads", q, k, v)
    scale = float(scale if scale is not None else hd ** -0.5)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _lib().uat_attention_heads(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, N,
            hd, scale, build.stream_of(q))
    build.check(rc, "attention_heads")
    attention_heads.launches += 1
    return out


def cuda_kernel(dtype: torch.dtype):
    """The card's kernel for `dtype`: this module's for bf16, the port of
    `attention_pallas` for fp32; any other raises.  Each counts its own
    launches (`attention_heads.launches` the bf16 ones)."""
    return build.kernel_for("attention_heads", {
        torch.bfloat16: attention_heads_cuda,
        torch.float32: attention_fp32_cuda}, dtype)


def attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (B, H, N, hd) q, k, v.

    CUDA tensors run the Hopper kernel of their dtype (bf16 or fp32,
    hd ≤ 128; strided inputs are made contiguous first), CPU tensors
    `attention_heads_plain` in their dtype.  Returns (B, H, N, hd) in v's
    dtype.
    """
    if q.is_cuda:
        return cuda_kernel(q.dtype)(q.contiguous(), k.contiguous(),
                                    v.contiguous(), scale)
    return attention_heads_plain(q, k, v, scale)


attention_heads.launches = 0
