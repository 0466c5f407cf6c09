"""(B, H, N, hd) multi-head attention in fp32: the Hopper kernel
`csrc/attention_fp32.cu` and its plain PyTorch version.

Replaces `uni_adapter_tpu/ops/attention_pallas.py::attention_pallas`
(`_attn_kernel`): q and k cast to fp32, fp32 scores times the scale, the
maximum over the real keys, exp, p / Σp, then p (cast to v's dtype) · v
with fp32 accumulation.  The output is (B, H, N, hd) in v's dtype.  On the
card it is the fp32 route of `ops.attention_heads` (whose bf16 kernel is
the bf16 route), so fp32 models reach it wherever the JAX package calls
`_attend(use_pallas=True)`: the attention-map extraction path
(`return_attn`) and head dims that are not a multiple of 8.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from uni_adapter_torch.ops import build

#: The widest head the kernel takes.
MAX_HEAD_DIM = 128
#: Head dims whose rows the kernel loads as float4 (the others element by
#: element into a tile padded to the next of these).
VECTOR_HEAD_DIMS = (16, 32, 64, 128)


def attention_fp32_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """The plain version, in `_attn_kernel`'s order.  Takes bf16 or fp32,
    as the Pallas function does; k and v may hold another number of tokens
    than q."""
    scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    dt, f32 = v.dtype, torch.float32
    s = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(p.to(dt).to(f32), v.to(f32)).to(dt)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` (a build of `csrc/attention_fp32.cu`) with its entry's
    argument types declared."""
    lib.uat_attention_fp32.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    lib.uat_attention_fp32.restype = ctypes.c_int
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    return _bind(build.load("attention_fp32"))


def attention_fp32_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Launch `csrc/attention_fp32.cu`.  Takes fp32 q, k, v of one
    (B, H, N, hd) shape on one CUDA device, contiguous, with hd ≤ 128, and
    16-byte aligned when hd is 16, 32, 64 or 128."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.require_cuda(t, torch.float32, 4, f"attention_fp32 {name}")
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"attention_fp32: {name} is {tuple(t.shape)} on "
                             f"{t.device}, q {tuple(q.shape)} on {q.device}")
    B, H, N, hd = q.shape
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"attention_fp32: the kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}, got {hd}")
    if hd in VECTOR_HEAD_DIMS and any(t.data_ptr() % 16 for t in (q, k, v)):
        # rows of these widths move as float4
        raise ValueError(f"attention_fp32: head dim {hd} needs 16-byte "
                         f"aligned tensors")
    if B * H > 65535:
        raise ValueError(f"attention_fp32: B·H = {B * H} exceeds the grid's "
                         f"65535")
    build.require_no_grad("attention_fp32", q, k, v)
    scale = float(scale if scale is not None else hd ** -0.5)
    out = torch.empty_like(q)
    ran_tc = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        rc = _lib().uat_attention_fp32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, N,
            hd, scale, build.stream_of(q), ctypes.byref(ran_tc))
    build.check(rc, "attention_fp32")
    attention_fp32.launches += 1
    build.attn_f32_tc.launches += ran_tc.value
    return out


def attention_fp32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Attention over (B, H, N, hd) q, k, v.

    CUDA tensors run the Hopper kernel (fp32, hd ≤ 128; strided inputs are
    made contiguous first), CPU tensors `attention_fp32_plain` in their
    dtype.  Returns (B, H, N, hd) in v's dtype.
    """
    if q.is_cuda:
        return attention_fp32_cuda(q.contiguous(), k.contiguous(),
                                   v.contiguous(), scale)
    return attention_fp32_plain(q, k, v, scale)


attention_fp32.launches = 0
