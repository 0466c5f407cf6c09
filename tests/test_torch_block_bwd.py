"""The fp32 block's backward on the CPU: the arithmetic that the kernels
of `csrc/eva_attn_block_bwd.cu` follow (kernel (1)'s one pass over
32-key chunks with m and ℓ online, kernel (2)'s P from (1)'s m + log2 ℓ
in log2 units, the LayerNorm epilogues) held to the plain backward, the
autograd entry's gradients at the kernels' 64-wide heads (ragged N, head
shards) held to autograd of the plain forward, and the wrapper's input
checks.  The kernels themselves run only on the card (chip_smoke.py
phase 3)."""
import math

import numpy as np
import pytest
import torch

from uni_adapter_torch.ops import attention, build
from torch_threads import one_torch_thread  # noqa: F401


def kernels_model(qkv, attn, dout, raw, gq, gk, B: int, N: int, H: int,
                  scale: float, eps: float, chunk: int = 32):
    """What kernels (1) to (3) compute, in their order, in the inputs'
    dtype: (1) a pass over `chunk`-key chunks, s in log2 units (q̂ scaled
    by scale·log2 e), m the running maximum, dS' = 2^(s − m)(dP − Δ)
    summed into dq̂ with the sum and ℓ rescaled by 2^(m_old − m_new), dq̂ =
    scale·sum/ℓ; (2) P = 2^((k̂ scale·log2 e)·q̂ᵀ − (m + log2 ℓ)), dv =
    Pᵀ·dO, dk̂ = scale·dSᵀ·q̂; then the LayerNorm's backward and the γ/β
    sums (`head_ln_bwd_plain`)."""
    D = H * 64
    c = scale * math.log2(math.e)

    def heads(t):                                           # (B, H, N, 64)
        return t.reshape(B, N, H, 64).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.split(D, dim=1))
    o, do = heads(attn), heads(dout)
    delta = (do * o).sum(-1, keepdim=True)
    m = torch.full((B, H, N, 1), -math.inf, dtype=qkv.dtype)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    for k0 in range(0, N, chunk):
        kc, vc = k[:, :, k0:k0 + chunk], v[:, :, k0:k0 + chunk]
        s = torch.matmul(q * c, kc.transpose(-1, -2))
        dp = torch.matmul(do, vc.transpose(-1, -2))
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - mx)
        p = torch.exp2(s - mx)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.matmul(p * (dp - delta), kc)
        m = mx
    dq = acc * (scale / l)
    lse = (m + torch.log2(l)).transpose(-1, -2)              # (B, H, 1, N)
    p = torch.exp2(torch.matmul(k * c, q.transpose(-1, -2)) - lse)
    ds = p * (torch.matmul(v, do.transpose(-1, -2)) - delta.transpose(-1, -2))
    dv = torch.matmul(p, do)
    dk = scale * torch.matmul(ds, q)
    dqkv = torch.cat([t.transpose(1, 2).reshape(B * N, D)
                      for t in (dq, dk, dv)], dim=1)
    return attention.head_ln_bwd_plain(raw, dqkv, gq, gk, H, eps)


def step_inputs(B: int, N: int, H: int, dtype, seed: int = 0):
    """The attention step's arguments at (B, N, H): q̂ and k̂ from a
    per-head LayerNorm of γ ≈ 2.2 (peaked attention, as chip_smoke.py's
    block check), O the step's output, dO and the raw q | k seeded."""
    rng = np.random.default_rng(seed)
    M, D = B * N, 64 * H
    f = lambda *s, std=1.0: torch.from_numpy(std * rng.standard_normal(s)) \
        .to(dtype)
    raw = f(M, 2 * D) + 0.3
    gq, gk, bq, bk = 2.2 + f(64, std=.1), 2.2 + f(64, std=.1), \
        f(64, std=.1), f(64, std=.1)
    x = raw.reshape(M, 2, H, 64)
    xh = (x - x.mean(-1, keepdim=True)) * torch.rsqrt(
        x.var(-1, unbiased=False, keepdim=True) + 1e-5)
    q = (xh[:, 0] * gq + bq).reshape(M, D)
    k = (xh[:, 1] * gk + bk).reshape(M, D)
    v = f(M, D)
    heads = lambda t: t.reshape(B, N, H, 64).transpose(1, 2)
    o = torch.softmax(torch.matmul(heads(q), heads(k).transpose(-1, -2))
                      * 0.125, -1) @ heads(v)
    attn = o.transpose(1, 2).reshape(M, D)
    return (torch.cat([q, k, v], 1), attn, f(M, D), raw, gq, gk, B, N, H,
            0.125, 1e-5)


#: (B, N, H, dtype, seed, rel, rms_frac): exact in float64 (1e-9 of each
#: part's RMS); in float32 within chip_smoke.py's fp32 tolerance (rtol
#: 1e-4 + 1e-4 of the RMS) at a ragged N and a head shard's 8 heads.
MODEL_CASES = [(2, 77, 2, torch.float64, 0, 0.0, 1e-9),
               (1, 64, 1, torch.float64, 0, 0.0, 1e-9),
               (1, 33, 3, torch.float64, 0, 0.0, 1e-9),
               (2, 1, 1, torch.float64, 0, 0.0, 1e-9),
               (2, 77, 8, torch.float32, 1, 1e-4, 1e-4)]


@pytest.mark.parametrize("B, N, H, dtype, seed, rel, rms_frac", MODEL_CASES)
def test_log2_unit_reformulation_is_the_plain_backward(B, N, H, dtype, seed,
                                                       rel, rms_frac):
    """The invariant the kernels are built on: one pass over ragged 32-key
    chunks with m and ℓ online (the dq̂ sum rescaled by 2^(m_old − m_new)
    as ℓ is), and P recomputed from that pass's m + log2 ℓ in log2 units
    (q̂ or k̂ scaled by scale·log2 e), give the plain backward's dq | dk |
    dv and dγ/dβ.  Exact in float64; in float32 within the card's fp32
    tolerance, so the reformulation leaves that tolerance to the
    products' rounding.  dβk's scale is dγk's RMS (chip_smoke.grad_errs)."""
    args = step_inputs(B, N, H, dtype, seed=seed)
    got, gln = kernels_model(*args)
    want, wln = attention.eva_attn_block_bwd_plain(*args)
    D = 64 * H
    parts = [(got[:, i * D:(i + 1) * D], want[:, i * D:(i + 1) * D], None)
             for i in range(3)]
    parts += [(gln[i], wln[i], wln[2] if i == 3 else None) for i in range(4)]
    for g, w, scale in parts:
        ref = w if scale is None else scale
        atol = rms_frac * max(ref.pow(2).mean().sqrt().item(), 1e-300)
        assert ((g - w).abs() <= atol + rel * w.abs() + 1e-12).all()


def block_args(B: int, N: int, D: int, H: int, seed: int):
    """The fp32 block's twelve arguments at (B, N, D) with H 64-wide heads,
    requiring grad: a head shard's (q/k/v (64H, D), out projection (D,
    64H), no `bo`) when 64H < D; peaked attention (LayerNorm γ ≈ 2.2)."""
    rng = np.random.default_rng(seed)
    Dh = 64 * H
    f = lambda *s, std=1.0: torch.from_numpy(          # noqa: E731
        std * rng.standard_normal(s)).float().requires_grad_(True)
    ln = lambda: [f(64, std=0.1).detach().add(2.2).requires_grad_(True),
                  f(64, std=0.1)]
    return [f(B, N, D), f(Dh, D, std=D ** -0.5), f(Dh, std=0.02),
            f(Dh, D, std=D ** -0.5), f(Dh, D, std=D ** -0.5),
            f(Dh, std=0.02), *ln(), *ln(), f(D, Dh, std=Dh ** -0.5),
            f(D, std=0.02) if Dh == D else None]


@pytest.mark.parametrize("B, N, D, H", [(2, 77, 128, 2), (1, 33, 192, 3),
                                        (2, 65, 256, 2), (1, 64, 128, 1)])
def test_autograd_entry_at_64_wide_heads_matches_plain_autograd(B, N, D, H):
    """`eva_attn_block` under grad on the CPU (`EvaAttnBlockFunction`, its
    backward the plain step that the card's kernels are held to) against
    autograd through `eva_attn_block_plain`, at the kernels' 64-wide
    heads: a ragged N across a 64-row tile, head shards (64H < D, no
    `bo`, the fp32 partial sum), one whole tile.  Each gradient within rtol
    1e-4 + 1e-5 of its RMS (dβk's scale dγk's RMS)."""
    args = block_args(B, N, D, H, seed=B * N + H)
    live = [a for a in args if a is not None]
    dy = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (B, N, D))).float()
    out = attention.eva_attn_block(*args, num_heads=H)
    assert type(out.grad_fn).__name__.startswith("EvaAttnBlockFunction")
    got = torch.autograd.grad(out, live, dy)
    want = torch.autograd.grad(
        attention.eva_attn_block_plain(*args, num_heads=H), live, dy)
    for i, (g, w) in enumerate(zip(got, want)):
        ref = want[8] if i == 9 else w                      # dβk: dγk's
        atol = 1e-5 * ref.pow(2).mean().sqrt().item()
        torch.testing.assert_close(g, w, rtol=1e-4, atol=atol)


def test_bwd_wrapper_rejects_cpu_tensors_before_building():
    """On CPU tensors `eva_attn_block_bwd_cuda` raises before it builds:
    it never falls back to the plain version."""
    args = step_inputs(1, 5, 1, torch.float32)
    calls = attention.eva_attn_block_bwd_plain.calls
    with pytest.raises(ValueError, match="CUDA tensor"):
        attention.eva_attn_block_bwd_cuda(*args)
    assert attention.eva_attn_block_bwd_plain.calls == calls
    assert build.load.cache_info().currsize == 0
