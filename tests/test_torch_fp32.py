"""The port's fp32 attention (uni_adapter_torch/ops/attention_fp32.py, the
port of `attention_pallas`) against the JAX package's Pallas kernels in
interpret mode, and the dtype dispatch of the attention wrappers.

On the CPU the wrappers run their plain versions, so these tests hold the
plain versions to the Pallas contracts; the CUDA kernels are held to the
plain versions on the card by chip_smoke.py.  Inputs are made from numpy
seeds and fed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uni_adapter_tpu.ops.attention_pallas as attention_pallas
from uni_adapter_torch.ops import (attention, attention_fp32,
                                   attention_heads, build, eva_attention)
from torch_threads import one_torch_thread  # noqa: F401


#: q and k scaled by this give logits of std ≈ 5: peaked attention, as in
#: a trained model and in chip_smoke.py's kernel checks.
PEAKED = 2.2


def _qkv(shape, seed, gamma=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = rng.standard_normal((3, *shape)).astype(np.float32)
    return q * gamma, k * gamma, v


@pytest.mark.parametrize("B,H,N,hd,gamma", [
    (2, 3, 70, 32, 1.0),             # N and hd both unaligned
    (1, 2, 128, 64, 1.0),            # no padded key
    (1, 4, 37, 64, PEAKED),          # peaked logits, padded keys
])
def test_plain_matches_attention_pallas_fp32(B, H, N, hd, gamma):
    """fp32: the same arithmetic in another summation order, within
    rtol/atol 1e-5."""
    q, k, v = _qkv((B, H, N, hd), seed=N + hd, gamma=gamma)
    want = np.asarray(attention_pallas.attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    got = attention_fp32.attention_fp32(*map(torch.from_numpy, (q, k, v)))
    assert got.dtype == torch.float32 and got.shape == (B, H, N, hd)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_plain_matches_attention_pallas_bf16():
    """bf16 operands, as the Pallas function takes them: q and k cast to
    fp32, p rounded to bf16 before p·v.  A last-bit difference can flip a
    bf16 rounding of p: the bf16 tolerance of tests/test_torch_ops.py."""
    q, k, v = _qkv((2, 3, 70, 32), seed=3, gamma=PEAKED)
    want = attention_pallas.attention_pallas(
        *(jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)),
        interpret=True)
    got = attention_fp32.attention_fp32(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("B,H,N,hd", [(2, 3, 70, 32), (1, 2, 128, 64),
                                      (3, 4, 77, 16)])
def test_card_and_cpu_routes_of_attend_are_one_function_in_fp32(B, H, N, hd):
    """In fp32 `models.common.attend` runs `attention_fp32` on the card and
    `attention_heads_plain` on the CPU; both equal JAX
    `attention_pallas_heads` (the `_attend(use_pallas=True)` route) within
    1e-5."""
    q, k, v = _qkv((B, H, N, hd), seed=B * N + hd, gamma=PEAKED)
    want = np.asarray(attention_pallas.attention_pallas_heads(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for got in (attention_fp32.attention_fp32_plain(tq, tk, tv),
                attention_heads.attention_heads(tq, tk, tv)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("module,bf16,fp32", [
    (attention_heads, attention_heads.attention_heads_cuda,
     attention_fp32.attention_fp32_cuda),
    (eva_attention, eva_attention.eva_attention_cuda,
     eva_attention.eva_attention_fp32_cuda),
    (attention, attention.eva_attn_block_cuda,
     attention.eva_attn_block_fp32_cuda),
], ids=["attention_heads", "eva_attention", "eva_attn_block"])
def test_card_route_picks_the_kernel_by_dtype(module, bf16, fp32):
    """On the card a wrapper takes its bf16 kernel for bf16 tensors and its
    fp32 kernel for fp32; float16 has none and raises, naming the dtype,
    before anything is built."""
    assert module.cuda_kernel(torch.bfloat16) is bf16
    assert module.cuda_kernel(torch.float32) is fp32
    with pytest.raises(ValueError, match="float16"):
        module.cuda_kernel(torch.float16)
    assert build.load.cache_info().currsize == 0


def _round_tf32_rna(t):
    """fp32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero: `cvt.rna.tf32.f32`."""
    b = t.contiguous().view(torch.int32)
    return ((b + 0x1000) & -8192).view(torch.float32)


def _split(t):
    hi = _round_tf32_rna(t)
    return hi, _round_tf32_rna(t - hi)


def _mma_product(a, b, passes):
    """a @ b as `attn_f32_tc_kernel` forms it: 8-deep k-steps
    (mma.sync.m16n8k8) accumulated in fp32, each step the three TF32
    products lo·hi, hi·lo, hi·hi (passes=3, split TF32) or hi·hi alone
    (passes=1, operands rounded once to TF32)."""
    ah, al = _split(a)
    bh, bl = _split(b)
    terms = ((al, bh), (ah, bl), (ah, bh)) if passes == 3 else ((ah, bh),)
    out = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        for x, y in terms:
            out = out + x[..., k0:k0 + 8] @ y[..., k0:k0 + 8, :]
    return out


def _split_tf32_attention(q, k, v, passes, chunk=32):
    """A plain model of the kernel's arithmetic: q scaled by scale·log2(e),
    scores in log2 units, one pass over `chunk`-key chunks with a running
    maximum (p = 2^(s − m), the partial sums and outputs rescaled when m
    grows), both products as `_mma_product` makes them."""
    c = q.shape[-1] ** -0.5 * 1.4426950408889634
    s_all = _mma_product(q * c, k.transpose(-1, -2), passes)
    m = torch.full(q.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    o = torch.zeros_like(q)
    for k0 in range(0, k.shape[-2], chunk):
        s = s_all[..., k0:k0 + chunk]
        mx = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - mx)
        p = torch.exp2(s - mx)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + _mma_product(p, v[..., k0:k0 + chunk, :], passes)
        m = mx
    return o / l


#: The attention steps of the main paths at hd 64 with no q/k LayerNorm,
#: (B, H, N, hd): the fp32 block's (Uni3D-L, two fused clouds), row 9's
#: Uni3D-L extraction, and OpenShape-G's and ULIP-2's natural layout.
TC_SHAPES = {"block step": (2, 16, 513, 64), "row 9 uni3d": (1, 16, 513, 64),
             "row 4f openshape": (2, 8, 385, 64),
             "row 4f ulip": (2, 6, 513, 64)}


@pytest.mark.parametrize("shape", TC_SHAPES.values(), ids=TC_SHAPES.keys())
def test_split_tf32_arithmetic_keeps_the_fp32_tolerance(shape):
    """The split-TF32 design of `attn_f32_tc_kernel`, modelled in plain
    PyTorch, at peaked logits: within chip_smoke.py's fp32 tolerance of
    `attention_fp32_plain` (rtol 1e-4 + 1e-4 of the output's RMS), while
    one TF32 pass (operands rounded once, the fault the tolerance is there
    to catch) lies at least 5× outside it."""
    q, k, v = map(torch.from_numpy, _qkv(shape, seed=sum(shape),
                                         gamma=PEAKED))
    want = attention_fp32.attention_fp32_plain(q, k, v)
    tol = 1e-4 * want.pow(2).mean().sqrt() + 1e-4 * want.abs()

    def err(got):
        return ((got - want).abs() / tol).max().item()

    assert err(_split_tf32_attention(q, k, v, passes=3)) <= 1
    assert err(_split_tf32_attention(q, k, v, passes=1)) >= 5
