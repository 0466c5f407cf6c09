"""The port's kernel modules (uni_adapter_torch/ops) against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

On a CPU tensor each port wrapper runs its kernel's plain PyTorch version,
so these tests hold the plain versions to the Pallas contracts; the CUDA
kernels are held to the plain versions on the card by chip_smoke.py.
Inputs are made from numpy seeds and fed to both packages.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uni_adapter_tpu.ops.attention_pallas as attention_pallas
import uni_adapter_tpu.ops.fps_pallas as fps_pallas
import uni_adapter_tpu.ops.knn_pallas as knn_pallas
from uni_adapter_tpu.ops import geometry as jax_geometry
from uni_adapter_torch.ops import attention, fps, geometry, knn


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("B,N,npoint", [(2, 200, 32), (3, 128, 64)])
def test_fps_matches_pallas_kernel(B, N, npoint):
    """Exact index equality (tolerance 0) on random, tie-free clouds."""
    pts = _rand((B, N, 3), seed=N + npoint)
    want = np.asarray(fps_pallas.fps_pallas_batched(
        jnp.asarray(pts), npoint, interpret=True))
    got = fps.farthest_point_sample(torch.from_numpy(pts), npoint)
    assert got.dtype == torch.int64 and got.shape == (B, npoint)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B,S,N,k", [(2, 16, 128, 4), (3, 40, 200, 8)])
def test_knn_matches_pallas_kernel(B, S, N, k):
    """Exact index sequences (tolerance 0): ascending distance."""
    xyz = _rand((B, N, 3), seed=B * N + k)
    q = _rand((B, S, 3), seed=B * N + k + 1)
    want = np.asarray(knn_pallas.knn_pallas(k, jnp.asarray(xyz),
                                            jnp.asarray(q), interpret=True))
    got = knn.knn(k, torch.from_numpy(xyz), torch.from_numpy(q))
    assert got.dtype == torch.int64 and got.shape == (B, S, k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_knn_ties_go_to_the_lowest_index():
    """Every point duplicated: equal distances resolve to the lower index,
    as the Pallas kernel's masked iota-min does."""
    base = _rand((1, 8, 3), seed=3)
    xyz = np.concatenate([base, base], axis=1)
    want = np.asarray(knn_pallas.knn_pallas(
        3, jnp.asarray(xyz), jnp.asarray(base), interpret=True))
    got = knn.knn(3, torch.from_numpy(xyz), torch.from_numpy(base)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, :, :2],
                                  np.stack([np.arange(8), np.arange(8) + 8], 1))


def _block_inputs(B, N, D, H, seed):
    rng = np.random.default_rng(seed)
    hd = D // H
    w = [rng.standard_normal((D, D)).astype(np.float32) / np.sqrt(D)
         for _ in range(4)]                                   # flax (in, out)
    b = [0.1 * rng.standard_normal(D).astype(np.float32) for _ in range(3)]
    ln = [1.0 + 0.1 * rng.standard_normal(hd).astype(np.float32),
          0.1 * rng.standard_normal(hd).astype(np.float32),
          1.0 + 0.1 * rng.standard_normal(hd).astype(np.float32),
          0.1 * rng.standard_normal(hd).astype(np.float32)]
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    return x, w, b, ln


@pytest.mark.parametrize("dtype,tol", [
    # fp32: the same arithmetic in another summation order
    ("float32", 1e-5),
    # bf16: a last-bit difference upstream can flip a bf16 rounding; the
    # tolerance tests/test_attention_pallas.py allows the Pallas kernel
    ("bfloat16", 2e-2),
])
def test_eva_attn_block_matches_pallas_kernel(dtype, tol):
    B, N, D, H = 2, 37, 128, 4
    x, w, b, ln = _block_inputs(B, N, D, H, seed=5)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    want = attention_pallas.eva_attn_block_fused(
        jnp.asarray(x).astype(jdt), jnp.asarray(w[0]), jnp.asarray(b[0]),
        jnp.asarray(w[1]), jnp.asarray(w[2]), jnp.asarray(b[1]),
        *(jnp.asarray(p) for p in ln), jnp.asarray(w[3]), jnp.asarray(b[2]),
        num_heads=H, interpret=True)
    # the port stores dense weights in the compute dtype, (out, in)
    t = lambda a: torch.from_numpy(a).to(tdt)
    got = attention.eva_attn_block(
        t(x), t(w[0].T), t(b[0]), t(w[1].T), t(w[2].T), t(b[1]),
        *(torch.from_numpy(p) for p in ln), t(w[3].T), t(b[2]),
        num_heads=H)
    assert got.dtype == tdt and got.shape == (B, N, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_index_points_is_an_exact_gather():
    pts = torch.from_numpy(_rand((2, 50, 6), seed=1))
    idx = torch.randint(0, 50, (2, 7, 5), generator=torch.Generator()
                        .manual_seed(0))
    got = geometry.index_points(pts, idx)
    want = np.stack([pts[b].numpy()[idx[b].numpy()] for b in range(2)])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Route the JAX package's in-model kernel calls through interpret
    mode (the pattern of tests/test_knn_pallas.py)."""
    for mod, name in ((fps_pallas, "fps_pallas_batched"),
                      (knn_pallas, "knn_pallas"),
                      (attention_pallas, "eva_attn_block_fused")):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), interpret=True))


def test_group_points_matches_jax_kernel_branches(pallas_interpret):
    """Same centres, neighbourhoods and features, exactly."""
    xyz, color = _rand((2, 128, 3), seed=11), _rand((2, 128, 3), seed=12)
    want = jax_geometry.group_points(jnp.asarray(xyz), jnp.asarray(color),
                                     16, 8, use_pallas_fps=True,
                                     use_pallas_knn=True)
    got = geometry.group_points(torch.from_numpy(xyz),
                                torch.from_numpy(color), 16, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _cpu_block_call():
    w = lambda *shape: torch.zeros(*shape, dtype=torch.bfloat16)
    return attention.eva_attn_block_cuda(
        w(1, 5, 64), w(64, 64), w(64), w(64, 64), w(64, 64), w(64),
        *(torch.ones(64),) * 4, w(64, 64), w(64), num_heads=1)


@pytest.mark.parametrize("call", [
    lambda: fps.fps_cuda(torch.zeros(1, 8, 3), 4),
    lambda: knn.knn_cuda(2, torch.zeros(1, 8, 3), torch.zeros(1, 4, 3)),
    _cpu_block_call,
], ids=["fps", "knn", "eva_attn_block"])
def test_kernel_wrappers_reject_cpu_tensors_before_building(call):
    """A kernel wrapper checks its inputs before it builds or launches:
    CPU tensors raise, and nothing is compiled."""
    from uni_adapter_torch.ops import build
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()
    assert build.load.cache_info().currsize == 0
