"""The port's kernel modules (uni_adapter_torch/ops) against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

On a CPU tensor each port wrapper runs its kernel's plain PyTorch version,
so these tests hold the plain versions to the Pallas contracts; the CUDA
kernels are held to the plain versions on the card by chip_smoke.py.
Inputs are made from numpy seeds and fed to both packages.
"""
import functools
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uni_adapter_tpu.ops.attention_pallas as attention_pallas
import uni_adapter_tpu.ops.ballquery_pallas as ballquery_pallas
import uni_adapter_tpu.ops.fps_pallas as fps_pallas
import uni_adapter_tpu.ops.knn_pallas as knn_pallas
from uni_adapter_tpu.ops import geometry as jax_geometry
from uni_adapter_torch.ops import (attention, attention_fp32,
                                   attention_heads, ballquery, build,
                                   eva_attention, fps, geometry, knn,
                                   knn_gather)
from torch_threads import one_torch_thread  # noqa: F401


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


def _tie_cloud(kind):
    """(1, N, 3) clouds on which FPS meets exact ties every round."""
    if kind == "every point twice":
        base = _rand((1, 64, 3), seed=5)
        return np.concatenate([base, base], axis=1)
    if kind == "every point equal":
        return np.repeat(_rand((1, 1, 3), seed=6), 128, axis=1)
    g = np.arange(5, dtype=np.float32)          # a 5³ lattice, exact in fp32
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(
        1, 125, 3) / 16


@pytest.mark.parametrize("npoint", [16, 64])
@pytest.mark.parametrize("kind", ["every point twice", "every point equal",
                                  "lattice"])
def test_fps_ties_match_both_pallas_kernels(kind, npoint):
    """On exact ties the plain version (the CUDA kernels' reference) takes
    the lowest index, as both Pallas kernels do: exact index equality."""
    pts = _tie_cloud(kind)
    got = fps.farthest_point_sample(torch.from_numpy(pts), npoint).numpy()
    for pallas in (fps_pallas.fps_pallas_batched, fps_pallas.fps_pallas):
        want = np.asarray(pallas(jnp.asarray(pts), npoint, interpret=True))
        np.testing.assert_array_equal(got, want)


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


def _uniform(shape, seed):
    return np.random.default_rng(seed).uniform(-0.5, 0.5, shape).astype(
        np.float32)


@pytest.mark.parametrize("B,S,N,k,r", [
    (2, 16, 128, 8, 0.3),      # the four cases of test_ballquery_pallas.py
    (3, 40, 256, 8, 0.25),
    (2, 16, 200, 8, 0.3),
    (2, 16, 128, 8, 0.02),     # mostly empty balls (clamped to N-1)
])
def test_query_ball_matches_pallas_kernel(B, S, N, k, r):
    """Exact index equality (tolerance 0)."""
    xyz = _uniform((B, N, 3), seed=B * N)
    q = _uniform((B, S, 3), seed=B * N + 1)
    want = np.asarray(ballquery_pallas.query_ball_pallas(
        r, k, jnp.asarray(xyz), jnp.asarray(q), interpret=True))
    got = ballquery.query_ball(r, k, torch.from_numpy(xyz),
                               torch.from_numpy(q))
    assert got.dtype == torch.int64 and got.shape == (B, S, k)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["over-full", "empty"])
def test_query_ball_full_and_empty_balls_match_pallas_kernel(case):
    """An over-full ball keeps the first nsample indices by index; an
    empty one gives N-1 in every slot."""
    xyz = _uniform((1, 64, 3), seed=5)
    if case == "over-full":
        xyz, q, r = xyz * 0.05, np.zeros((1, 4, 3), np.float32), 0.5
        expect = np.broadcast_to(np.arange(8), (1, 4, 8))
    else:
        q, r = _uniform((1, 4, 3), seed=6) + 5.0, 0.1
        expect = np.full((1, 4, 8), 63)
    want = np.asarray(ballquery_pallas.query_ball_pallas(
        r, 8, jnp.asarray(xyz), jnp.asarray(q), interpret=True))
    got = ballquery.query_ball(r, 8, torch.from_numpy(xyz),
                               torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, expect)


def _qkv_slices(B, N, D, seed):
    """q, k, v as the three column slices of one (B, N, 3D) tensor, as
    ViTAttention hands them over, plus per-head LayerNorm parameters."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, N, 3 * D)).astype(np.float32)
    hd = 64
    ln = [1.0 + 0.1 * rng.standard_normal(hd).astype(np.float32),
          0.1 * rng.standard_normal(hd).astype(np.float32),
          1.0 + 0.1 * rng.standard_normal(hd).astype(np.float32),
          0.1 * rng.standard_normal(hd).astype(np.float32)]
    return qkv, ln


@pytest.mark.parametrize("dtype,tol", [
    # fp32: the same arithmetic in another summation order
    ("float32", 1e-5),
    # bf16: a last-bit difference can flip a bf16 rounding of p
    ("bfloat16", 2e-2),
])
@pytest.mark.parametrize("with_ln", [False, True], ids=["no-ln", "ln"])
# off the 64-key chunk; and the card's attention core at its edges (one
# key, one whole chunk, a last chunk of one key after 32 full ones)
@pytest.mark.parametrize("N", [37, 65, 1, 64, 2049])
def test_eva_attention_matches_pallas_kernel(N, with_ln, dtype, tol):
    B, D, H = 2, 128, 2
    qkv, ln = _qkv_slices(B, N, D, seed=N + 7 * with_ln)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq = jnp.asarray(qkv).astype(jdt)
    jln = [jnp.asarray(p) for p in ln] if with_ln else []
    want = attention_pallas.eva_attention_fused(
        jq[..., :D], jq[..., D:2 * D], jq[..., 2 * D:], *jln, num_heads=H,
        interpret=True)
    tq = torch.from_numpy(qkv).to(tdt)
    tln = [torch.from_numpy(p) for p in ln] if with_ln else []
    got = eva_attention.eva_attention_fused(
        tq[..., :D], tq[..., D:2 * D], tq[..., 2 * D:], *tln, num_heads=H)
    assert got.dtype == tdt and got.shape == (B, N, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


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


# fp32: the same arithmetic in another summation order.  bf16: a last-bit
# difference upstream can flip a bf16 rounding; the tolerance
# tests/test_attention_pallas.py allows the Pallas kernel.  Beside
# (2, 37, 128, 4), the edges the card's GEMMs are checked at: one token
# and one head, and 65 tokens at ULIP-2's width (a ragged tile, 6 heads).
_BLOCK_CASES = [
    pytest.param(dtype, tol, shape,
                 id=f"{dtype}-{tol}" + ("" if shape == (2, 37, 128, 4) else
                                        "-" + "x".join(map(str, shape))))
    for shape in ((2, 37, 128, 4), (1, 1, 64, 1), (1, 65, 384, 6))
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 2e-2))]


@pytest.mark.parametrize("dtype,tol,shape", _BLOCK_CASES)
def test_eva_attn_block_matches_pallas_kernel(dtype, tol, shape):
    B, N, D, H = shape
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
                      (ballquery_pallas, "query_ball_pallas"),
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


def test_group_points_without_color_matches_jax_kernel_branches(
        pallas_interpret):
    """ULIP-2's grouping: same centres and neighbourhoods, no features."""
    xyz = _rand((2, 128, 3), seed=13)
    want = jax_geometry.group_points(jnp.asarray(xyz), None, 16, 8,
                                     use_pallas_fps=True, use_pallas_knn=True)
    got = geometry.group_points(torch.from_numpy(xyz), None, 16, 8)
    assert got[2] is None and want[2] is None
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_sample_and_group_matches_jax_kernel_branches(pallas_interpret):
    """OpenShape's set-abstraction grouping (FPS kernel, ball-query kernel,
    exact gather): same centres and grouped points, exactly."""
    xyz = _uniform((2, 128, 3), seed=21)
    pts = np.concatenate([xyz, _uniform((2, 128, 3), seed=22)], -1)
    want = jax_geometry.sample_and_group(
        16, 0.3, 8, jnp.asarray(xyz), jnp.asarray(pts), use_pallas_fps=True,
        use_pallas_ballq=True)
    got = geometry.sample_and_group(16, 0.3, 8, torch.from_numpy(xyz),
                                    torch.from_numpy(pts))
    assert got[1].shape == (2, 16, 8, 9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _cpu_block_call():
    w = lambda *shape: torch.zeros(*shape, dtype=torch.bfloat16)
    return attention.eva_attn_block_cuda(
        w(1, 5, 64), w(64, 64), w(64), w(64, 64), w(64, 64), w(64),
        *(torch.ones(64),) * 4, w(64, 64), w(64), num_heads=1)


def _cpu_block_fp32_call():
    w = lambda *shape: torch.zeros(*shape)
    return attention.eva_attn_block_fp32_cuda(
        w(1, 5, 64), w(64, 64), w(64), w(64, 64), w(64, 64), w(64),
        *(torch.ones(64),) * 4, w(64, 64), w(64), num_heads=1)


@pytest.mark.parametrize("call", [
    lambda: fps.fps_cuda(torch.zeros(1, 8, 3), 4),
    lambda: knn.knn_cuda(2, torch.zeros(1, 8, 3), torch.zeros(1, 4, 3)),
    _cpu_block_call,
    lambda: ballquery.query_ball_cuda(0.2, 2, torch.zeros(1, 8, 3),
                                      torch.zeros(1, 4, 3)),
    lambda: eva_attention.eva_attention_cuda(
        *(torch.zeros(1, 5, 64, dtype=torch.bfloat16),) * 3, num_heads=1),
    lambda: attention_heads.attention_heads_cuda(
        *(torch.zeros(1, 2, 5, 64, dtype=torch.bfloat16),) * 3),
    lambda: knn_gather.knn_gather_cuda(2, torch.zeros(1, 8, 3),
                                       torch.zeros(1, 4, 3),
                                       torch.zeros(1, 8, 6)),
    lambda: fps.fps_grid_cuda(torch.zeros(1, 8, 3), 4),
    lambda: attention_fp32.attention_fp32_cuda(
        *(torch.zeros(1, 2, 5, 64),) * 3),
    lambda: eva_attention.eva_attention_fp32_cuda(
        *(torch.zeros(1, 5, 64),) * 3, num_heads=1),
    _cpu_block_fp32_call,
], ids=["fps", "knn", "eva_attn_block", "ballquery", "eva_attention",
        "attention_heads", "knn_gather", "fps_grid", "attention_fp32",
        "eva_attention_fp32", "eva_attn_block_fp32"])
def test_kernel_wrappers_reject_cpu_tensors_before_building(call):
    """A kernel wrapper checks its inputs before it builds or launches:
    CPU tensors raise, and nothing is compiled."""
    from uni_adapter_torch.ops import build
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()
    assert build.load.cache_info().currsize == 0


def _global_kernels() -> set:
    """Every __global__ function name in uni_adapter_torch/csrc: the last
    identifier called before the body (after any __launch_bounds__)."""
    names = set()
    for path in sorted(build.CSRC.glob("*.cu*")):
        text = path.read_text()
        for m in re.finditer(r"__global__", text):
            head = text[m.end():text.index("{", m.end())]
            names.add(re.findall(r"(\w+)\s*\(", head)[-1])
    return names


def test_step_profile_groups_every_port_kernel():
    """scripts/torch_step_profile.py files every kernel of the port under
    its own group (a text check: a renamed kernel whose name holds "gemm"
    would otherwise count as a library GEMM)."""
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "torch_step_profile.py"
    spec = importlib.util.spec_from_file_location("torch_step_profile", path)
    profile = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(profile)
    kernels = _global_kernels()
    assert {"gemm_bf16_kernel", "gemm_f32_kernel", "attn_kernel",
            "attn_f32_kernel", "fps_kernel"} <= kernels
    for name in sorted(kernels):
        # as the profiler names a templated kernel in an anonymous namespace
        group = profile.group_of(f"void (anonymous namespace)::{name}<2, 128>"
                                 f"((anonymous namespace)::Args)")
        assert name in profile.PORT_GROUPS.get(group, ()), (name, group)
