"""Clouds above the register limits of the port's kNN (2048 points) and FPS
(4096) kernels, on the CPU, against the JAX package: `knn_gather` against
`knn_gather_pallas`, `fps_plain` against `fps_pallas`, `group_points`
against both of the JAX package's kNN routes, and small fp32 Uni3D and
Point-BERT models on 2500-point clouds, where the port's grouping takes
the `knn_gather` route.

The JAX side runs its Pallas kernels in interpret mode; the port runs the
kernels' plain versions (CPU tensors).  Clouds are random normal, so no
two distances tie, except in the test that plants ties.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uni_adapter_tpu.ops.attention_pallas as attention_pallas
import uni_adapter_tpu.ops.fps_pallas as fps_pallas
import uni_adapter_tpu.ops.knn_pallas as knn_pallas
from uni_adapter_tpu.config import ModelConfig as JaxModelConfig
from uni_adapter_tpu.models.pointbert import create_ulip as jax_create_ulip
from uni_adapter_tpu.models.uni3d import create_uni3d as jax_create_uni3d
from uni_adapter_tpu.ops import geometry as jax_geometry
from uni_adapter_torch.config import ModelConfig
from uni_adapter_torch.models.pointbert import create_ulip
from uni_adapter_torch.models.uni3d import create_uni3d
from uni_adapter_torch.ops import fps, geometry, knn, knn_gather
from uni_adapter_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX package's kernel branches in interpret mode."""
    for mod, name in ((fps_pallas, "fps_pallas_batched"),
                      (knn_pallas, "knn_pallas"),
                      (knn_pallas, "knn_gather_pallas"),
                      (attention_pallas, "eva_attn_block_fused"),
                      (attention_pallas, "eva_attention_fused")):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), interpret=True))


@pytest.mark.parametrize("B,S,N,k,C", [
    (2, 16, 128, 4, 6),        # the three shapes of test_knn_pallas.py
    (3, 40, 200, 8, 6),
    (2, 16, 128, 4, 3),
    (1, 24, 2500, 16, 6),      # above knn.MAX_POINTS: one tile and a part
    (2, 16, 2200, 32, 3),
])
def test_knn_gather_matches_pallas_kernel(B, S, N, k, C):
    """Indices equal and gathered values bitwise equal (tolerance 0)."""
    xyz = _rand((B, N, 3), seed=B * N + k)
    q = _rand((B, S, 3), seed=B * N + k + 1)
    vals = _rand((B, N, C), seed=B * N + k + 2)
    want_idx, want = knn_pallas.knn_gather_pallas(
        k, jnp.asarray(xyz), jnp.asarray(q), jnp.asarray(vals),
        interpret=True)
    idx, got = knn_gather.knn_gather(k, torch.from_numpy(xyz),
                                     torch.from_numpy(q),
                                     torch.from_numpy(vals))
    assert idx.dtype == torch.int64 and idx.shape == (B, S, k)
    assert got.dtype == torch.float32 and got.shape == (B, S, k, C)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("N", [200, 2500])
def test_knn_gather_without_values_is_knn(N):
    """C = 0 (values None): the indices of `knn_plain`, nothing gathered;
    `knn.knn` gives the same at any N."""
    xyz = torch.from_numpy(_rand((2, N, 3), seed=N))
    q = torch.from_numpy(_rand((2, 12, 3), seed=N + 1))
    idx, got = knn_gather.knn_gather(16, xyz, q)
    assert got.shape == (2, 12, 16, 0)
    assert torch.equal(idx, knn.knn_plain(16, xyz, q))
    assert torch.equal(knn.knn(16, xyz, q), idx)


def test_knn_gather_ties_go_to_the_lowest_index():
    """Every point of a 2100-point cloud repeated once (so the copies lie
    on both sides of a 2048-point tile edge): equal distances resolve to
    the lower index, and the gathered values are the lower copy's."""
    base = _rand((1, 1050, 3), seed=4)
    xyz = np.concatenate([base, base], axis=1)
    vals = np.arange(2100, dtype=np.float32).reshape(1, 2100, 1)
    q = base[:, ::70].copy()
    idx, got = knn_gather.knn_gather(4, torch.from_numpy(xyz),
                                     torch.from_numpy(q),
                                     torch.from_numpy(vals))
    first = np.arange(0, 1050, 70)
    np.testing.assert_array_equal(idx[0, :, :2].numpy(),
                                  np.stack([first, first + 1050], 1))
    np.testing.assert_array_equal(got[..., 0].numpy(), idx.numpy())


@pytest.mark.parametrize("B,N,npoint", [(1, 9000, 32), (2, 200, 32)])
def test_fps_matches_the_grid_pallas_kernel(B, N, npoint):
    """`fps_pallas` (the per-cloud grid kernel) computes the function of
    `fps_plain`: exact indices, also above fps.MAX_POINTS."""
    pts = _rand((B, N, 3), seed=N + npoint)
    want = np.asarray(fps_pallas.fps_pallas(jnp.asarray(pts), npoint,
                                            interpret=True))
    got = fps.farthest_point_sample(torch.from_numpy(pts), npoint)
    assert got.dtype == torch.int64 and got.shape == (B, npoint)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B,N,npoint", [(1, 1, 1), (2, 40, 40)],
                         ids=["one point", "npoint = N"])
def test_fps_edge_sizes_match_both_pallas_kernels(B, N, npoint):
    """A one-point cloud and npoint = N (the last round takes the last
    unvisited point): exact indices against both Pallas kernels."""
    pts = _rand((B, N, 3), seed=N + 7)
    got = fps.farthest_point_sample(torch.from_numpy(pts), npoint).numpy()
    for pallas in (fps_pallas.fps_pallas_batched, fps_pallas.fps_pallas):
        want = np.asarray(pallas(jnp.asarray(pts), npoint, interpret=True))
        np.testing.assert_array_equal(got, want)
    assert sorted(got[0]) == list(range(N))


@pytest.mark.parametrize("with_color", [True, False],
                         ids=["uni3d", "pointbert"])
def test_group_points_above_the_knn_limit_matches_both_jax_routes(
        pallas_interpret, with_color):
    """At N = 2500 the port takes one `knn_gather`; its neighbourhoods,
    centres and features equal, bitwise, JAX's fused route
    (`use_pallas_knn_gather`) and its kNN + gather route
    (`use_pallas_knn`)."""
    N = 2500
    xyz = _rand((2, N, 3), seed=21)
    color = np.random.default_rng(22).uniform(size=(2, N, 3)).astype(
        np.float32) if with_color else None
    got = geometry.group_points(
        torch.from_numpy(xyz),
        None if color is None else torch.from_numpy(color), 16, 8)
    jcolor = None if color is None else jnp.asarray(color)
    for route in ("use_pallas_knn_gather", "use_pallas_knn"):
        want = jax_geometry.group_points(jnp.asarray(xyz), jcolor, 16, 8,
                                         use_pallas_fps=True, **{route: True})
        for g, w in zip(got, want):
            if w is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=route)


SMALL_UNI3D = dict(pc_feat_dim=64, embed_dim=32, num_group=16, group_size=8,
                   pc_encoder_dim=32, eva_depth=2, eva_heads=4,
                   compute_dtype="float32")
SMALL_ULIP = dict(ulip_trans_dim=64, ulip_depth=2, ulip_heads=4,
                  num_group=16, ulip_group_size=8, ulip_encoder_dim=32,
                  ulip_embed_dim=32, compute_dtype="float32")


def _perturbed(model, *example):
    """flax init, then every leaf moved off its init value."""
    params = jax.jit(model.init)(jax.random.PRNGKey(0), *example)
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        .astype(np.float32), params)


@pytest.mark.parametrize("kind", ["uni3d", "ulip"])
def test_small_models_on_2500_point_clouds_match_jax(pallas_interpret, kind):
    """fp32, depth 2, width 64, on 2500-point clouds, against the JAX
    models on their fused kNN + gather route: features within 1e-4, the
    tolerance of tests/test_torch_model.py (the same arithmetic summed in
    other orders; the grouping is exact)."""
    rng = np.random.default_rng(7)
    xyz = rng.standard_normal((2, 2500, 3)).astype(np.float32)
    if kind == "uni3d":
        pc = np.concatenate(
            [xyz, rng.uniform(size=(2, 2500, 3)).astype(np.float32)], -1)
        model = jax_create_uni3d(JaxModelConfig(
            use_pallas_fps=True, use_pallas_knn_gather=True,
            use_pallas_attn_block=True, **SMALL_UNI3D))
        port_fn = create_uni3d
        port_cfg = SMALL_UNI3D
    else:
        pc = xyz
        model = jax_create_ulip(JaxModelConfig(
            use_pallas_fps=True, use_pallas_knn_gather=True,
            use_pallas_attention=True, **SMALL_ULIP))
        port_fn = create_ulip
        port_cfg = SMALL_ULIP
    # the weights do not depend on N: init traces a 128-point cloud
    params = _perturbed(model, jnp.asarray(pc[:, :128]))
    want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(pc)))
    port = port_fn(ModelConfig(**port_cfg), "cpu",
                   state_dict=from_jax_params(params))
    with torch.no_grad():
        got = port(torch.from_numpy(pc))
    assert got.dtype == torch.float32 and got.shape == (2, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
