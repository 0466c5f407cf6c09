"""The rest of OpenShape in the port against the JAX package on the CPU:
k-means (`utils/kmeans.py`), the attention bias and `RelPE`, the `local`
and `hierarchical` cache types, and the PointNet++ modules
(`ops/pointnet.py`), each on the same weights, in fp32 at small widths.

k-means draws its first seed's index from a PRNG key in JAX and from a
seeded CPU generator in the port; the tests hand the port JAX's index.  The
JAX side runs its kernel branches in interpret mode where it has them
(FPS, ball query, the unbiased natural-layout attention) and its XLA
twins elsewhere; the port runs the kernels' plain versions.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vit_backbones import (OUT, SMALL_PPTA, _cloud,
                                      jax_openshape, pallas_interpret,  # noqa: F401
                                      perturbed_params)
from uni_adapter_tpu.models import common as jcommon
from uni_adapter_tpu.models import ppta as jppta
from uni_adapter_tpu.ops import pointnet as jpointnet
from uni_adapter_tpu.utils import kmeans as jkmeans
from uni_adapter_torch import config as pcfg_mod
from uni_adapter_torch.models import common, ppta
from uni_adapter_torch.ops import pointnet
from uni_adapter_torch.utils import kmeans
from uni_adapter_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401


def jax_first(n: int) -> int:
    """The first seed's index JAX's `cluster_patches` draws (PRNGKey(1))."""
    return int(jax.random.randint(jax.random.PRNGKey(1), (), 0, n))


@pytest.mark.parametrize("n,d,k", [(40, 8, 5), (200, 16, 7)])
def test_kmeans_matches_jax(n, d, k):
    """Clustered features, JAX's first index injected: the assignment
    equal and the centres within 1e-5 (fp32 sums in other orders)."""
    rng = np.random.default_rng(n)
    means = rng.standard_normal((k, d)) * 3
    x = (means[rng.integers(0, k, n)]
         + rng.standard_normal((n, d))).astype(np.float32)
    key = jax.random.PRNGKey(1)
    jc, ja = jkmeans.kmeans(jnp.asarray(x), k, key)
    first = int(jax.random.randint(key, (), 0, n))
    pc, pa = kmeans.kmeans(torch.from_numpy(x), k, first=first)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    # the port's own first index: deterministic, and a valid clustering
    a = kmeans.cluster_patches(torch.from_numpy(x), k)
    torch.testing.assert_close(a, kmeans.cluster_patches(
        torch.from_numpy(x), k), rtol=0, atol=0)
    assert a.shape == (k, d) and torch.isfinite(a).all()


def test_cluster_patches_matches_jax():
    """(B, S, D) tokens cluster as one set of B·S, as in JAX."""
    rng = np.random.default_rng(3)
    tokens = rng.standard_normal((2, 16, 8)).astype(np.float32)
    want = np.asarray(jkmeans.cluster_patches(jnp.asarray(tokens), 5))
    got = kmeans.cluster_patches(torch.from_numpy(tokens), 5,
                                 first=jax_first(32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_vit_attention_with_bias_matches_jax(dtype, tol):
    """`ViTAttention` with a (B, 1, N, N) bias, output and maps
    (`return_attn`) against JAX's on the same weights: within 1e-5 in fp32
    and 2e-2 in bf16 (bf16-stored logits and probabilities, rounded at
    other points of other sums)."""
    rng = np.random.default_rng(0)
    B, N, dim, heads, inner = 2, 9, 32, 2, 32
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    x = rng.standard_normal((B, N, dim)).astype(np.float32)
    bias = rng.standard_normal((B, 1, N, N)).astype(np.float32)
    jm = jcommon.ViTAttention(dim, heads, inner_dim=inner, dtype=jd)
    params = perturbed_params(jm, jnp.asarray(x, jd))
    want, wmaps = jm.apply(params, jnp.asarray(x, jd),
                           attn_bias=jnp.asarray(bias), return_attn=True)
    pm = common.ViTAttention(dim, heads, inner_dim=inner)
    pm.load_state_dict(from_jax_params(params))
    pm = pm.to(td)
    with torch.no_grad():
        got, maps = pm(torch.from_numpy(x).to(td),
                       attn_bias=torch.from_numpy(bias), return_attn=True)
        plain = pm(torch.from_numpy(x).to(td), attn_bias=torch.from_numpy(
            bias))
    assert got.dtype == td and maps.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(maps.numpy(), np.asarray(wmaps), atol=tol)
    assert torch.equal(plain, got)


def test_relpe_matches_jax():
    rng = np.random.default_rng(1)
    delta = rng.standard_normal((2, 5, 5, 3)).astype(np.float32)
    jm = jppta.RelPE(dtype=jnp.float32)
    params = perturbed_params(jm, jnp.asarray(delta))
    want = np.asarray(jm.apply(params, jnp.asarray(delta)))
    pm = ppta.RelPE(torch.float32)
    pm.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        got = pm(torch.from_numpy(delta))
    assert got.shape == (2, 1, 5, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cache_type,rel_pe", [
    ("global", True), ("local", False), ("hierarchical", True)])
def test_openshape_cache_types_and_rel_pe_match_jax(pallas_interpret,  # noqa: F811
                                                    monkeypatch, cache_type,
                                                    rel_pe):
    """OpenShape at width 64, 2 layers, fp32, on the same weights: the
    projected CLS token and the projected k-means centres of the 2·16
    patch tokens (JAX's first index injected) within 1e-4, as the global
    path's features are held."""
    preset = jppta.PPTAPreset(**SMALL_PPTA)
    jm = dataclasses.replace(jax_openshape(preset), cache_type=cache_type,
                             rel_pe=rel_pe)
    xyz, rgb = _cloud(2, 128, seed=4)
    feats = np.concatenate([xyz, rgb], -1)
    params = perturbed_params(jm, jnp.asarray(xyz), jnp.asarray(feats))
    want = jm.apply(params, jnp.asarray(xyz), jnp.asarray(feats))
    port = ppta.create_openshape(
        pcfg_mod.ModelConfig(compute_dtype="float32", oshape_clip_dim=OUT),
        "cpu", preset=ppta.PPTAPreset(**SMALL_PPTA),
        state_dict=from_jax_params(params), cache_type=cache_type,
        rel_pe=rel_pe)
    monkeypatch.setattr(kmeans, "cluster_patches", functools.partial(
        kmeans.cluster_patches, first=jax_first(2 * SMALL_PPTA["patches"])))
    with torch.no_grad():
        got = port(torch.from_numpy(xyz), torch.from_numpy(feats))
    got, want = ((got,), (want,)) if cache_type != "hierarchical" else (
        got, want)
    shapes = {"global": [(2, OUT)], "local": [(5, OUT)],
              "hierarchical": [(2, OUT), (5, OUT)]}[cache_type]
    assert [tuple(g.shape) for g in got] == shapes
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    if cache_type != "global":
        with pytest.raises(ValueError, match="global"):
            port(torch.from_numpy(xyz), torch.from_numpy(feats),
                 return_attn=True)


@pytest.mark.parametrize("with_points", [True, False])
def test_pointnet_set_abstraction_msg_matches_jax(with_points):
    """Two scales on 2 × 64 points (JAX's XLA twins: FPS, ball query): the
    centres equal, the joined features within 1e-5."""
    rng = np.random.default_rng(0)
    xyz = rng.standard_normal((2, 64, 3)).astype(np.float32)
    pts = (rng.standard_normal((2, 64, 5)).astype(np.float32)
           if with_points else None)
    jm = jpointnet.PointNetSetAbstractionMsg(
        npoint=16, radius_list=[0.6, 1.2], nsample_list=[8, 16],
        mlp_list=[[16, 24], [16, 32]])
    args = (jnp.asarray(xyz), None if pts is None else jnp.asarray(pts))
    params = perturbed_params(jm, *args)
    wxyz, wfeat = jm.apply(params, *args)
    pm = pointnet.PointNetSetAbstractionMsg(
        16, [0.6, 1.2], [8, 16], 5 if with_points else 0,
        [[16, 24], [16, 32]])
    pm.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        gxyz, gfeat = pm(torch.from_numpy(xyz),
                         None if pts is None else torch.from_numpy(pts))
    np.testing.assert_array_equal(gxyz.numpy(), np.asarray(wxyz))
    assert gfeat.shape == (2, 16, 24 + 32)
    np.testing.assert_allclose(gfeat.numpy(), np.asarray(wfeat), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n_coarse,skip", [(16, False), (16, True),
                                           (1, True)])
def test_pointnet_feature_propagation_matches_jax(n_coarse, skip):
    """3-NN inverse-distance interpolation (one coarse point: broadcast),
    with and without the skip features: within 1e-5."""
    rng = np.random.default_rng(1)
    xyz = rng.standard_normal((2, 64, 3)).astype(np.float32)
    coarse = xyz[:, :n_coarse]
    cfeat = rng.standard_normal((2, n_coarse, 12)).astype(np.float32)
    sk = rng.standard_normal((2, 64, 6)).astype(np.float32) if skip else None
    jm = jpointnet.PointNetFeaturePropagation(mlp=[20, 24])
    args = (jnp.asarray(xyz), jnp.asarray(coarse),
            None if sk is None else jnp.asarray(sk), jnp.asarray(cfeat))
    params = perturbed_params(jm, *args)
    want = np.asarray(jm.apply(params, *args))
    pm = pointnet.PointNetFeaturePropagation(12 + (6 if skip else 0),
                                             [20, 24])
    pm.load_state_dict(from_jax_params(params))
    with torch.no_grad():
        got = pm(torch.from_numpy(xyz), torch.from_numpy(coarse),
                 None if sk is None else torch.from_numpy(sk),
                 torch.from_numpy(cfeat))
    assert got.shape == (2, 64, 24)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_geometry_twins_match_jax():
    """`square_distance` within 1e-6, `knn_point` (ties to the lower
    index) and `query_ball_point` indices equal to the XLA twins'."""
    from uni_adapter_tpu.ops import geometry as jgeo
    from uni_adapter_torch.ops import geometry as pgeo
    rng = np.random.default_rng(2)
    xyz = rng.standard_normal((2, 50, 3)).astype(np.float32)
    xyz[:, 25:30] = xyz[:, 20:25]               # equal distances: ties
    q = xyz[:, ::5]
    np.testing.assert_allclose(
        pgeo.square_distance(torch.from_numpy(q),
                             torch.from_numpy(xyz)).numpy(),
        np.asarray(jgeo.square_distance(jnp.asarray(q), jnp.asarray(xyz))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        pgeo.knn_point(8, torch.from_numpy(xyz), torch.from_numpy(q)).numpy(),
        np.asarray(jgeo.knn_point(8, jnp.asarray(xyz), jnp.asarray(q))))
    np.testing.assert_array_equal(
        pgeo.query_ball_point(0.9, 12, torch.from_numpy(xyz),
                              torch.from_numpy(q)).numpy(),
        np.asarray(jgeo.query_ball_point(0.9, 12, jnp.asarray(xyz),
                                         jnp.asarray(q))))
    np.testing.assert_array_equal(
        pgeo.farthest_point_sample(torch.from_numpy(xyz), 10).numpy(),
        np.asarray(jgeo.farthest_point_sample(jnp.asarray(xyz), 10)))
