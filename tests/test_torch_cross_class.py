"""The port's cross-class attention analysis (`analysis/cross_class.py`,
`cli/cross_class.py`) and its exact t-SNE (`utils/tsne.py`) against the
JAX package and scikit-learn on the CPU, at a small Uni3D (width 48,
depth 2, 16 groups of 8, fp32; XLA twins on the JAX side).

The JAX analysis embeds the centroids with scikit-learn's Barnes-Hut
t-SNE; the port's is exact.  So the port's t-SNE is held against
scikit-learn's `method="exact"` from the same init (bitwise, on these
inputs), its PCA init against scikit-learn's, and its final KL against
the Barnes-Hut embedding's, both measured by one exact KL."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.distance import squareform
from sklearn.decomposition import PCA
from sklearn.manifold import TSNE
from sklearn.manifold._t_sne import _joint_probabilities, _kl_divergence
from sklearn.metrics import pairwise_distances

import uni_adapter_tpu.models.loader as jloader
from uni_adapter_tpu import config as jcfg
from uni_adapter_tpu.analysis import cross_class as jX
from uni_adapter_tpu.cli import cross_class as jcli
from uni_adapter_tpu.models.uni3d import create_uni3d as jax_create_uni3d
from uni_adapter_torch import config as pcfg
from uni_adapter_torch.analysis import cross_class as pX
from uni_adapter_torch.cli import cross_class as pcli
from uni_adapter_torch.models.uni3d import create_uni3d
from uni_adapter_torch.utils import tsne
from uni_adapter_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(pc_feat_dim=48, embed_dim=32, num_group=16, group_size=8,
             pc_encoder_dim=24, eva_depth=2, eva_heads=4,
             compute_dtype="float32")
NAMES = [f"class_{i}" for i in range(6)]
#: The extraction's fp32 tolerance (tests/test_torch_attention_maps.py
#: holds every map within 1e-5): centroids and distances within it.
ATOL = 1e-5


@pytest.fixture(scope="module")
def twins():
    """The JAX Uni3D with perturbed params and the port's on the same
    weights, both analyzers, and their clean and severity-2 centroids."""
    jmodel = jax_create_uni3d(jcfg.ModelConfig(**SMALL))
    rng = np.random.default_rng(4)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 512, 6), jnp.float32))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        .astype(np.float32), params)
    port = create_uni3d(pcfg.ModelConfig(**SMALL), "cpu",
                        state_dict=from_jax_params(params))
    jan = jX.CrossClassAttentionAnalyzer(jmodel, params, NAMES,
                                         num_group=16, group_size=8)
    pan = pX.CrossClassAttentionAnalyzer(port, NAMES, num_group=16,
                                         group_size=8)
    clean = pcli.synthetic_class_set()
    corrupt = pcli.synthetic_class_set(noise=0.1, noise_seed=2)
    cents = {}
    for tag, an in (("jax", jan), ("port", pan)):
        cents[tag] = (an.class_centroids(*clean), an.class_centroids(*corrupt))
    return jmodel, params, port, jan, pan, cents


def test_synthetic_class_set_is_the_jax_clis():
    for kw in ({}, {"noise": 0.15, "noise_seed": 3}):
        for a, b in zip(pcli.synthetic_class_set(**kw),
                        jcli.synthetic_class_set(**kw)):
            np.testing.assert_array_equal(a, b)


def test_centroids_and_distances_match_jax(twins):
    """(6, 16) centroids clean and corrupted, the three distance matrices,
    the nearest-neighbour flips and the top-confused pairs."""
    *_, jan, pan, cents = twins
    for got, want in zip(cents["port"], cents["jax"]):
        assert got.shape == want.shape == (6, 16)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    gm = pan.distance_matrices(*cents["port"])
    wm = jan.distance_matrices(*cents["jax"])
    for key in ("clean", "corrupted", "delta"):
        np.testing.assert_allclose(gm[key], wm[key], rtol=0, atol=ATOL)
    assert pan.confusion_analysis(*cents["port"]) == \
        jan.confusion_analysis(*cents["jax"])
    got, want = (pX.top_confused_pairs(gm, NAMES),
                 jX.top_confused_pairs(wm, NAMES))
    assert [(p["class_i"], p["class_j"]) for p in got["top_confused_pairs"]] \
        == [(p["class_i"], p["class_j"]) for p in want["top_confused_pairs"]]
    assert got["neighbor_change_ratio"] == want["neighbor_change_ratio"]
    assert got["mean_distance_change"] == pytest.approx(
        want["mean_distance_change"], abs=ATOL)


def test_severity_sweep_and_refusals_match_jax(twins):
    """The severity sweep (subsampled to 2 a class) equals JAX's, and the
    empty and missing-class errors are JAX's, word for word."""
    *_, jan, pan, _ = twins

    def load(s):
        return pcli.synthetic_class_set(noise=0.05 * s, noise_seed=s)

    got = pan.severity_sweep(load, [1, 3], max_per_class=2)
    want = jan.severity_sweep(load, [1, 3], max_per_class=2)
    assert list(got) == list(want) == [1, 3]
    for s in got:
        np.testing.assert_allclose(got[s], want[s], rtol=0, atol=ATOL)
    pcs, labels = pcli.synthetic_class_set()
    for args in ((pcs[:0], labels[:0]), (pcs[labels < 5], labels[labels < 5])):
        with pytest.raises(ValueError) as w:
            jan.class_centroids(*args)
        with pytest.raises(ValueError) as g:
            pan.class_centroids(*args)
        assert str(g.value) == str(w.value)


def _unit_cloud(n, d, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)) * 0.01 + rng.uniform(size=(1, d))


@pytest.mark.parametrize("n,d", [(12, 16), (12, 512), (40, 128)])
def test_pca_init_is_sklearns(n, d):
    """The init scaled to std 1e-4 in column 0: within 1e-5 of its scale
    of scikit-learn's (PCA's randomized or full solver, as its 'auto'
    picks for the shape; svd_flip's signs)."""
    x = _unit_cloud(n, d, seed=d)
    pca = PCA(n_components=2, random_state=0)
    pca.set_output(transform="default")
    want = pca.fit_transform(x).astype(np.float32)
    want = want / np.std(want[:, 0]) * 1e-4
    got = tsne.pca_init(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n,d", [(12, 16), (12, 512), (40, 128)])
def test_tsne_is_sklearns_exact_method(n, d):
    """From the same fp32 init: the embedding at the end of early
    exaggeration (max_iter 250) and at the end (1000), the iteration it
    stopped at and the final KL, against TSNE(method='exact'): equal
    within 1e-6 of the embedding's scale (bitwise here), the symmetrised
    P within 1e-12 of its largest entry."""
    x = _unit_cloud(n, d, seed=d)
    perp = max(2, min(30, n // 2 - 1))
    init = tsne.pca_init(torch.from_numpy(x)).numpy()
    want_p = _joint_probabilities(
        pairwise_distances(x, metric="euclidean", squared=True), perp, 0)
    got_p = squareform(tsne.joint_probabilities(torch.from_numpy(x), perp)
                       .numpy(), checks=False)
    np.testing.assert_allclose(got_p, want_p, rtol=0,
                               atol=1e-12 * want_p.max())
    for max_iter in (250, 1000):
        sk = TSNE(n_components=2, perplexity=perp, init=init.copy(),
                  method="exact", max_iter=max_iter).fit(x)
        got = tsne.tsne(torch.from_numpy(x), perplexity=perp,
                        init=torch.from_numpy(init), max_iter=max_iter)
        emb = got["embedding"].numpy()
        np.testing.assert_allclose(emb, sk.embedding_, rtol=0,
                                   atol=1e-6 * np.abs(sk.embedding_).max())
        assert got["n_iter"] == sk.n_iter_
        if max_iter == 1000:
            assert got["kl_divergence"] == pytest.approx(sk.kl_divergence_,
                                                         rel=1e-9)


def test_tsne_displacement_kl_no_worse_than_jax_barnes_hut(twins):
    """The analysis's joint embedding of clean and corrupted centroids:
    the port's exact t-SNE reaches an exact KL no higher than the JAX
    analysis's Barnes-Hut embedding, both measured by scikit-learn's
    exact `_kl_divergence` on the same P."""
    *_, jan, pan, cents = twins
    got = pan.tsne_displacement(*cents["port"])
    want = jan.tsne_displacement(*cents["jax"])
    assert got.shape == want.shape == (6, 2, 2)
    joint = np.concatenate(cents["port"], 0)
    P = _joint_probabilities(
        pairwise_distances(joint, metric="euclidean", squared=True), 5, 0)

    def kl(emb):
        flat = np.concatenate([emb[:, 0], emb[:, 1]]).astype(np.float32)
        return _kl_divergence(flat.ravel(), P, 1, 12, 2)[0]

    assert kl(got) <= kl(want)


def test_cli_writes_the_jax_clis_files(tmp_path, twins, monkeypatch):
    """Both CLIs on the same weights over the synthetic class set, three
    severities: the same files (the JAX CLI's figures left out), the
    centroids within ATOL, analysis.json equal (floats within ATOL); the
    embeddings differ by method and are only shaped alike.  The port draws
    its figures here, where matplotlib imports."""
    jmodel, params, port, *_ = twins
    monkeypatch.setattr(jloader, "build_backbone",
                        lambda *a, **k: (jmodel, None, 16, 8))
    monkeypatch.setattr(jloader, "init_or_load_params",
                        lambda *a, **k: params)
    for name in dir(jX):
        if name.startswith(("visualize_", "plot_")):
            monkeypatch.setattr(jX, name, lambda *a, **k: None)
    monkeypatch.setattr(pcli, "build_backbone",
                        lambda *a, **k: (port, 16, 8))
    args = ["--severities", "1", "2", "3", "--max-per-class", "2"]
    jcli.main([*args, "--out", str(tmp_path / "jax")])
    res = pcli.main([*args, "--out", str(tmp_path / "port"), "--device",
                     "cpu"])
    assert res["figures"]
    jfiles = {p.name for p in (tmp_path / "jax").iterdir()}
    pfiles = {p.name for p in (tmp_path / "port").iterdir()}
    assert jfiles <= pfiles
    assert {f for f in pfiles - jfiles if not f.endswith(".png")} == set()
    assert "severity_progression.png" in pfiles
    for f in sorted(jfiles):
        if f.startswith("centroids"):
            np.testing.assert_allclose(np.load(tmp_path / "port" / f),
                                       np.load(tmp_path / "jax" / f),
                                       rtol=0, atol=ATOL, err_msg=f)
        elif f.startswith("tsne"):
            assert np.load(tmp_path / "port" / f).shape == \
                np.load(tmp_path / "jax" / f).shape == (6, 2, 2)

    def close(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                close(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                close(x, y)
        elif isinstance(a, float):
            assert a == pytest.approx(b, abs=ATOL)
        else:
            assert a == b

    close(*(json.loads((tmp_path / d / "analysis.json").read_text())
            for d in ("port", "jax")))


def test_cli_without_gpu_and_without_device_cpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="--device cpu"):
        pcli.main(["--depth", "1", "--out", str(tmp_path)])
