"""The port's class-sharded plain DOTA, GMM-DOTA, adaptive-modes DOTA and
prototype cache (`parallel/ep.py`) over two gloo ranks against the JAX
package's `parallel/ep.py` on a 2-device CPU mesh, at the small dims of
tests/test_ep_{dota,gmm,adaptive,cache}.py and at their tolerances:
plain DOTA's means, counts, covariances and prior within rtol 1e-4 (its
precision Λ, an ill-conditioned inverse, within rtol 2e-3, atol 1);
GMM-DOTA's mixture within rtol 1e-5, atol 1e-6; adaptive DOTA's within
rtol 1e-4 (1e-3 after splits), its masks equal; the cache's slots and
merge counts equal, its prototypes, confidences and probabilities within
rtol 1e-5, atol 1e-6 (1e-4 with the explicit solve).

Those tolerances hold the port's EP run against the port's replicated
run (`engine.run_stream_scan` on rank 0), as tests/test_ep_*.py hold
JAX's EP run against JAX's replicated one; against JAX's EP run the
summaries are equal and the state within CROSS of its largest entry
(the port's fp32 encoder is not JAX's bit for bit;
tests/test_torch_variants.py's bound on a stream's state; Λ at its own
tolerance above, the slots and counts equal).

The port's world runs from a module fixture (`torch_dist_worker.py`)
while JAX runs its side.  GMM-DOTA's init is JAX's (its PRNG draw),
handed to the port as the initial full-K carry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist_worker import collect, start_world
from uni_adapter_tpu import config as jcfg
from uni_adapter_tpu import engine as jengine
from uni_adapter_tpu.models.uni3d import create_uni3d as jax_create_uni3d
from uni_adapter_tpu.parallel import ep as jep
from uni_adapter_torch import config as pcfg
from uni_adapter_torch import engine
from uni_adapter_torch.parallel import ep
from uni_adapter_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

D, N, T = 32, 48, 8
SMALL = dict(pc_feat_dim=48, embed_dim=D, num_group=8, group_size=8,
             pc_encoder_dim=24, eva_depth=1, eva_heads=4,
             compute_dtype="float32")
METHODS = {"dota": dict(use_dota=True, use_mode_dota=False),
           "gmm": dict(use_mode_dota=False, use_gmm_dota=True, mode_M=2),
           "adaptive": dict(use_mode_dota=False, use_adaptive_dota=True),
           "cache": dict(use_mode_dota=False)}
CACHE = dict(shot_capacity=3, threshold=0.3, lambda_reg=0.11, beta=150.0)
CROSS = 1e-4
#: each method's fields held to tolerances, and the exact ones
FIELDS = {"dota": (("mu", "c", "sigma", "cum_soft_labels"), ("prior_step",)),
          "gmm": (("mu", "sigma", "sigma_reg", "pi", "C", "class_counts"),
                  ("total_samples",)),
          "adaptive": (("mu", "var", "pi", "c", "class_counts"),
                       ("mask", "t", "fit_calls")),
          "cache": (("feats", "conf", "probs"), ("valid", "counts"))}

#: name: (method, K, B, steps, dota overrides, cache overrides, halves)
CASES = {"dota_K6": ("dota", 6, 2, T, {}, {}, False),
         "dota_prior_K5": ("dota", 5, 1, T, dict(prior_pre_steps=4), {},
                           False),
         "dota_continual": ("dota", 5, 1, T, {}, {}, True),
         "gmm_K6": ("gmm", 6, 2, T, {}, {}, False),
         "gmm_K5": ("gmm", 5, 1, T, {}, {}, False),
         "adaptive_K6": ("adaptive", 6, 2, T, {}, {}, False),
         "adaptive_splits": ("adaptive", 5, 1, 60, dict(sigma=5e-4), {},
                             False),
         "cache_dense_K5": ("cache", 5, 1, T, {}, dict(graph_mode="dense"),
                            False),
         "cache_proto_K6": ("cache", 6, 1, T, {},
                            dict(graph_mode="prototype"), False),
         "cache_proto_K5": ("cache", 5, 1, T, {},
                            dict(graph_mode="prototype"), False),
         "cache_explicit": ("cache", 6, 1, T, {},
                            dict(use_new_approximation=False), False),
         "cache_continual": ("cache", 5, 1, T, {}, {}, True)}


def configs(method, dota=None, cache=None):
    kw = {**METHODS[method], **(dota or {})}
    cc = {**CACHE, **(cache or {})}
    return (jcfg.Config(model=jcfg.ModelConfig(**SMALL),
                        dota=jcfg.DotaConfig(**kw),
                        cache=jcfg.CacheConfig(**cc)),
            pcfg.Config(model=pcfg.ModelConfig(**SMALL),
                        dota=pcfg.DotaConfig(**kw),
                        cache=pcfg.CacheConfig(**cc)))


def text_of(rng, K):
    t = rng.standard_normal((K, D)).astype(np.float32)
    return t / np.linalg.norm(t, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep_methods")
    jmodel = jax_create_uni3d(jcfg.ModelConfig(**SMALL))
    rng = np.random.default_rng(0)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, N, 6), jnp.float32))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        .astype(np.float32), params)
    cases, jax_cases = {}, {}
    for name, (method, K, B, steps, dota, cache, halves) in CASES.items():
        jc, pc = configs(method, dota, cache)
        text = text_of(rng, K)
        pcs = rng.standard_normal((steps, B, N, 3)).astype(np.float32)
        stream = (pcs, np.ones_like(pcs),
                  rng.integers(0, K, (steps, B)).astype(np.int32))
        bounds = [(0, steps // 2), (steps // 2, steps)] if halves \
            else [(0, steps)]
        init = None
        if method == "gmm":
            ms = jengine.init_state(jc, jnp.asarray(text),
                                    jax.random.PRNGKey(42)).method_state
            init = {f: np.asarray(getattr(ms, f)) for f in ms._fields}
        cases[name] = {"cfg": pc, "text": text, "init": init, "runs": [
            tuple(a[lo:hi] for a in stream) for lo, hi in bounds]}
        jax_cases[name] = (jc, text, stream, bounds)
    procs = start_world("ep_methods", {
        "model_cfg": pcfg.ModelConfig(**SMALL),
        "state_dict": from_jax_params(params), "cases": cases}, tmp)

    mesh = jep.make_classes_mesh(2)
    want = {}
    for name, (jc, text, stream, bounds) in jax_cases.items():
        carry, parts = None, []
        for lo, hi in bounds:
            carry, summary = jep.run_stream_ep(
                jc, jmodel, params, text, *(a[lo:hi] for a in stream),
                mesh=mesh, seed=42, initial_state=carry)
            parts.append((carry, summary))
        want[name] = parts
    return want, collect(procs, tmp, timeout=300.0)


def _ok(result):
    assert "error" not in result, result.get("error")
    return result


def _close(got, want, names, rtol, atol):
    for name in names:
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=name)


def assert_method_close(method, got: dict, want: dict, loose=False):
    """The port's EP state against the port's replicated one, at
    tests/test_ep_<method>.py's tolerances."""
    close, exact = FIELDS[method]
    for name in exact:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    if method == "dota":
        _close(got, want, close, 1e-4, 1e-5)
        _close(got, want, ("lam",), 2e-3, 1.0)
    elif method == "gmm":
        _close(got, want, close, 1e-5, 1e-6)
    elif method == "adaptive":
        _close(got, want, close, *((1e-3, 1e-4) if loose else (1e-4, 1e-5)))
    else:
        _close(got, want, close, *((1e-4, 1e-5) if loose else (1e-5, 1e-6)))


def assert_near_jax(method, got: dict, jstate):
    """The port's EP state against JAX's: the exact fields equal, the
    others within CROSS of their largest entry (Λ at its own bound)."""
    close, exact = FIELDS[method]
    for name in exact:
        np.testing.assert_array_equal(got[name],
                                      np.asarray(getattr(jstate, name)),
                                      err_msg=name)
    for name in close:
        want = np.asarray(getattr(jstate, name))
        np.testing.assert_allclose(got[name], want, rtol=0,
                                   atol=CROSS * np.abs(want).max(),
                                   err_msg=name)
    if method == "dota":
        np.testing.assert_allclose(got["lam"], np.asarray(jstate.lam),
                                   rtol=2e-3, atol=1.0, err_msg="lam")


@pytest.mark.parametrize("name", list(CASES))
def test_ep_method_matches_jax(runs, name):
    """Each method's class-sharded stream over two ranks (K 5 pads to 6):
    both ranks hold the replicated run's full-K state (each half of a
    continual chain too), near JAX's EP state, and JAX's summary; the
    step count goes on through a chain."""
    want, got = runs
    method = CASES[name][0]
    for part, (jstate, jsummary) in enumerate(want[name]):
        replicated = _ok(got[0][name])[part]["replicated"]
        for rank in range(2):
            res = _ok(got[rank][name])[part]
            assert_method_close(method, res["state"], replicated,
                                loose=name in ("adaptive_splits",
                                               "cache_explicit"))
            assert_near_jax(method, res["state"], jstate.method_state)
            assert res["state"]["step"] == int(jstate.step)
            assert set(res["summary"]) == set(jsummary)
            for key in jsummary:
                assert res["summary"][key] == pytest.approx(
                    float(jsummary[key]), abs=1e-5), key


def test_ep_adaptive_splits_fire(runs):
    """60 steps at σ 5e-4: modes split past one a class on the real rows,
    on the step JAX's do."""
    want, got = runs
    mask = _ok(got[0]["adaptive_splits"])[0]["state"]["mask"]
    assert mask.sum() > 5
    np.testing.assert_array_equal(
        mask, np.asarray(want["adaptive_splits"][0][0].method_state.mask))


@pytest.mark.parametrize("name", ["cache_dense_K5", "cache_proto_K6"])
def test_ep_cache_merges(runs, name):
    """The cache filled a class and merged into it (a count above 1): the
    owner-masked merge ran, and matched JAX's."""
    _, got = runs
    assert _ok(got[0][name])[0]["state"]["counts"].max() > 1


@pytest.mark.parametrize("method", ["gmm", "dota", "cache"])
def test_padded_init_equals_the_replicated_init(method):
    """A fresh padded carry over 2 blocks (K 5 → 6), stripped, is the
    replicated init of the same seed: GMM-DOTA's perturbation is drawn
    for the real K, the generator left where the replicated init leaves
    it; the pad row of GMM-DOTA is the unit e_0 anchor."""
    _, cfg = configs(method)
    text = torch.from_numpy(text_of(np.random.default_rng(5), 5))
    want = engine.init_state(cfg, text, 9)
    padded = ep.make_padded_state(cfg, text, 9, 2)
    got = ep.strip_padded_state(padded, 5)
    for name, a, b in zip(want.method_state._fields, got.method_state,
                          want.method_state):
        assert torch.equal(a, b), name
    assert torch.equal(padded.generator.get_state(),
                       want.generator.get_state())
    if method == "gmm":
        e0 = torch.zeros(D)
        e0[0] = 1.0
        assert torch.equal(padded.method_state.mu[5],
                           e0.expand(cfg.dota.mode_M, D))
