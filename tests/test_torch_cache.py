"""The prototype-cache path of the port (`adapt/cache.py`, the CG and the
graph refinements of `utils/math.py`, `fusion.fuse_cache`, the engine's
cache step, its stream axis) and the residual loop's precision tiers,
against the JAX package on the CPU, on the same numpy inputs from a seed.

The JAX functions run as the JAX package's own tests run them on the CPU
(the cache has no Pallas kernel; the small Uni3D uses its XLA twins).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_adapt import EPS, SMALL, _t, _unit_rows, fitted  # noqa: F401
from test_torch_streams import CLI_SMALL, corruption_root  # noqa: F401
from uni_adapter_tpu import config as jcfg_mod
from uni_adapter_tpu import engine as jengine
from uni_adapter_tpu.adapt import cache as jcache
from uni_adapter_tpu.adapt import fusion as jfusion
from uni_adapter_tpu.adapt import residual as jres
from uni_adapter_tpu.models.uni3d import create_uni3d as jax_create_uni3d
from uni_adapter_tpu.utils import math as jmath
from uni_adapter_torch import config as pcfg_mod
from uni_adapter_torch import engine as pengine
from uni_adapter_torch.adapt import cache, fusion, residual
from uni_adapter_torch.cli import tta
from uni_adapter_torch.config import CORRUPTIONS
from uni_adapter_torch.models.uni3d import create_uni3d
from uni_adapter_torch.utils import math as pmath
from uni_adapter_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401


K, D = 5, 16
CACHE_FIELDS = ("feats", "conf", "probs", "counts", "valid")


def to_port(js) -> cache.CacheState:
    return cache.CacheState(*(_t(np.asarray(a)) for a in js))


def assert_cache_close(ps, js, atol, err=""):
    for name in CACHE_FIELDS:
        got, want = getattr(ps, name).numpy(), np.asarray(getattr(js, name))
        if name == "valid":
            np.testing.assert_array_equal(got, want, err_msg=err + name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                       err_msg=err + name)


def _sample(rng, clipw, scale=100.0):
    """A unit feature and its probabilities and normalised entropy at
    `scale`, computed by the JAX package (both sides take them as given)."""
    f = _unit_rows(rng, 1, D)
    logits = scale * jnp.matmul(jnp.asarray(f), clipw)
    prob = jax.nn.softmax(logits, axis=1)
    ent = jmath.normalized_entropy(jmath.softmax_entropy(logits), K)[0]
    return f, prob, ent


_jax_update = jax.jit(jcache.update_cache,
                      static_argnames=("beta", "logit_scale"))


def _update_both(js, ps, cls, f, prob, ent, clipw, **kw):
    js, jins = _jax_update(js, jnp.int32(cls), jnp.asarray(f), ent, prob,
                           clipw, **kw)
    ps, pins = cache.update_cache(ps, torch.tensor(cls), _t(f), _t(ent),
                                  _t(prob), _t(clipw), **kw)
    assert bool(pins) == bool(jins)
    return js, ps, bool(pins)


@pytest.fixture
def clipw():
    w = np.random.default_rng(1).standard_normal((D, K)).astype(np.float32)
    return jnp.asarray(w / np.linalg.norm(w, axis=0))


def test_update_cache_inserts_then_merges_as_jax(clipw):
    """12 samples into classes 0 and 1 at capacity 2 (two inserts, then
    merges into the most similar prototype), then a class holding one
    prototype twice (the merge takes the first on the tie): the same
    insert/merge decisions, valid and counts exactly, features,
    confidences and probabilities within 1e-6 (fp32 rounding)."""
    rng = np.random.default_rng(0)
    js, ps = jcache.init(K, 2, D), cache.init(K, 2, D)
    inserted = []
    for t in range(12):
        f, prob, ent = _sample(rng, clipw)
        js, ps, ins = _update_both(js, ps, t % 2, f, prob, ent, clipw)
        inserted.append(ins)
        assert_cache_close(ps, js, 1e-6, f"step {t}: ")
    assert inserted == [True] * 4 + [False] * 8
    assert ps.counts[:2].sum().item() == 12.0
    norms = torch.linalg.norm(ps.feats[:2], dim=-1)
    np.testing.assert_allclose(norms.numpy(), 1.0, atol=1e-5)

    f, prob, ent = _sample(rng, clipw)
    for _ in range(2):
        js, ps, _ = _update_both(js, ps, 3, f, prob, ent, clipw)
    g, prob, ent = _sample(rng, clipw)
    js, ps, ins = _update_both(js, ps, 3, g, prob, ent, clipw)
    assert not ins and ps.counts[3].tolist() == [2.0, 1.0]
    assert_cache_close(ps, js, 1e-6)
    np.testing.assert_allclose(
        pmath.normalized_entropy(torch.tensor([1.3, 0.2]), 40).numpy(),
        np.asarray(jmath.normalized_entropy(jnp.asarray([1.3, 0.2]), 40)),
        rtol=1e-7)


def test_update_cache_zero_confidence_merge_falls_back_as_jax(clipw):
    """Both confidences underflowed to 0 (normalised entropy 1, β 150):
    the count-weighted mean, finite, as the JAX oracle
    (tests/test_adapt.py) within 1e-6; the cache logits after it finite
    and within 1e-6 of JAX's."""
    rng = np.random.default_rng(2)
    js, ps = jcache.init(K, 1, D), cache.init(K, 1, D)
    ent = jnp.float32(1.0)
    prob = jnp.full((1, K), 1.0 / K, jnp.float32)
    f0, f1 = _unit_rows(rng, 1, D), _unit_rows(rng, 1, D)
    js, ps, ins = _update_both(js, ps, 2, f0, prob, ent, clipw)
    js, ps, merged = _update_both(js, ps, 2, f1, prob, ent, clipw)
    assert ins and not merged
    assert_cache_close(ps, js, 1e-6)
    want = (f0[0] + f1[0]) / 2
    np.testing.assert_allclose(ps.feats[2, 0].numpy(),
                               want / np.linalg.norm(want), atol=1e-6)
    q = _unit_rows(rng, 1, D)
    got, _ = cache.compute_cache_logits(_t(q), ps, 0.3, 0.11)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jcache.compute_cache_logits(
            jnp.asarray(q), js, 0.3, 0.11)), atol=1e-6)


def test_update_cache_merge_rescores_at_logit_scale(clipw):
    """A merge at logit scale 40 re-scores the merged prototype at 40, as
    JAX does: state within 1e-6, probs equal softmax(40·sim)."""
    rng = np.random.default_rng(3)
    js, ps = jcache.init(K, 1, D), cache.init(K, 1, D)
    for _ in range(2):
        f, prob, ent = _sample(rng, clipw, scale=40.0)
        js, ps, _ = _update_both(js, ps, 1, f, prob, ent, clipw,
                                 logit_scale=40.0)
    assert_cache_close(ps, js, 1e-6)
    want = torch.softmax(40.0 * ps.feats[1, 0] @ _t(clipw), dim=-1)
    np.testing.assert_allclose(ps.probs[1, 0].numpy(), want.numpy(),
                               atol=1e-6)


def _spd(rng, n, lo, hi):
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((q * rng.uniform(lo, hi, n)) @ q.T).astype(np.float32)


def _cg_per_column_freeze(A, b, max_iter=100, tol=1e-5):
    """The fault the JAX docstring warns of: each column stops on its own."""
    x = np.zeros_like(b)
    r = b.copy()
    p = r.copy()
    rz = (r * r).sum(0)
    live = np.ones(b.shape[1], bool)
    for _ in range(max_iter):
        Ap = A @ p
        alpha = rz / ((p * Ap).sum(0) + 1e-8)
        x = np.where(live, x + alpha * p, x)
        r_new = r - alpha * Ap
        rz_new = (r_new * r_new).sum(0)
        p = np.where(live, r_new + rz_new / (rz + 1e-8) * p, p)
        r, rz = np.where(live, r_new, r), np.where(live, rz_new, rz)
        live &= ~(rz_new < tol)
        if not live.any():
            break
    return x


def test_conjugate_gradient_matches_jax():
    """An SPD system with 3 columns, one of them tiny: x within 1e-6 of
    JAX's while_loop (fp32); all columns run until all have converged, so
    a per-column stop moves the tiny column by more than 10× the
    tolerance.  A tiny b alone: exactly one iteration (the
    do-while), x ∝ b, as JAX."""
    rng = np.random.default_rng(0)
    A = _spd(rng, 24, 0.2, 2.2)
    b = rng.standard_normal((24, 3)).astype(np.float32)
    b[:, 2] *= 1e-3
    want = np.asarray(jmath.conjugate_gradient(jnp.asarray(A),
                                               jnp.asarray(b)))
    x, iters = pmath.conjugate_gradient(_t(A), _t(b))
    np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=1e-6)
    assert 3 < int(iters) < 100
    freeze = _cg_per_column_freeze(A, b)
    assert np.abs(freeze[:, 2] - want[:, 2]).max() > 1e-5
    np.testing.assert_allclose(freeze[:, :2], want[:, :2], atol=1e-4)

    tiny = 1e-4 * b[:, :1]
    x, iters = pmath.conjugate_gradient(_t(A), _t(tiny))
    assert int(iters) == 1
    np.testing.assert_allclose(
        x.numpy(), np.asarray(jmath.conjugate_gradient(jnp.asarray(A),
                                                       jnp.asarray(tiny))),
        rtol=1e-6, atol=0)
    assert np.abs(x.numpy()).min() > 0


def test_batched_conjugate_gradient_stops_each_system_as_jax_vmap():
    """Two systems that converge at different iterations, run as one
    batch: each stops where it stops alone (the same iteration count, x
    within rtol 1e-7), and the batch equals `jax.vmap` of the JAX loop within
    1e-6; the system that stops first, run on to the other's count (no
    freeze), moves by more than 10× that."""
    rng = np.random.default_rng(1)
    A = np.stack([_spd(rng, 24, 1.0, 1.5), _spd(rng, 24, 0.05, 3.0)])
    b = rng.standard_normal((2, 24, 4)).astype(np.float32)
    x, iters = pmath.conjugate_gradient(_t(A), _t(b))
    alone = [pmath.conjugate_gradient(_t(A[s]), _t(b[s])) for s in range(2)]
    assert iters.tolist() == [int(a[1]) for a in alone]
    assert iters[0] < iters[1]
    for s in range(2):
        np.testing.assert_allclose(x[s].numpy(), alone[s][0].numpy(),
                                   rtol=1e-7, atol=0)
    want = np.asarray(jax.vmap(jmath.conjugate_gradient)(jnp.asarray(A),
                                                         jnp.asarray(b)))
    tol = 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=tol)
    over, _ = pmath.conjugate_gradient(_t(A[0]), _t(b[0]),
                                       max_iter=int(iters[1]), tol=0.0)
    assert np.abs(over.numpy() - want[0]).max() > 10 * tol


def _graph_inputs(rng, n=14, k=4):
    keys = _unit_rows(rng, n, 8)
    keys[:4] = keys[4] + 0.1 * keys[:4]         # a cluster above threshold
    probs = rng.dirichlet(np.ones(k), n).astype(np.float32)
    valid = np.ones(n, bool)
    valid[[1, 7, 11]] = False
    return keys, probs, valid


def test_refinements_match_jax():
    """The CG refinement and the explicit solve on a masked graph (the
    port's `refinement_system`, `conjugate_gradient` or `solve_explicit`,
    `refined_labels`): refined labels within 1e-6 of JAX's
    `online_value_refinement_new` / `_old`, invalid rows zero, rows
    summing to 1."""
    keys, probs, valid = _graph_inputs(np.random.default_rng(4))
    args = (jnp.asarray(keys), jnp.asarray(probs), jnp.asarray(valid))
    L, rhs = pmath.refinement_system(_t(keys), _t(probs), _t(valid), 0.5,
                                     0.11)
    sol, iters = pmath.conjugate_gradient(L, rhs)
    new = pmath.refined_labels(sol, _t(valid))
    old = pmath.refined_labels(pmath.solve_explicit(L, rhs), _t(valid))
    for got, want in (
            (new, jmath.online_value_refinement_new(*args, 0.5, 0.11)),
            (old, jmath.online_value_refinement_old(*args, 0.5, 0.11))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
        assert (got[~_t(valid)] == 0).all()
        np.testing.assert_allclose(got[_t(valid)].sum(-1).numpy(), 1.0,
                                   atol=1e-6)
    assert int(iters) >= 1


def _random_state(rng, k=6, c=3, d=D):
    feats = _unit_rows(rng, k * c, d).reshape(k, c, d)
    valid = rng.random((k, c)) < 0.6
    valid[0] = True
    return jcache.CacheState(
        feats=jnp.asarray(feats),
        conf=jnp.asarray(rng.uniform(0.05, 1.0, (k, c)), jnp.float32),
        probs=jnp.asarray(rng.dirichlet(np.ones(k), (k, c)), jnp.float32),
        counts=jnp.asarray(valid, jnp.float32), valid=jnp.asarray(valid))


@pytest.mark.parametrize("mode", ["dense", "prototype", "auto"])
@pytest.mark.parametrize("new", [True, False])
def test_compute_cache_logits_matches_jax(mode, new):
    """Each graph mode with the CG and with the explicit solve, on a
    partly filled cache: logits within 1e-6 of JAX's; an empty cache
    gives zeros exactly."""
    rng = np.random.default_rng(5)
    js = _random_state(rng)
    q = _unit_rows(rng, 2, D)
    got, iters = cache.compute_cache_logits(
        _t(q), to_port(js), 0.3, 0.11, use_new_approximation=new,
        cg_max_iter=50, graph_mode=mode)
    want = jcache.compute_cache_logits(
        jnp.asarray(q), js, 0.3, 0.11, use_new_approximation=new,
        cg_max_iter=50, graph_mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert (iters is not None) == new
    empty, _ = cache.compute_cache_logits(
        _t(q), cache.init(6, 3, D), 0.3, 0.11, use_new_approximation=new,
        graph_mode=mode)
    assert torch.equal(empty, torch.zeros(2, 6))


def test_auto_graph_mode_and_unknown_mode():
    """'auto' is dense at K·C ≤ 4096 and prototype above (bitwise the
    chosen mode's logits); an unknown mode raises JAX's ValueError."""
    rng = np.random.default_rng(6)
    small = to_port(_random_state(rng))
    big = cache.init(1025, 4, D)._replace(
        feats=torch.nn.functional.normalize(torch.randn(1025, 4, D), dim=-1),
        valid=torch.rand(1025, 4) < 0.01, conf=torch.full((1025, 4), 0.5),
        probs=torch.softmax(torch.randn(1025, 4, 1025), -1))
    q = _t(_unit_rows(rng, 1, D))
    for state, mode in ((small, "dense"), (big, "prototype")):
        want, _ = cache.compute_cache_logits(q, state, 0.5, 0.11,
                                             cg_max_iter=5, graph_mode=mode)
        got, _ = cache.compute_cache_logits(q, state, 0.5, 0.11,
                                            cg_max_iter=5, graph_mode="auto")
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="unknown graph_mode"):
        cache.compute_cache_logits(q, small, 0.5, 0.11, graph_mode="sparse")


def test_prototype_graph_confidence_underflow_as_jax():
    """The JAX oracle's case (tests/test_lvis_scale.py): a class whose
    confidences are all 0 and one at 1e-26 still get their own prototype:
    a query on one of their shots scores its class highest, and the
    logits are within 1e-6 of JAX's."""
    rng = np.random.default_rng(3)
    k, c, d = 6, 3, 32
    base = rng.standard_normal((k, 1, d)).astype(np.float32)
    feats = base + 0.05 * rng.standard_normal((k, c, d)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    probs = np.full((k, c, k), 0.01, np.float32)
    for i in range(k):
        probs[i, :, i] = 1.0
    probs /= probs.sum(-1, keepdims=True)
    conf = rng.uniform(0.1, 1.0, (k, c)).astype(np.float32)
    conf[2], conf[3] = 0.0, 1e-26
    js = jcache.init(k, c, d)._replace(
        feats=jnp.asarray(feats), probs=jnp.asarray(probs),
        valid=jnp.ones((k, c), bool), conf=jnp.asarray(conf))
    for cls in (2, 3):
        q = feats[cls, 0][None]
        got, _ = cache.compute_cache_logits(_t(q), to_port(js), 0.5, 0.11,
                                            cg_max_iter=10,
                                            graph_mode="prototype")
        assert int(got[0].argmax()) == cls
        np.testing.assert_allclose(got.numpy(), np.asarray(
            jcache.compute_cache_logits(jnp.asarray(q), js, 0.5, 0.11,
                                        cg_max_iter=10,
                                        graph_mode="prototype")),
            rtol=0, atol=1e-6)


def test_fuse_cache_matches_jax():
    """At logit scale 100 and 40: within rtol 1e-6 of JAX's fusion."""
    rng = np.random.default_rng(7)
    clip = (60 * rng.standard_normal((3, K))).astype(np.float32)
    cl = rng.uniform(0, 1, (3, K)).astype(np.float32)
    for scale in (100.0, 40.0):
        np.testing.assert_allclose(
            fusion.fuse_cache(_t(clip), _t(cl), scale).numpy(),
            np.asarray(jfusion.fuse_cache(jnp.asarray(clip), jnp.asarray(cl),
                                          scale)), rtol=1e-6)


# ---- the engine's cache step against the JAX engine -------------------

S, T, N, KE = 3, 8, 128, 10


@pytest.fixture(scope="module")
def setup():
    return cache_setup()


def cache_setup():
    """One small Uni3D in both packages, anchors and S streams of T
    clouds; the cache at capacity 2, so that classes fill and merge.
    A random encoder maps clouds of one scale to nearly one feature, so
    the clouds are drawn at scales 0.05 to 8 and each anchor is the
    feature of a cloud at one of KE scales: predictions spread over the
    classes and the graphs' weights differ from stream to stream."""
    jmodel = jax_create_uni3d(jcfg_mod.ModelConfig(**SMALL))
    rng = np.random.default_rng(3)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, N, 6), jnp.float32))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        .astype(np.float32), params)
    pmodel = create_uni3d(pcfg_mod.ModelConfig(**SMALL), "cpu",
                          state_dict=from_jax_params(params))
    scales = np.geomspace(0.05, 8.0, KE, dtype=np.float32)[:, None, None]
    anchors = _t(scales * rng.standard_normal((KE, N, 3)).astype(np.float32))
    with torch.no_grad():
        text = pengine.encode_with("uni3d", pmodel)(
            anchors, torch.ones_like(anchors)).numpy()
    pcs = (np.exp(rng.uniform(np.log(0.05), np.log(8.0), (S, T, 1, 1, 1)))
           * rng.standard_normal((S, T, 1, N, 3))).astype(np.float32)
    targets = rng.integers(0, KE, (S, T, 1)).astype(np.int32)
    jcfg = jcfg_mod.Config(model=jcfg_mod.ModelConfig(**SMALL),
                           dota=jcfg_mod.DotaConfig(use_mode_dota=False),
                           cache=jcfg_mod.CacheConfig(shot_capacity=2))
    pcfg = pcfg_mod.Config(model=pcfg_mod.ModelConfig(**SMALL),
                           dota=pcfg_mod.DotaConfig(use_mode_dota=False),
                           cache=pcfg_mod.CacheConfig(shot_capacity=2))
    return (jcfg, pcfg, jmodel, params, pmodel, text, pcs,
            np.ones_like(pcs), targets)


def collecting(step, outputs):
    def run(text, state, batch):
        state, out = step(text, state, batch)
        outputs.append(out)
        return state, out
    return run


def assert_outputs_close(outs, jouts, index=lambda t: t):
    """Final and clip logits within 1e-5 (the final logits are O(1e-2):
    inverse-entropy weights times probabilities; clip logits 100·cosine),
    correct counts identical."""
    for t, out in enumerate(outs):
        j = jax.tree_util.tree_map(lambda a: np.asarray(a)[index(t)], jouts)
        np.testing.assert_allclose(out.final_logits.numpy(), j.final_logits,
                                   rtol=0, atol=1e-5, err_msg=f"step {t}")
        np.testing.assert_allclose(out.clip_logits.numpy(), j.clip_logits,
                                   rtol=0, atol=1e-4, err_msg=f"step {t}")
        np.testing.assert_array_equal(out.correct.numpy(), j.correct)
        np.testing.assert_array_equal(out.zs_correct.numpy(), j.zs_correct)


def test_engine_cache_path_matches_jax(setup):
    """One stream of 8 steps through the cache step against the JAX
    engine's (`run_stream_scan`, the numerics of `run_stream`): logits
    within 1e-5, counts identical, the cache within 1e-5, merges having
    happened; then the stream split in two and chained through
    `initial_state` (continual) equals the whole stream bitwise, as in
    JAX."""
    jcfg, pcfg, jmodel, params, pmodel, text, pcs, rgbs, targets = setup
    js, jouts = jengine.run_stream_scan(
        jcfg, jmodel, params, jnp.asarray(text), pcs[0], rgbs[0],
        targets[0], seed=42)
    outs = []
    step = collecting(pengine.make_step_fn(pcfg, pmodel), outs)
    batches = list(zip(pcs[0], rgbs[0], targets[0]))
    res = pengine.run_stream(pcfg, pmodel, _t(text), batches, step_fn=step)
    assert_outputs_close(outs, jouts)
    assert_cache_close(res["state"].method_state, js.method_state, 1e-5)
    assert res["state"].method_state.counts.max() >= 2     # merges ran
    assert all(int(o.cg_iters) >= 1 for o in outs)
    assert res["state"].res_state is None and res["state"].step == T

    half = pengine.run_stream(pcfg, pmodel, _t(text), batches[:3],
                              step_fn=step)
    rest = pengine.run_stream(pcfg, pmodel, _t(text), batches[3:],
                              step_fn=step, initial_state=half["state"])
    for got, want in zip(rest["state"].method_state,
                         res["state"].method_state):
        assert torch.equal(got, want)
    assert rest["state"].step == T


def test_engine_cache_streams_match_jax_vmapped(setup):
    """3 streams of 8 steps through `run_streams` against JAX
    `run_streams_vmapped`: logits within 1e-5, counts identical, caches
    within 1e-5.  Each stream's CG stops at the iteration where that
    stream's own run stops (its iteration counts equal `run_stream`'s,
    step by step), and at some step two streams stop at different
    iterations."""
    jcfg, pcfg, jmodel, params, pmodel, text, pcs, rgbs, targets = setup
    jstates, jouts = jengine.run_streams_vmapped(
        jcfg, jmodel, params, jnp.asarray(text), pcs, rgbs, targets, seed=42)
    step = pengine.make_step_fn(pcfg, pmodel)
    res = pengine.run_streams(pcfg, pmodel, _t(text), pcs, rgbs, targets,
                              step_fn=step)
    assert_outputs_close(res["outputs"], jouts)
    assert_cache_close(res["state"].method_state, jstates.method_state, 1e-5)
    iters = torch.stack([o.cg_iters for o in res["outputs"]])   # (T, S)
    for s in range(S):
        outs = []
        pengine.run_stream(pcfg, pmodel, _t(text),
                           zip(pcs[s], rgbs[s], targets[s]),
                           step_fn=collecting(step, outs))
        assert iters[:, s].tolist() == [int(o.cg_iters) for o in outs]
    assert any(len(set(row.tolist())) > 1 for row in iters), iters


def test_cache_step_raises_on_batch_above_one(setup):
    """The cache protocol is batch 1, as the JAX engine's ValueError."""
    _, pcfg, _, _, pmodel, text, pcs, rgbs, targets = setup
    step = pengine.make_step_fn(pcfg, pmodel)
    state = pengine.init_state(pcfg, _t(text))
    batch = (_t(pcs[0, :2, 0]), _t(rgbs[0, :2, 0]), _t(targets[0, :2, 0]))
    with pytest.raises(ValueError, match="batch_size=1"):
        step(_t(text), state, batch)


def test_cli_cache_path_sweep_continual_and_shapenet(corruption_root,
                                                     tmp_path):
    """`--dota-use-mode-dota false` through `cli.tta.main` on the CPU: the
    15-corruption sweep (`--vmap-corruptions`: 15 keys in both result
    files), `--continual` (the step counter through the corruptions), and
    ShapeNetCore's table (threshold 0.45, λ 0.07, the explicit solve: no
    CG iterations)."""
    argv = ["--device", "cpu", "--root", str(corruption_root),
            "--dota-use-mode-dota", "false", "--output-dir",
            str(tmp_path / "out"), *CLI_SMALL]
    summary = tta.main([*argv, "--corruption", "all", "--vmap-corruptions",
                        "true", "--name", "sweep"])
    assert list(summary["acc1"]) == list(CORRUPTIONS)
    assert list(summary["zs_acc1"]) == list(CORRUPTIONS)
    assert all(summary["finite"].values())
    assert all(len(v) == 2 and min(v) >= 1
               for v in summary["cg_iters"].values())
    summary = tta.main([*argv, "--corruption", "all", "--continual", "true",
                        "--name", "chain"])
    assert list(summary["steps"].values()) == [
        [2 * i, 2 * i + 2] for i in range(len(CORRUPTIONS))]
    cfg = pcfg_mod.parse_args([*argv, "--dataset-name", "shapenetcore"])
    assert (cfg.cache.threshold, cfg.cache.lambda_reg,
            cfg.cache.use_new_approximation) == (0.45, 0.07, False)
    summary = tta.main([*argv, "--corruption", "uniform", "--dataset-name",
                        "shapenetcore", "--name", "shapenet"])
    assert summary["finite"]["uniform"]
    assert summary["cg_iters"]["uniform"] is None


# ---- the residual loop's precision tiers --------------------------------

def test_residual_tiers_one_step_gradient_parity(fitted):  # noqa: F811
    """The alignment loss's gradient at each tier against the JAX package's
    at the same tier.  On the CPU, TF32 does not exist (XLA's CPU dots
    and torch's CPU products are fp32 at every precision), so 'high' is
    held at 'highest''s tolerance (rtol 1e-4, the loss's exp(exp(·))
    amplifying last-bit differences).  'default' rounds the products'
    operands to bf16 (2⁻⁹ relative), which XLA's CPU does not: held
    within 5e-2 of the gradient's largest element, and at least 1e-4 from
    'highest' (the tier takes effect).  The global TF32 flag is restored
    after each tier."""
    text, _, _, js, ps = fitted
    emb = _unit_rows(np.random.default_rng(2), *text.shape)
    grads = {}
    for tier, jprec, tol in (
            ("highest", jax.lax.Precision.HIGHEST, 1e-4),
            ("high", jax.lax.Precision.HIGH, 1e-4),
            ("default", jax.lax.Precision.DEFAULT, 5e-2)):
        jl, jg = jax.value_and_grad(jres.alignment_loss)(
            jnp.asarray(emb), js, EPS, jprec)
        e = _t(emb).requires_grad_(True)
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            loss = residual.alignment_loss(e, ps, EPS, precision=tier)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
        torch.backends.cuda.matmul.allow_tf32 = False
        (g,) = torch.autograd.grad(loss, e)
        scale = float(np.abs(jg).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=tol,
                                   atol=tol * scale, err_msg=tier)
        grads[tier] = g
    assert (grads["default"] - grads["highest"]).abs().max() > 1e-4 * scale
    assert torch.equal(grads["high"], grads["highest"])
    with pytest.raises(ValueError, match="residual_precision"):
        residual.alignment_loss(e, ps, EPS, precision="low")


def test_default_tier_gradient_is_bf16_products():
    """The 'default' tier's product and its input gradient (the JAX custom
    VJP's g @ P at the tier) against plain autograd of the bf16-rounded
    operands (X, P and the incoming gradient g) multiplied in fp32: within
    1e-6 of the largest element, forward and backward.  A backward left
    in fp32 (g @ P unrounded) is more than 100× that away."""
    rng = np.random.default_rng(3)
    X, P, G = (_t(rng.standard_normal(shape).astype(np.float32))
               for shape in ((2, 12, 64), (2, 12, 64), (2, 12, 12)))
    x = X.clone().requires_grad_(True)
    y = residual.tier_product(x, P, "default")
    (g,) = torch.autograd.grad((y * G).sum(), x)

    def bf16(t):
        return t.to(torch.bfloat16).to(torch.float32)

    xr = bf16(X).requires_grad_(True)
    want_y = torch.matmul(xr, bf16(P).transpose(-1, -2))
    (want_g,) = torch.autograd.grad((want_y * bf16(G)).sum(), xr)
    for got, want in ((y, want_y), (g, want_g)):
        scale = want.abs().max().item()
        assert got.dtype == torch.float32
        assert (got - want).abs().max().item() <= 1e-6 * scale
    fp32_backward = torch.matmul(G, P)
    assert (fp32_backward - want_g).abs().max().item() > 1e-4 * scale


def test_residual_unroll_parses_and_changes_nothing(setup):
    """`--dota-residual-unroll` and `--dota-residual-precision` parse; the
    port's loop is eager, so two MODE-DOTA steps with residual learning
    (step 1 runs the 10 Adam steps) give bitwise the same residuals and
    logits either way.  An unknown tier raises JAX's ValueError."""
    _, _, _, _, pmodel, text, pcs, rgbs, targets = setup
    cfg = pcfg_mod.parse_args(["--dota-residual-precision", "default",
                               "--dota-residual-unroll", "true"])
    assert (cfg.dota.residual_precision, cfg.dota.residual_unroll) == (
        "default", True)
    runs = []
    for unroll in (False, True):
        pcfg = pcfg_mod.Config(model=pcfg_mod.ModelConfig(**SMALL),
                               dota=pcfg_mod.DotaConfig(
                                   residual_unroll=unroll))
        step = pengine.make_step_fn(pcfg, pmodel)
        state = pengine.init_state(pcfg, _t(text))
        outs = []
        for t in range(2):
            batch = (_t(pcs[0, t]), _t(rgbs[0, t]), _t(targets[0, t]))
            state, out = step(_t(text), state, batch,
                              noise=torch.full_like(batch[0], 0.5))
            outs.append(out.final_logits)
        runs.append((state.res_state.residuals, outs))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    bad = pcfg_mod.Config(model=pcfg_mod.ModelConfig(**SMALL),
                          dota=pcfg_mod.DotaConfig(residual_precision="low"))
    with pytest.raises(ValueError, match="unknown residual_precision"):
        pengine.make_step_fn(bad, pmodel)
