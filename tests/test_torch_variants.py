"""The other DOTA variants of the port (plain DOTA, GMM-DOTA, adaptive-modes
DOTA: `adapt/{dota,gmm,adaptive}.py` and their engine step) against the
JAX package on the CPU, at a small Uni3D (XLA twins on the JAX side).

None of the three draws noise and none has a residual loop, so each is
held step for step.  GMM-DOTA's init draws from a PRNG key in JAX and from
a torch generator in the port; the tests hand the port JAX's initial
state.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_adapt import SMALL, _t, _unit_rows
from test_torch_streams import B, S, T, streams_setup
from uni_adapter_tpu import config as jcfg_mod
from uni_adapter_tpu import engine as jengine
from uni_adapter_tpu.adapt import adaptive as jadaptive
from uni_adapter_tpu.adapt import dota as jdota
from uni_adapter_tpu.adapt import fusion as jfusion
from uni_adapter_tpu.adapt import gmm as jgmm
from uni_adapter_torch import config as pcfg_mod
from uni_adapter_torch import engine as pengine
from uni_adapter_torch.adapt import adaptive, dota, fusion, gmm
from torch_threads import one_torch_thread  # noqa: F401

EPS = 1e-4
VARIANTS = ("use_dota", "use_gmm_dota", "use_adaptive_dota")
MODULES = {"use_dota": (dota, jdota), "use_gmm_dota": (gmm, jgmm),
           "use_adaptive_dota": (adaptive, jadaptive)}


def to_port(jstate, port_type, shared=()):
    """A JAX state as the port's: every field a tensor; the fields named in
    `shared` (stacked () counts of a vmapped state) as the one () count
    that the streams share."""
    fields = []
    for name, v in zip(port_type._fields, jstate):
        v = np.asarray(v)
        if name in shared:
            assert (v == v.flat[0]).all(), name
            v = v.flat[0]
        fields.append(_t(v))
    return port_type(*fields)


def assert_fields_close(port, jstate, tol, names=None, err=""):
    """Every field (or those named) within rtol = atol = tol; integer and
    bool fields equal."""
    for name in names or port._fields:
        got = getattr(port, name).numpy()
        want = np.asarray(getattr(jstate, name))
        if got.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=err + name)
        else:
            np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                       err_msg=err + name)


# ---- the functions, one step ---------------------------------------------

K, D, BF = 6, 16, 3


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    text = _unit_rows(rng, K, D)
    xs = [_unit_rows(rng, BF, D) for _ in range(2)]
    y = np.asarray(jax.nn.softmax(jnp.asarray(rng.standard_normal((BF, K))
                                              * 3.0), axis=1))
    return text, xs, y


@pytest.mark.parametrize("prior_pre_steps", [None, 5])
def test_dota_fit_update_predict_match(inputs, prior_pre_steps):
    """Two fits + updates from the anchors: the state within rtol 1e-5
    (the inverse Λ, ~1e4 at σ 1e-4, within 2e-4 relative of its largest
    entry: both invert the same fp32 matrix by LU, in other orders), the
    scores before and after within 1e-3 of their scale (|scores| ~1e3)."""
    text, xs, y = inputs
    js = jdota.init(EPS, 1e-4, D, K, jnp.asarray(text.T))
    ps = dota.init(EPS, 1e-4, D, K, _t(text.T))
    assert_fields_close(ps, js, 0)
    for x in xs:
        want = np.asarray(jdota.predict(js, jnp.asarray(x),
                                        prior_pre_steps=prior_pre_steps))
        got = dota.predict(ps, _t(x), prior_pre_steps=prior_pre_steps).numpy()
        np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())
        js = jdota.update(jdota.fit(js, jnp.asarray(x), jnp.asarray(y)), EPS)
        ps = dota.update(dota.fit(ps, _t(x), _t(y)), EPS)
        assert_fields_close(ps, js, 1e-5, ("mu", "c", "sigma",
                                           "cum_soft_labels", "prior_step"))
        lam = np.asarray(js.lam)
        np.testing.assert_allclose(ps.lam.numpy(), lam,
                                   atol=2e-4 * np.abs(lam).max())
    assert ps.prior_step.dtype == torch.int32 and int(ps.prior_step) == 2 * BF


def test_gmm_fit_update_predict_match(inputs):
    """From JAX's initial state (its QR draw), two fits + updates: state
    within 1e-5, the scores within 1e-4 relative to their largest."""
    text, xs, y = inputs
    js = jgmm.init(EPS, 4e-3, D, K, jnp.asarray(text.T), num_modes=3,
                   rng=jax.random.PRNGKey(7))
    ps = to_port(js, gmm.GMMDotaState)
    for x in xs:
        for alpha_max in (0.5, 0.6):
            want = np.asarray(jgmm.predict(js, jnp.asarray(x),
                                           alpha_max=alpha_max))
            got = gmm.predict(ps, _t(x), alpha_max=alpha_max).numpy()
            np.testing.assert_allclose(got, want,
                                       atol=1e-4 * np.abs(want).max())
        js = jgmm.update(jgmm.fit(js, jnp.asarray(x), jnp.asarray(y)), EPS)
        ps = gmm.update(gmm.fit(ps, _t(x), _t(y)), EPS)
        assert_fields_close(ps, js, 1e-5)


def test_gmm_own_init_is_an_orthonormal_perturbation():
    """The port's init from a seeded generator: each class's M offsets from
    its centre are 0.01 times orthonormal rows, the rest as JAX's init."""
    rng = np.random.default_rng(1)
    text = _unit_rows(rng, K, D)
    gen = torch.Generator().manual_seed(3)
    ps = gmm.init(EPS, 4e-3, D, K, _t(text.T), num_modes=3, generator=gen)
    js = jgmm.init(EPS, 4e-3, D, K, jnp.asarray(text.T), num_modes=3)
    off = (ps.mu - _t(text)[:, None, :]).numpy() / 0.01
    gram = np.einsum("kmd,knd->kmn", off, off)
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(3), gram.shape),
                               atol=1e-5)
    assert_fields_close(ps, js, 0, ("sigma", "sigma_reg", "pi", "C",
                                    "class_counts", "total_samples"))


def split_setups(rng):
    """check_and_split inputs: tests/test_variants.py's two (one mode of
    class 0 wide enough to split; a class at its cap), and a fitted state
    with several wide modes a class, so that ranks, caps and reverse
    placement all act."""
    text = _unit_rows(rng, K, D)
    out = []
    st = jadaptive.init(1e-3, 0.004, D, K, jnp.asarray(text.T), max_modes=4)
    out.append((st._replace(var=st.var.at[0, 0, 3].set(1.0),
                            c=st.c.at[0, 0].set(10.0)), 0.5))
    st2 = jadaptive.init(1e-3, 0.004, D, K, jnp.asarray(text.T), max_modes=2)
    out.append((st2._replace(var=st2.var.at[0, 0, 1].set(5.0),
                             c=st2.c.at[0, 0].set(100.0)), 0.1))
    st3 = jadaptive.init(1e-3, 0.004, D, K, jnp.asarray(text.T), max_modes=6)
    for _ in range(3):      # three rounds of splits: 1 → 2 → 4 → 6 (cap)
        st3 = st3._replace(
            var=jnp.where(st3.mask[..., None],
                          jnp.asarray(rng.uniform(0.0, 2.0, st3.var.shape),
                                      jnp.float32), st3.var),
            c=jnp.where(st3.mask, jnp.asarray(rng.uniform(3, 12, st3.c.shape),
                                              jnp.float32), 0.0))
        out.append((st3, 0.8))
        st3 = jadaptive.check_and_split(st3, 0.8, 5.0)
    return out


def test_adaptive_check_and_split_matches():
    """Every setup: mask and slots equal to JAX's, means, variances, counts
    and weights within one fp32 ulp (the same arithmetic, elementwise;
    XLA may fuse μ + ½σ·e into one rounding)."""
    rng = np.random.default_rng(2)
    for i, (js, thr) in enumerate(split_setups(rng)):
        want = jadaptive.check_and_split(js, thr, 5.0)
        got = adaptive.check_and_split(to_port(js, adaptive.AdaptiveState),
                                       thr, 5.0)
        assert_fields_close(got, want, 2e-7, err=f"setup {i}: ")
        assert (adaptive.get_mode_stats(got)
                == jadaptive.get_mode_stats(want)), i
    assert adaptive.get_mode_stats(got)["max"] == 6


def test_adaptive_fit_predict_match(inputs):
    """Six fits from the anchors with a split check every second fit, a low
    threshold and count (splits fire), predict before each: state within
    1e-5, masks equal, scores within 1e-4 of their largest."""
    text, xs, y = inputs
    js = jadaptive.init(EPS, 4e-3, D, K, jnp.asarray(text.T), max_modes=3)
    ps = adaptive.init(EPS, 4e-3, D, K, _t(text.T), max_modes=3)
    assert_fields_close(ps, js, 0)
    for x in xs * 3:
        want = np.asarray(jadaptive.predict(js, jnp.asarray(x), EPS))
        got = adaptive.predict(ps, _t(x), EPS).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
        js = jadaptive.fit(js, jnp.asarray(x), jnp.asarray(y), EPS,
                           split_threshold=1e-3, min_count_to_split=0.5,
                           split_check_interval=2)
        ps = adaptive.fit(ps, _t(x), _t(y), EPS, split_threshold=1e-3,
                          min_count_to_split=0.5, split_check_interval=2)
        assert_fields_close(ps, js, 1e-5)
    assert int(adaptive.num_modes_per_class(ps).sum()) > K


@pytest.mark.parametrize("variant", VARIANTS)
def test_stream_axis_is_each_streams_own(inputs, variant):
    """S = 3 stacked states through fit/update/predict on (S, B, ...)
    inputs against each stream alone: the scores within 1e-5 of their
    largest, the state within 1e-6 (batched against single products;
    DOTA's Λ within 1e-4 of its largest: a last-bit difference in μ, of
    the batched product, through the inverse)."""
    text, xs, y = inputs
    mod = MODULES[variant][0]
    rng = np.random.default_rng(5)
    gen = torch.Generator().manual_seed(0)
    if variant == "use_dota":
        singles = [dota.init(EPS, 1e-4, D, K, _t(text.T)) for _ in range(S)]
    elif variant == "use_gmm_dota":
        singles = [gmm.init(EPS, 4e-3, D, K, _t(text.T), 3, generator=gen)
                   for _ in range(S)]
    else:
        singles = [adaptive.init(EPS, 4e-3, D, K, _t(text.T), 3)
                   for _ in range(S)]
    stacked = pengine._stack(singles)
    for _ in range(2):
        x = np.stack([_unit_rows(rng, BF, D) for _ in range(S)])
        if variant == "use_adaptive_dota":
            got = mod.predict(stacked, _t(x), EPS)
            stacked = mod.fit(stacked, _t(x), _t(np.stack([y] * S)), EPS,
                              1e-3, 0.5, 1)
        else:
            got = mod.predict(stacked, _t(x))
            stacked = mod.update(mod.fit(stacked, _t(x),
                                         _t(np.stack([y] * S))), EPS)
        for c in range(S):
            if variant == "use_adaptive_dota":
                want = mod.predict(singles[c], _t(x[c]), EPS)
                singles[c] = mod.fit(singles[c], _t(x[c]), _t(y), EPS, 1e-3,
                                     0.5, 1)
            else:
                want = mod.predict(singles[c], _t(x[c]))
                singles[c] = mod.update(mod.fit(singles[c], _t(x[c]), _t(y)),
                                        EPS)
            torch.testing.assert_close(got[c], want, rtol=0,
                                       atol=1e-5 * want.abs().max().item())
    for c in range(S):
        for name, a, b in zip(stacked._fields, stacked, singles[c]):
            tol = 1e-4 * b.abs().max().item() if name == "lam" else 1e-6
            torch.testing.assert_close(a if a.dim() == 0 else a[c], b,
                                       rtol=1e-6, atol=tol, msg=name)


def test_fuse_dota_matches():
    rng = np.random.default_rng(0)
    clip, dl = (rng.standard_normal((2, 5)).astype(np.float32)
                for _ in range(2))
    w = np.float32(0.07)
    np.testing.assert_allclose(
        fusion.fuse_dota(_t(clip), _t(dl), torch.tensor(w)).numpy(),
        np.asarray(jfusion.fuse_dota(jnp.asarray(clip), jnp.asarray(dl), w)),
        rtol=1e-6)


# ---- the engine's step against JAX's scan --------------------------------

@pytest.fixture(scope="module")
def setup():
    return streams_setup()


def configs(variant, **dota):
    flags = dict(use_mode_dota=False, **{variant: True}, **dota)
    return (jcfg_mod.Config(model=jcfg_mod.ModelConfig(**SMALL),
                            dota=jcfg_mod.DotaConfig(**flags)),
            pcfg_mod.Config(model=pcfg_mod.ModelConfig(**SMALL),
                            dota=pcfg_mod.DotaConfig(**flags)))


SHARED = ("prior_step", "total_samples", "t", "fit_calls")


def port_initial(variant, pcfg, text, js):
    """The port's initial carry; GMM-DOTA's from JAX's initial state."""
    if variant != "use_gmm_dota":
        return None
    state = pengine.init_state(pcfg, _t(text))
    state.method_state = to_port(js.method_state, gmm.GMMDotaState, SHARED)
    return state


def state_tol(variant):
    """Plain DOTA's Λ is an fp32 inverse: held relative to its largest
    entry (test_dota_fit_update_predict_match)."""
    return ({"lam": 2e-4} if variant == "use_dota" else {})


def assert_method_state_close(port, jstate, variant, err=""):
    names = [n for n in port._fields if n not in state_tol(variant)]
    assert_fields_close(port, jstate, 1e-5, names, err)
    for n, rel in state_tol(variant).items():
        want = np.asarray(getattr(jstate, n))
        np.testing.assert_allclose(getattr(port, n).numpy(), want,
                                   atol=rel * np.abs(want).max(),
                                   err_msg=err + n)


def assert_outputs_close(outs, jouts):
    """Final and clip logits within atol 1e-3 (100·cosine scale, with
    DOTA's ~1e2 scores added), correct counts identical."""
    for name in ("final_logits", "clip_logits"):
        np.testing.assert_allclose(getattr(outs, name).numpy(),
                                   np.asarray(getattr(jouts, name)),
                                   atol=1e-3, err_msg=name)
    np.testing.assert_array_equal(outs.correct.numpy(),
                                  np.asarray(jouts.correct))
    np.testing.assert_array_equal(outs.zs_correct.numpy(),
                                  np.asarray(jouts.zs_correct))


@pytest.mark.parametrize("variant", VARIANTS)
def test_scan_matches_jax_scan(setup, variant):
    """One stream of T steps through the port's `run_stream_scan` and its
    eager loop against JAX `run_stream_scan`: every step's logits within
    atol 1e-3, counts identical, the final state within 1e-5 (Λ relative,
    see state_tol); scan and eager loop bitwise equal."""
    jmodel, params, pmodel, text, pcs, rgbs, targets = setup
    jcfg, pcfg = configs(variant)
    stream = tuple(a[0] for a in (pcs, rgbs, targets))
    js0 = jengine.init_state(jcfg, jnp.asarray(text), jax.random.PRNGKey(42))
    js, jouts = jengine.run_stream_scan(jcfg, jmodel, params,
                                        jnp.asarray(text),
                                        *map(jnp.asarray, stream), seed=42)
    init = port_initial(variant, pcfg, text, js0)
    state, outs = pengine.run_stream_scan(pcfg, pmodel, _t(text), *stream,
                                          initial_state=init)
    assert_outputs_close(outs, jouts)
    assert state.step == int(js.step) == T
    assert_method_state_close(state.method_state, js.method_state, variant)
    step, eager = pengine.make_step_fn(pcfg, pmodel), []

    def recorded(*args):
        state, out = step(*args)
        eager.append(out)
        return state, out

    res = pengine.run_stream(pcfg, pmodel, _t(text), zip(*stream),
                             initial_state=init, step_fn=recorded)
    assert torch.equal(pengine.stack_outputs(eager).final_logits,
                       outs.final_logits)
    assert res["acc1"] == pengine.summarize(outs, T * B)["acc1"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_streams_scan_matches_jax_vmapped(setup, variant):
    """S = 3 streams through the port's `run_streams_scan` (GMM-DOTA from
    JAX's stacked initial states) against JAX `run_streams_vmapped`:
    logits within atol 1e-3 every step, counts and summaries identical,
    the final states within 1e-5 (Λ relative)."""
    jmodel, params, pmodel, text, pcs, rgbs, targets = setup
    jcfg, pcfg = configs(variant)
    jstates, jouts = jengine.run_streams_vmapped(
        jcfg, jmodel, params, jnp.asarray(text), pcs, rgbs, targets, seed=42)
    if variant == "use_gmm_dota":
        j0 = jengine.init_states_vmapped(jcfg, jnp.asarray(text), S, 42)
        state = pengine.init_states_streams(pcfg, _t(text), S)
        state.method_state = to_port(j0.method_state, gmm.GMMDotaState,
                                     SHARED)
        scan_fn = pengine.make_scan_fn(pcfg, pmodel)
        state, outs = scan_fn(_t(text), state, *(
            _t(a).transpose(0, 1) for a in (pcs, rgbs, targets)))
    else:
        state, outs = pengine.run_streams_scan(pcfg, pmodel, _t(text), pcs,
                                               rgbs, targets)
    assert outs.final_logits.shape == (T, S, B, text.shape[0])
    assert_outputs_close(outs, jouts)
    assert (pengine.summarize_streams(outs, T * B)
            == jengine.summarize_vmapped(jouts, T * B))
    jms = jstates.method_state
    jms = jms._replace(**{n: getattr(jms, n)[0] for n in SHARED
                          if n in jms._fields})
    assert_method_state_close(state.method_state, jms, variant)


def test_adaptive_split_inside_the_scan_matches_jax(setup):
    """60 steps at σ 5e-4 (split threshold 5e-3): the split check at fit
    50 fires inside the port's scan as in JAX's; the final mask equal to
    JAX's, the mode count above K, the valid slots a contiguous prefix,
    every step's logits within atol 1e-3 and the final state within 1e-4
    (60 steps of fp32 EM)."""
    jmodel, params, pmodel, text, _, _, _ = setup
    jcfg, pcfg = configs("use_adaptive_dota", sigma=5e-4)
    rng = np.random.default_rng(9)
    n = 60
    pcs = rng.standard_normal((n, 1, 128, 3)).astype(np.float32)
    targets = rng.integers(0, text.shape[0], (n, 1)).astype(np.int32)
    js, jouts = jengine.run_stream_scan(
        jcfg, jmodel, params, jnp.asarray(text), jnp.asarray(pcs),
        jnp.ones_like(pcs), jnp.asarray(targets), seed=42)
    state, outs = pengine.run_stream_scan(pcfg, pmodel, _t(text), pcs,
                                          np.ones_like(pcs), targets)
    ms = state.method_state
    np.testing.assert_array_equal(ms.mask.numpy(),
                                  np.asarray(js.method_state.mask))
    counts = adaptive.num_modes_per_class(ms).numpy()
    assert counts.sum() > text.shape[0]
    for k, nk in enumerate(counts):
        assert ms.mask[k, :nk].all() and not ms.mask[k, nk:].any()
    assert_outputs_close(outs, jouts)
    assert_fields_close(ms, js.method_state, 1e-4)
    assert int(ms.fit_calls) == n


def test_continual_chain_matches_jax(setup):
    """Adaptive DOTA through two corruption streams, the second from the
    first's carry (`--continual`): against JAX `run_stream_scan`
    (initial_state=...) step for step, logits within 1e-3, the final state
    within 1e-5, the step counters 0 → T → 2T."""
    jmodel, params, pmodel, text, pcs, rgbs, targets = setup
    jcfg, pcfg = configs("use_adaptive_dota")
    js = state = None
    for c in range(2):
        stream = tuple(a[c] for a in (pcs, rgbs, targets))
        js, jouts = jengine.run_stream_scan(
            jcfg, jmodel, params, jnp.asarray(text),
            *map(jnp.asarray, stream), seed=42, initial_state=js)
        state, outs = pengine.run_stream_scan(pcfg, pmodel, _t(text),
                                              *stream, initial_state=state)
        assert_outputs_close(outs, jouts)
        assert state.step == int(js.step) == T * (c + 1)
    assert_fields_close(state.method_state, js.method_state, 1e-5)
