"""The stream axis of the port (`engine.run_streams`, `--vmap-corruptions`)
and continual TTA (`run_stream(initial_state=...)`, `--continual`) against
the JAX package on the CPU, at a small Uni3D (XLA twins on the JAX side).

S streams run together must each follow the trajectory that stream would
follow alone.  The noise of each stream's fused clean + noise-augmented
forward is drawn with `jax.random` from that stream's key chain, exactly
as the JAX step draws it, and handed to the port's step.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_adapt import EPS, SMALL, _t, _unit_rows
from uni_adapter_tpu import config as jcfg_mod
from uni_adapter_tpu import engine as jengine
from uni_adapter_tpu.models.uni3d import create_uni3d as jax_create_uni3d
from uni_adapter_torch import config as pcfg_mod
from uni_adapter_torch import engine as pengine
from uni_adapter_torch.adapt import mode_dota, residual
from uni_adapter_torch.cli import tta
from uni_adapter_torch.config import CORRUPTIONS
from uni_adapter_torch.models.uni3d import create_uni3d
from uni_adapter_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401


S, T, B, N, K = 3, 4, 1, 128, 10
STATE_FIELDS = ("mu", "var", "pi", "c", "class_counts")


@pytest.fixture(scope="module")
def setup():
    return streams_setup()


def streams_setup():
    """One small Uni3D in both packages, anchors, and S streams of T
    steps."""
    jmodel = jax_create_uni3d(jcfg_mod.ModelConfig(**SMALL))
    rng = np.random.default_rng(3)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, N, 6), jnp.float32))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        .astype(np.float32), params)
    pmodel = create_uni3d(pcfg_mod.ModelConfig(**SMALL), "cpu",
                          state_dict=from_jax_params(params))
    text = _unit_rows(rng, K, SMALL["embed_dim"])
    pcs = rng.standard_normal((S, T, B, N, 3)).astype(np.float32)
    targets = rng.integers(0, K, (S, T, B)).astype(np.int32)
    return jmodel, params, pmodel, text, pcs, np.ones_like(pcs), targets


def configs(res_learning: bool):
    return (jcfg_mod.Config(model=jcfg_mod.ModelConfig(**SMALL),
                            dota=jcfg_mod.DotaConfig(
                                res_learning=res_learning)),
            pcfg_mod.Config(model=pcfg_mod.ModelConfig(**SMALL),
                            dota=pcfg_mod.DotaConfig(
                                res_learning=res_learning)))


def jax_noise(n_steps, seed=None, key=None):
    """The noise the JAX step draws over `n_steps` steps from the carried
    key (PRNGKey(seed) or `key`): split, normal from the second half."""
    key = jax.random.PRNGKey(seed) if key is None else key
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, (B, N, 3), jnp.float32)))
    return np.stack(out)


def feeding(step, noises, outputs=None):
    """The step with its noise taken from `noises` in turn (and its
    outputs appended to `outputs`)."""
    it = iter(noises)

    def fed(text, state, batch):
        state, out = step(text, state, batch, noise=_t(next(it)))
        if outputs is not None:
            outputs.append(out)
        return state, out

    return fed


def stream_noise(n_steps):
    """(T, S, B, N, 3): stream c's draws from PRNGKey(42 + c)."""
    return np.stack([jax_noise(n_steps, 42 + c) for c in range(S)], axis=1)


def run_both(setup, res_learning, n_steps):
    jmodel, params, pmodel, text, pcs, rgbs, targets = setup
    jcfg, pcfg = configs(res_learning)
    cut = lambda a: a[:, :n_steps]                          # noqa: E731
    jstates, jouts = jengine.run_streams_vmapped(
        jcfg, jmodel, params, jnp.asarray(text), cut(pcs), cut(rgbs),
        cut(targets), seed=42)
    res = pengine.run_streams(
        pcfg, pmodel, _t(text), cut(pcs), cut(rgbs), cut(targets), seed=42,
        step_fn=feeding(pengine.make_step_fn(pcfg, pmodel),
                        stream_noise(n_steps)))
    for t, out in enumerate(res["outputs"]):
        np.testing.assert_allclose(out.final_logits.numpy(),
                                   np.asarray(jouts.final_logits[t]),
                                   atol=1e-3)
        np.testing.assert_allclose(out.clip_logits.numpy(),
                                   np.asarray(jouts.clip_logits[t]),
                                   atol=1e-3)
        np.testing.assert_array_equal(out.correct.numpy(),
                                      np.asarray(jouts.correct[t]))
        np.testing.assert_array_equal(out.zs_correct.numpy(),
                                      np.asarray(jouts.zs_correct[t]))
    assert res["finite"] == [True] * S
    assert len(res["step_ms"]) == n_steps
    assert (pengine.summarize_streams(res["outputs"], n_steps * B)
            == jengine.summarize_vmapped(jouts, n_steps * B))
    return jstates, res["state"]


def test_streams_match_jax_vmapped_without_residuals(setup):
    """(a) 3 streams x 4 steps, residual learning off: logits within atol
    1e-3 (100·cosine), equal correct counts and summaries, mixtures
    within 1e-4."""
    jstates, state = run_both(setup, False, T)
    for name in STATE_FIELDS:
        np.testing.assert_allclose(
            getattr(state.method_state, name).numpy(),
            np.asarray(getattr(jstates.method_state, name)), rtol=1e-4,
            atol=1e-4, err_msg=name)
    assert state.step == T and state.method_state.t == 2 * T * B


def test_streams_match_jax_vmapped_with_residuals(setup):
    """(b) residual learning on for 2 steps (step 1 runs the 10 Adam
    steps): logits as in (a); residuals in distribution, as
    test_torch_adapt holds the single stream's (Adam's first steps move
    near-zero-gradient elements by ±lr on a last-bit difference)."""
    jstates, state = run_both(setup, True, 2)
    d = np.abs(state.res_state.residuals.numpy()
               - np.asarray(jstates.res_state.residuals))
    assert d.shape == (S, K, SMALL["embed_dim"])
    assert np.median(d) < 1e-6 and np.quantile(d, 0.9) < 2e-4, (
        np.median(d), np.quantile(d, 0.9))
    assert state.res_state.count == 10


@pytest.mark.parametrize("res_learning,n_steps", [(False, T), (True, 2)])
def test_stream_step_matches_its_single_stream_step(setup, res_learning,
                                                    n_steps):
    """(c) the port's step on (S, B, ...) batches against the same step on
    each stream alone, same noise: logits within atol 1e-4 (fp32 rounding
    of batched against single products; 100·cosine), equal correct
    counts; with residual learning, 2 steps as in (b) and the residuals
    in distribution."""
    _, _, pmodel, text, pcs, rgbs, targets = setup
    _, pcfg = configs(res_learning)
    step = pengine.make_step_fn(pcfg, pmodel)
    noise = stream_noise(n_steps)
    text = _t(text)
    states = pengine.init_states_streams(pcfg, text, S)
    singles = [pengine.init_state(pcfg, text, 42 + c) for c in range(S)]
    for t in range(n_steps):
        batch = tuple(_t(a[:, t]) for a in (pcs, rgbs, targets))
        states, out = step(text, states, batch, noise=_t(noise[t]))
        for c in range(S):
            singles[c], want = step(text, singles[c],
                                    tuple(x[c] for x in batch),
                                    noise=_t(noise[t, c]))
            for name in ("final_logits", "clip_logits"):
                np.testing.assert_allclose(getattr(out, name)[c].numpy(),
                                           getattr(want, name).numpy(),
                                           atol=1e-4)
            np.testing.assert_array_equal(out.correct[c].numpy(),
                                          want.correct.numpy())
            np.testing.assert_array_equal(out.zs_correct[c].numpy(),
                                          want.zs_correct.numpy())
    assert states.step == n_steps
    if res_learning:
        d = np.abs(states.res_state.residuals.numpy() - np.stack(
            [s.res_state.residuals.numpy() for s in singles]))
        assert np.median(d) < 1e-6 and np.quantile(d, 0.9) < 2e-4
        assert states.res_state.count == 10


def test_batched_alignment_loss_is_each_streams_own():
    """(d) the loss and gradient of 3 stacked mixtures whose
    log-likelihood matrices have different scales (so different maxima)
    against each mixture's own `alignment_loss` and gradient."""
    rng = np.random.default_rng(0)
    Kd, D, Bd = 6, 16, 3
    text = _unit_rows(rng, Kd, D)
    states = []
    for scale in (0.5, 1.0, 4.0):
        s = mode_dota.init(EPS, 1e-4, D, Kd, _t(text.T))
        gamma = torch.softmax(_t(rng.standard_normal((Bd, Kd))) * 3.0, 1)
        s = mode_dota.fit(s, _t(_unit_rows(rng, Bd, D)), gamma, EPS)
        states.append(s._replace(var=s.var * scale))
    emb = [_t(_unit_rows(rng, Kd, D)) for _ in states]
    stacked = pengine._stack(states)
    e = torch.stack(emb).requires_grad_(True)
    losses = residual.alignment_loss(e, stacked, EPS)
    (g,) = torch.autograd.grad(losses.sum(), e)
    assert losses.shape == (3,)
    for i, (s, x) in enumerate(zip(states, emb)):
        x = x.clone().requires_grad_(True)
        want = residual.alignment_loss(x, s, EPS)
        (want_g,) = torch.autograd.grad(want, x)
        np.testing.assert_allclose(losses[i].item(), want.item(), rtol=1e-5)
        np.testing.assert_allclose(g[i].numpy(), want_g.numpy(), rtol=1e-5,
                                   atol=1e-5 * want_g.abs().max().item())


def test_continual_chain_equals_concatenated_and_matches_jax(setup):
    """(e) stream A, then stream B from A's carry, equals the one stream
    A+B: bitwise, residual learning on (the carry holds the mixture, the
    residuals and their Adam moments, the generator and the step
    counter).  Then against JAX `run_stream_scan(initial_state=...)`
    step for step (residual learning off; JAX's noise): logits within
    atol 1e-3, equal counts, the carried step counter and mixture."""
    jmodel, params, pmodel, text, pcs, rgbs, targets = setup
    batches = [(pcs[0, t], rgbs[0, t], targets[0, t]) for t in range(T)]
    _, pcfg = configs(True)
    step = pengine.make_step_fn(pcfg, pmodel)
    want = pengine.run_stream(pcfg, pmodel, _t(text), batches, seed=7,
                              step_fn=step)
    res_a = pengine.run_stream(pcfg, pmodel, _t(text), batches[:2], seed=7,
                               step_fn=step)
    res_b = pengine.run_stream(pcfg, pmodel, _t(text), batches[2:], seed=7,
                               step_fn=step, initial_state=res_a["state"])
    assert res_b["state"].step == want["state"].step == T
    for part in ("method_state", "res_state"):
        for got, wnt in zip(getattr(res_b["state"], part),
                            getattr(want["state"], part)):
            assert (torch.equal(got, wnt) if isinstance(got, torch.Tensor)
                    else got == wnt)
    for key in ("acc1", "acc3", "acc5", "zs_acc1"):
        assert res_a[key] / 2 + res_b[key] / 2 == pytest.approx(
            want[key], abs=1e-9)

    jcfg, pcfg = configs(False)
    scan_fn = jax.jit(jengine.make_scan_fn(jcfg, jmodel))
    half = lambda a, lo: jnp.asarray(a[0, lo:lo + 2])       # noqa: E731
    js_a, jo_a = jengine.run_stream_scan(
        jcfg, jmodel, params, jnp.asarray(text), half(pcs, 0),
        half(rgbs, 0), half(targets, 0), seed=7, scan_fn=scan_fn)
    js_b, jo_b = jengine.run_stream_scan(
        jcfg, jmodel, params, jnp.asarray(text), half(pcs, 2),
        half(rgbs, 2), half(targets, 2), seed=7, scan_fn=scan_fn,
        initial_state=js_a)
    noise = jax_noise(T, seed=7)
    outs = []
    step = pengine.make_step_fn(pcfg, pmodel)
    res_a = pengine.run_stream(pcfg, pmodel, _t(text), batches[:2], seed=7,
                               step_fn=feeding(step, noise[:2], outs))
    res_b = pengine.run_stream(pcfg, pmodel, _t(text), batches[2:],
                               step_fn=feeding(step, noise[2:], outs),
                               initial_state=res_a["state"])
    jouts = [jax.tree_util.tree_map(lambda x: x[t], o)
             for o in (jo_a, jo_b) for t in range(2)]
    for out, jout in zip(outs, jouts, strict=True):
        np.testing.assert_allclose(out.final_logits.numpy(),
                                   np.asarray(jout.final_logits), atol=1e-3)
        np.testing.assert_array_equal(out.correct.numpy(),
                                      np.asarray(jout.correct))
    assert res_b["state"].step == int(js_b.step) == T
    for name in STATE_FIELDS:
        np.testing.assert_allclose(
            getattr(res_b["state"].method_state, name).numpy(),
            np.asarray(getattr(js_b.method_state, name)), rtol=1e-4,
            atol=1e-4, err_msg=name)


CLI_SMALL = ["--npoints", "64", "--eva-depth", "1", "--pc-feat-dim", "64",
             "--num-group", "8", "--group-size", "8",
             "--pc-encoder-dim", "32", "--eva-heads", "4",
             "--compute-dtype", "float32",
             "--precomputed-text-features", "large"]


@pytest.fixture
def corruption_root(tmp_path):
    """The 15 corruption files (2 clouds x 64 points) and their labels."""
    rng = np.random.default_rng(0)
    for corr in CORRUPTIONS:
        np.save(tmp_path / f"data_{corr}_5.npy",
                rng.standard_normal((2, 64, 3)).astype(np.float32))
    np.save(tmp_path / "label.npy", rng.integers(0, 40, (2,)).astype(np.int64))
    return tmp_path


def test_cli_sweep_and_continual(corruption_root, tmp_path):
    """(f) `--corruption all --vmap-corruptions true` writes one key a
    corruption to both result files, 2 shared steps; `--continual true`
    carries the step counter through the 15 corruptions; the two together
    raise the JAX parser's ValueError."""
    argv = ["--device", "cpu", "--root", str(corruption_root),
            "--corruption", "all", "--output-dir", str(tmp_path / "out"),
            *CLI_SMALL]
    summary = tta.main([*argv, "--vmap-corruptions", "true",
                        "--name", "sweep"])
    for name in ("results.json", "results_zs.json"):
        res = json.loads((tmp_path / "out" / "sweep" / name).read_text())
        assert list(res) == list(CORRUPTIONS)
        assert all(0.0 <= v <= 100.0 for v in res.values())
    assert all(summary["finite"].values())
    assert {len(v) for v in summary["step_ms"].values()} == {2}
    assert set(map(tuple, summary["steps"].values())) == {(0, 2)}

    summary = tta.main([*argv, "--continual", "true", "--name", "chain"])
    assert list(summary["steps"].values()) == [
        [2 * i, 2 * i + 2] for i in range(len(CORRUPTIONS))]

    with pytest.raises(ValueError, match="mutually exclusive"):
        tta.main([*argv, "--continual", "true", "--vmap-corruptions",
                  "true"])
