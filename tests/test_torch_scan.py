"""The port's stream scan (`engine.run_stream_scan`, `run_streams_scan`,
`--use-scan`) against the JAX package's `run_stream_scan` and
`run_streams_vmapped` on the CPU, at a small Uni3D (XLA twins on the JAX
side), and against the port's own eager loop.

On the CPU the scan runs the same in-place step body as it replays on the
card, eagerly: the carry, the anchors and an input slot are static
tensors, and each step writes the new carry into them.  Where the JAX
side draws MODE-DOTA's noise, the port's step is handed the same draws
from the JAX scan's key chain.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_adapt import _t
from test_torch_cache import (assert_cache_close, assert_outputs_close,
                              cache_setup, collecting)
from test_torch_streams import (B, CLI_SMALL, STATE_FIELDS,
                                corruption_root, configs,  # noqa: F401
                                jax_noise, stream_noise, streams_setup)
from uni_adapter_tpu import engine as jengine
from uni_adapter_torch import engine as pengine
from uni_adapter_torch.cli import tta
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def mode_dota():
    return streams_setup()


@pytest.fixture(scope="module")
def cache():
    return cache_setup()


def fed_scan(pcfg, pmodel, noises):
    """The port's scan with its step's noise taken from `noises` in turn."""
    scan_fn = pengine.make_scan_fn(pcfg, pmodel)
    step, it = scan_fn.step, iter(noises)
    scan_fn.step = pengine.Step(
        lambda text, state, batch, noise=None: step.parts(
            text, state, batch, _t(next(it))))
    return scan_fn


def assert_steps_close(outs, jouts, n_steps):
    """Final and clip logits within atol 1e-3 (100·cosine) every step,
    correct counts identical."""
    for t in range(n_steps):
        for name in ("final_logits", "clip_logits"):
            np.testing.assert_allclose(
                getattr(outs, name)[t].numpy(),
                np.asarray(getattr(jouts, name)[t]), atol=1e-3,
                err_msg=f"{name}, step {t}")
        np.testing.assert_array_equal(outs.correct[t].numpy(),
                                      np.asarray(jouts.correct[t]))
        np.testing.assert_array_equal(outs.zs_correct[t].numpy(),
                                      np.asarray(jouts.zs_correct[t]))


@pytest.mark.parametrize("res_learning,n_steps", [(False, 4), (True, 2)])
def test_scan_matches_jax_scan(mode_dota, res_learning, n_steps):
    """One stream through the port's `run_stream_scan` and JAX's, the JAX
    scan's noise fed to the port: every step's logits within atol 1e-3
    and identical counts.  Residual learning off: the final mixtures
    within 1e-4.  On (step 1 runs the 10 Adam steps): the residuals in
    the envelope of test_engine_matches_first_two_steps_with_residuals,
    and the Adam count and the sample count, device tensors in the port,
    equal to optax's int32 count and JAX's `t`."""
    jmodel, params, pmodel, text, pcs, rgbs, targets = mode_dota
    jcfg, pcfg = configs(res_learning)
    stream = tuple(a[0, :n_steps] for a in (pcs, rgbs, targets))
    js, jouts = jengine.run_stream_scan(
        jcfg, jmodel, params, jnp.asarray(text), *map(jnp.asarray, stream),
        seed=42)
    state, outs = pengine.run_stream_scan(
        pcfg, pmodel, _t(text), *stream,
        scan_fn=fed_scan(pcfg, pmodel, jax_noise(n_steps, seed=42)))
    assert_steps_close(outs, jouts, n_steps)
    assert outs.final_logits.shape == (n_steps, B, text.shape[0])
    assert pengine.summarize(outs, n_steps * B) == jengine.summarize(
        jouts, n_steps * B)
    assert state.step == int(js.step) == n_steps
    t = state.method_state.t
    assert t.dtype == torch.int32 and t.shape == ()
    assert int(t) == int(js.method_state.t) == 2 * n_steps * B
    if not res_learning:
        for name in STATE_FIELDS:
            np.testing.assert_allclose(
                getattr(state.method_state, name).numpy(),
                np.asarray(getattr(js.method_state, name)), rtol=1e-4,
                atol=1e-4, err_msg=name)
        return
    d = np.abs(state.res_state.residuals.numpy()
               - np.asarray(js.res_state.residuals))
    assert np.median(d) < 1e-6 and np.quantile(d, 0.9) < 2e-4, (
        np.median(d), np.quantile(d, 0.9))
    count, jcount = state.res_state.count, js.res_state.opt_state[0].count
    assert count.dtype == torch.int32 and jcount.dtype == jnp.int32
    assert int(count) == int(jcount) == 10


def test_streams_scan_matches_jax_vmapped(mode_dota):
    """3 streams through the port's `run_streams_scan` (the S-stream step,
    one generator a stream) against JAX `run_streams_vmapped`, each
    stream's noise from its key: logits within atol 1e-3 every step,
    counts and summaries identical, mixtures within 1e-4; outputs (T, S,
    ...)."""
    jmodel, params, pmodel, text, pcs, rgbs, targets = mode_dota
    jcfg, pcfg = configs(False)
    S, T = pcs.shape[:2]
    jstates, jouts = jengine.run_streams_vmapped(
        jcfg, jmodel, params, jnp.asarray(text), pcs, rgbs, targets, seed=42)
    state, outs = pengine.run_streams_scan(
        pcfg, pmodel, _t(text), pcs, rgbs, targets,
        scan_fn=fed_scan(pcfg, pmodel, stream_noise(T)))
    assert outs.final_logits.shape == (T, S, B, text.shape[0])
    assert_steps_close(outs, jouts, T)
    assert (pengine.summarize_streams(outs, T * B)
            == jengine.summarize_vmapped(jouts, T * B))
    for name in STATE_FIELDS:
        np.testing.assert_allclose(
            getattr(state.method_state, name).numpy(),
            np.asarray(getattr(jstates.method_state, name)), rtol=1e-4,
            atol=1e-4, err_msg=name)


def per_step(outs):
    """A StepOutput with a leading T axis as T StepOutputs."""
    return [pengine.StepOutput(*(None if f is None else f[t] for f in outs))
            for t in range(len(outs.final_logits))]


def test_cache_scan_matches_jax_and_the_eager_cg(cache):
    """The cache path through the port's `run_stream_scan` against JAX's:
    logits within test_torch_cache's tolerance (final 1e-5, clip 1e-4),
    counts identical, the cache within 1e-5; the CG's iterations step by
    step equal to the eager loop's (`run_stream`), which
    test_torch_cache holds to JAX's per-stream stops.  The S-stream scan
    of 3 streams likewise against `run_streams_vmapped`, each stream's
    iterations its own."""
    jcfg, pcfg, jmodel, params, pmodel, text, pcs, rgbs, targets = cache
    js, jouts = jengine.run_stream_scan(
        jcfg, jmodel, params, jnp.asarray(text), pcs[0], rgbs[0],
        targets[0], seed=42)
    state, outs = pengine.run_stream_scan(pcfg, pmodel, _t(text), pcs[0],
                                          rgbs[0], targets[0])
    assert_outputs_close(per_step(outs), jouts)
    assert_cache_close(state.method_state, js.method_state, 1e-5)
    eager = pengine.run_stream(pcfg, pmodel, _t(text),
                               zip(pcs[0], rgbs[0], targets[0]))
    assert outs.cg_iters.tolist() == eager["cg_iters"]
    assert min(eager["cg_iters"]) >= 1

    jstates, jouts = jengine.run_streams_vmapped(
        jcfg, jmodel, params, jnp.asarray(text), pcs, rgbs, targets, seed=42)
    states, outs = pengine.run_streams_scan(pcfg, pmodel, _t(text), pcs,
                                            rgbs, targets)
    assert_outputs_close(per_step(outs), jouts)
    assert_cache_close(states.method_state, jstates.method_state, 1e-5)
    eager = pengine.run_streams(pcfg, pmodel, _t(text), pcs, rgbs, targets)
    assert torch.equal(outs.cg_iters, pengine.stack_outputs(
        eager["outputs"]).cg_iters)


def assert_states_equal(got, want):
    assert got.step == want.step
    for part in ("method_state", "res_state"):
        for a, b in zip(getattr(got, part) or (), getattr(want, part) or (),
                        strict=True):
            assert torch.equal(a, b), part
    assert torch.equal(got.generator.get_state(), want.generator.get_state())


def test_chained_scans_equal_one_concatenated_scan(mode_dota):
    """A stream split in two and chained through `initial_state` equals
    the whole stream in one scan, bitwise (residual learning on: the
    second part starts past step 0, so it runs the Adam loop from its
    first step; the carry holds the mixture, the residuals, their Adam
    moments and count, the generator and the step counter), on one
    reused scan_fn (the JAX chaining oracle, tests/test_continual.py)."""
    _, _, pmodel, text, pcs, rgbs, targets = mode_dota
    _, pcfg = configs(True)
    stream = tuple(a[0] for a in (pcs, rgbs, targets))
    scan_fn = pengine.make_scan_fn(pcfg, pmodel)
    want, want_outs = pengine.run_stream_scan(pcfg, pmodel, _t(text),
                                              *stream, seed=7,
                                              scan_fn=scan_fn)
    a, outs_a = pengine.run_stream_scan(pcfg, pmodel, _t(text),
                                        *(x[:1] for x in stream), seed=7,
                                        scan_fn=scan_fn)
    b, outs_b = pengine.run_stream_scan(pcfg, pmodel, _t(text),
                                        *(x[1:] for x in stream),
                                        initial_state=a, scan_fn=scan_fn)
    assert b.step == 4 and a.step == 1
    assert_states_equal(b, want)
    for f, x, y in zip(want_outs, outs_a, outs_b):
        if f is not None:
            assert torch.equal(f, torch.cat([x, y]))


@pytest.mark.parametrize("res_learning", [False, True])
def test_scan_equals_the_eager_loop_bitwise(mode_dota, cache, res_learning):
    """`run_stream_scan` against `run_stream` on the CPU: the same step
    body on the same inputs, so every output and the final carry are
    equal bitwise: MODE-DOTA with residual learning off and on, and (with
    it on) the cache path."""
    _, _, pmodel, text, pcs, rgbs, targets = mode_dota
    _, pcfg = configs(res_learning)
    runs = [(pcfg, pmodel, text, tuple(a[1] for a in (pcs, rgbs, targets)))]
    if res_learning:
        _, ccfg, _, _, cmodel, ctext, cpcs, crgbs, ctargets = cache
        runs.append((ccfg, cmodel, ctext,
                     tuple(a[1] for a in (cpcs, crgbs, ctargets))))
    for cfg, model, bank, stream in runs:
        outs = []
        eager = pengine.run_stream(
            cfg, model, _t(bank), zip(*stream), seed=3,
            step_fn=collecting(pengine.make_step_fn(cfg, model), outs))
        state, scanned = pengine.run_stream_scan(cfg, model, _t(bank),
                                                 *stream, seed=3)
        for got, want in zip(scanned, pengine.stack_outputs(outs),
                             strict=True):
            assert (got is None and want is None) or torch.equal(got, want)
        assert_states_equal(state, eager["state"])


@pytest.mark.parametrize("flags", [
    ["--corruption", "uniform"],
    ["--dota-use-mode-dota", "false", "--corruption", "all",
     "--vmap-corruptions", "true"]])
def test_cli_use_scan_true_and_false_write_the_same_results(
        corruption_root, tmp_path, flags):  # noqa: F811
    """`--use-scan` (default true: `run_stream_scan` or
    `run_streams_scan`) and `--use-scan false` (the eager loops) write the
    same result files and report the same step counters, CG iterations
    and finiteness: MODE-DOTA with residuals on one corruption, and the
    cache's 15-corruption sweep."""
    argv = ["--device", "cpu", "--root", str(corruption_root),
            "--output-dir", str(tmp_path / "out"), *CLI_SMALL, *flags]
    assert tta.parse_args(argv).run.use_scan
    assert not tta.parse_args([*argv, "--use-scan", "false"]).run.use_scan
    got = {}
    for scan in ("true", "false"):
        summary = tta.main([*argv, "--use-scan", scan, "--name", scan])
        got[scan] = ([json.loads((tmp_path / "out" / scan / f).read_text())
                      for f in ("results.json", "results_zs.json")],
                     summary["steps"], summary["cg_iters"], summary["finite"])
    assert got["true"] == got["false"]
    assert all(got["true"][3].values())
