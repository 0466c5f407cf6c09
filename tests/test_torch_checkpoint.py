"""The port's snapshots (`uni_adapter_torch.checkpoint`) and
`engine.run_stream`'s checkpointed resume, on the CPU.

Every method's carry, single and stacked with streams at different
counts, survives a round trip exactly, its generators included; a crash
between the two file replacements leaves the previous snapshot readable;
and a stream interrupted after 4 steps and resumed from its checkpoint
(every 2 steps) ends bitwise where the uninterrupted stream ends (the
JAX package's tests/test_elastic.py::test_interrupt_and_resume).
"""
import os

import jax
import numpy as np
import pytest
import torch

from uni_adapter_tpu import checkpoint as jax_checkpoint
from uni_adapter_torch import checkpoint, engine
from uni_adapter_torch.config import (CacheConfig, Config, DotaConfig,
                                      ModelConfig)
from uni_adapter_torch.models.uni3d import create_uni3d
from torch_threads import one_torch_thread  # noqa: F401

K, D, N, T = 4, 16, 32, 6
SMALL = dict(pc_feat_dim=24, embed_dim=D, num_group=8, group_size=8,
             pc_encoder_dim=16, eva_depth=1, eva_heads=4,
             compute_dtype="float32")
METHODS = {
    "mode_dota_residuals": dict(mode_M=2, res_learning=True),
    "cache": dict(use_mode_dota=False),
    "dota": dict(use_mode_dota=False, use_dota=True, prior_pre_steps=2),
    "gmm": dict(use_mode_dota=False, use_gmm_dota=True, mode_M=2),
    "adaptive": dict(use_mode_dota=False, use_adaptive_dota=True,
                     mode_M=3),
}


@pytest.fixture(scope="module")
def setup():
    model = create_uni3d(ModelConfig(**SMALL), "cpu", seed=0)
    rng = np.random.default_rng(0)
    text = rng.standard_normal((K, D)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    pcs = rng.standard_normal((T, 1, N, 3)).astype(np.float32)
    targets = rng.integers(0, K, (T, 1))
    return model, torch.from_numpy(text), list(zip(
        pcs, np.ones_like(pcs), targets))


def config(method: str) -> Config:
    return Config(model=ModelConfig(**SMALL),
                  dota=DotaConfig(**METHODS[method]),
                  cache=CacheConfig(cg_max_iter=5))


def assert_states_equal(got, want):
    """Tensors bitwise, steps equal, and each generator's next draw equal
    (drawn from copies: the states stay as they are)."""
    assert type(got) is engine.EngineState
    assert got.step == want.step
    for part in ("method_state", "res_state"):
        g, w = getattr(got, part), getattr(want, part)
        assert type(g) is type(w)
        for x, y in zip(g or (), w or (), strict=True):
            assert x.dtype == y.dtype and torch.equal(x, y)
    gens = [engine.copy_generator(g) for s in (got, want)
            for g in engine._generators(s)]
    half = len(gens) // 2
    for a, b in zip(gens[:half], gens[half:], strict=True):
        assert torch.equal(torch.randn(5, generator=a),
                           torch.randn(5, generator=b))


@pytest.mark.parametrize("method", list(METHODS))
def test_every_carry_round_trips(setup, tmp_path, method):
    """One stream after 3 steps, and 2 streams at steps 3 and 1 stacked
    (their counts differ, so they are ([S],) tensors and the step a
    tuple): restored equal, and the stacked one unstacks to its
    streams."""
    model, text, batches = setup
    cfg = config(method)
    one = engine.run_stream(cfg, model, text, batches[:3], seed=5)["state"]
    other = engine.run_stream(cfg, model, text, batches[:1], seed=6)["state"]
    for name, state in (("single", one),
                        ("stacked", engine.stack_states([one, other]))):
        path = str(tmp_path / name)
        checkpoint.save_state(path, state)
        got = checkpoint.restore_state(path)
        assert_states_equal(got, state)
    assert got.step == (3, 1)
    assert_states_equal(engine.unstack_state(got, 0), one)
    assert_states_equal(engine.unstack_state(got, 1), other)


def test_a_crash_between_the_replacements_keeps_the_previous_pair(
        setup, tmp_path, monkeypatch):
    """The structure file is replaced first, the arrays second: a crash
    between the two leaves the new structure beside the previous arrays,
    which it reads (a structure holds no value)."""
    model, text, batches = setup
    cfg = config("mode_dota_residuals")
    first = engine.run_stream(cfg, model, text, batches[:1])["state"]
    second = engine.run_stream(cfg, model, text, batches[:2])["state"]
    path = str(tmp_path / "snap")
    checkpoint.save_state(path, first)
    replace, calls = os.replace, []

    def crash_second(src, dst):
        calls.append(dst)
        if len(calls) == 2:
            raise OSError("crash")
        replace(src, dst)

    monkeypatch.setattr(os, "replace", crash_second)
    with pytest.raises(OSError, match="crash"):
        checkpoint.save_state(path, second)
    monkeypatch.undo()
    assert calls == [path + ".json", path + ".npz"]
    assert_states_equal(checkpoint.restore_state(path), first)


def test_async_snapshot_is_the_state_at_the_call(setup, tmp_path):
    """`AsyncSnapshotter.save` copies the state when called: a change made
    after the call does not reach the file; `wait` drains."""
    model, text, batches = setup
    state = engine.run_stream(config("cache"), model, text,
                              batches[:2])["state"]
    want = engine.clone_state(state)
    with checkpoint.AsyncSnapshotter() as snap:
        snap.save(str(tmp_path / "a"), state)
        state.method_state.feats.add_(1.0)
        torch.randn(3, generator=state.generator)
        snap.wait()
        assert_states_equal(checkpoint.restore_state(str(tmp_path / "a")),
                            want)


def test_jax_snapshots_are_not_read(tmp_path):
    """A JAX package snapshot (a pickled treedef beside the .npz) raises,
    naming it, instead of loading as something else."""
    path = str(tmp_path / "jax_snap")
    jax_checkpoint.save_state(path, {"key": jax.random.PRNGKey(0)})
    with pytest.raises(FileNotFoundError, match="JAX package"):
        checkpoint.restore_state(path)


@pytest.mark.parametrize("method", ["mode_dota_residuals", "cache"])
def test_interrupted_stream_resumes_exactly(setup, tmp_path, method):
    """A stream that crashes after 4 steps with a checkpoint every 2,
    restarted on the same path, resumes at step 4, skips the batches it
    has seen and ends bitwise where the uninterrupted stream ends: the
    carry (noise generator included), the counts and the accuracies."""
    model, text, batches = setup
    cfg = config(method)
    full = engine.run_stream(cfg, model, text, batches)
    ckpt = str(tmp_path / "stream")

    class Boom(Exception):
        pass

    def crashing():
        for i, b in enumerate(batches):
            if i == 4:
                raise Boom()
            yield b

    with pytest.raises(Boom):
        engine.run_stream(cfg, model, text, crashing(), checkpoint_every=2,
                          checkpoint_path=ckpt)
    assert checkpoint.restore_state(ckpt)["state"].step == 4
    resumed = engine.run_stream(cfg, model, text, batches,
                                checkpoint_every=2, checkpoint_path=ckpt)
    assert len(resumed["step_ms"]) == T - 4
    assert_states_equal(resumed["state"], full["state"])
    for key in ("acc1", "acc3", "acc5", "zs_acc1", "n", "finite"):
        assert resumed[key] == full[key], key
