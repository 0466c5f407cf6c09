"""The port's stream modes over a torch.distributed world
(`parallel/bootstrap.py`, `parallel/mesh.py`, `--dist-mode sharded|psum`)
against the JAX package's `parallel/mesh.py` on a 2-device mesh, on the
CPU, at the small dims of tests/test_parallel.py (Uni3D depth 1, width 48,
K 5, N 48, T 8, fp32).

The port's world of two is two processes over gloo, spawned once for the
module (`torch_dist_worker.py`): they run every case one after the other
and hand their results back through files.  Where the JAX side draws
MODE-DOTA's noise (each shard's key chain; under psum the key folded with
the device index), the port's step is handed the same draws; GMM-DOTA's
init is JAX's, injected.  Tolerances are tests/test_parallel.py's: the
means within rtol 1e-4 (DOTA) or 1e-3, atol 1e-5, the counts within
rtol 1e-4, the accuracies within 1e-5.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_dist_worker import collect, start_world
from uni_adapter_tpu import config as jcfg
from uni_adapter_tpu import engine as jengine
from uni_adapter_tpu.cli import tta as jtta
from uni_adapter_tpu.models.uni3d import create_uni3d as jax_create_uni3d
from uni_adapter_tpu.parallel import bootstrap as jboot
from uni_adapter_tpu.parallel import mesh as jmesh
from uni_adapter_torch import config as pcfg
from uni_adapter_torch.parallel import bootstrap as pboot
from uni_adapter_torch.parallel import mesh as pmesh
from uni_adapter_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

K, D, N, T = 5, 32, 48, 8
SMALL = dict(pc_feat_dim=48, embed_dim=32, num_group=8, group_size=8,
             pc_encoder_dim=24, eva_depth=1, eva_heads=4,
             compute_dtype="float32")
METHODS = {"dota": dict(use_dota=True, use_mode_dota=False),
           "mode": dict(use_mode_dota=True, mode_M=2, res_learning=False),
           "gmm": dict(use_mode_dota=False, use_gmm_dota=True, mode_M=2),
           "adaptive": dict(use_mode_dota=False, use_adaptive_dota=True)}
C, TS = 4, 2          # run_streams_sharded: 4 streams of 2 steps
CLI_ARGS = ["--npoints", str(N), "--eva-depth", "1", "--pc-feat-dim", "48",
            "--embed-dim", "32", "--num-group", "8", "--group-size", "8",
            "--pc-encoder-dim", "24", "--eva-heads", "4",
            "--compute-dtype", "float32", "--dota-use-mode-dota", "false",
            "--dota-use-dota", "true", "--corruption", "uniform",
            "--name", "run", "--device", "cpu"]


def configs(method):
    return (jcfg.Config(model=jcfg.ModelConfig(**SMALL),
                        dota=jcfg.DotaConfig(**METHODS[method])),
            pcfg.Config(model=pcfg.ModelConfig(**SMALL),
                        dota=pcfg.DotaConfig(**METHODS[method])))


def key_noise(key, n_steps, fold=None, shape=(1, N, 3)):
    """The noise a JAX step draws over n_steps from the carried key: split,
    normal from the second half (folded with the device index under
    psum)."""
    out = []
    for _ in range(n_steps):
        key, sub = jax.random.split(key)
        if fold is not None:
            sub = jax.random.fold_in(sub, fold)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    return np.stack(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' runs: the port's world of two (spawned first, so the
    JAX runs overlap it), then JAX's on make_mesh(2)."""
    tmp = tmp_path_factory.mktemp("parallel")
    jmodel = jax_create_uni3d(jcfg.ModelConfig(**SMALL))
    rng = np.random.default_rng(0)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, N, 6), jnp.float32))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        .astype(np.float32), params)
    text = rng.standard_normal((K, D)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    pcs = rng.standard_normal((T, 1, N, 3)).astype(np.float32)
    stream = (pcs, np.ones_like(pcs),
              rng.integers(0, K, (T, 1)).astype(np.int32))
    spcs = rng.standard_normal((C, TS, 1, N, 3)).astype(np.float32)
    streams = (spcs, np.ones_like(spcs),
               rng.integers(0, K, (C, TS, 1)).astype(np.int32))
    gmm_init = jengine.init_state(configs("gmm")[0], jnp.asarray(text),
                                  jax.random.PRNGKey(42)).method_state
    root = tmp / "data"
    root.mkdir()
    np.save(root / "data_uniform_5.npy", pcs[:, 0])
    np.save(root / "label.npy", stream[2][:, 0].astype(np.int64))
    np.save(tmp / "bank.npy", text)
    cli_args = [*CLI_ARGS, "--root", str(root), "--dist-mode", "sharded",
                "--precomputed-text-features", str(tmp / "bank.npy")]
    pcfgs = {m: configs(m)[1] for m in METHODS}
    inputs = {
        "cfgs": pcfgs, "state_dict": from_jax_params(params), "text": text,
        "stream": stream, "streams": streams,
        "gmm_init": {f: np.asarray(getattr(gmm_init, f))
                     for f in gmm_init._fields},
        "noise_sharded": [key_noise(jax.random.PRNGKey(42 + r), T // 2)
                          for r in range(2)],
        # streams 2r, 2r+1 on rank r, stream i from PRNGKey(42 + i)
        "noise_streams": [np.stack([key_noise(jax.random.PRNGKey(42 + i), TS)
                                    for i in (2 * r, 2 * r + 1)], axis=1)
                          for r in range(2)],
        "noise_psum": [key_noise(jax.random.PRNGKey(42), T // 2, fold=r)
                       for r in range(2)],
        "cli_argv": [*cli_args, "--output-dir", str(tmp / "port")]}
    procs = start_world("parallel", inputs, tmp)

    mesh = jmesh.make_mesh(2)
    jt = jnp.asarray(text)
    want = {}
    for method in ("dota", "mode"):
        want[f"sharded_{method}"] = jmesh.run_stream_sharded(
            configs(method)[0], jmodel, params, jt, *stream, mesh=mesh,
            seed=42)
    want["streams_sharded"] = jmesh.run_streams_sharded(
        configs("mode")[0], jmodel, params, jt, *streams, mesh=mesh, seed=42)
    for method in METHODS:
        want[f"psum_{method}"] = jmesh.run_stream_psum(
            configs(method)[0], jmodel, params, jt, *stream, mesh=mesh,
            seed=42)
    # the JAX CLI on the same weights, its stream sharded over 2 devices
    jbuild, jmake = jtta.build_model, jmesh.make_mesh
    jtta.build_model = lambda cfg: (jmodel, params)
    jmesh.make_mesh = lambda n=None, axis="data": jmake(2, axis)
    try:
        want["cli_sharded"] = jtta.main([*cli_args, "--output-dir",
                                         str(tmp / "jax")])
    finally:
        jtta.build_model, jmesh.make_mesh = jbuild, jmake
    got = collect(procs, tmp)
    return want, got, tmp


def _ok(result):
    assert "error" not in result, result.get("error")
    return result


def assert_state_close(method, got: dict, want, rank=None):
    pick = (lambda a: np.asarray(a)) if rank is None else (
        lambda a: np.asarray(a)[rank])
    counts = "C" if method == "gmm" else "c"
    rtol = 1e-4 if method == "dota" else 1e-3
    np.testing.assert_allclose(got["mu"], pick(want.mu), rtol=rtol,
                               atol=1e-5)
    np.testing.assert_allclose(got[counts], pick(getattr(want, counts)),
                               rtol=1e-4, atol=1e-5)


def assert_summary_close(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        assert got[key] == pytest.approx(float(want[key]), abs=1e-5), key


@pytest.mark.parametrize("launcher,env,expect", [
    ("torchrun", {"LOCAL_RANK": "1", "RANK": "3", "WORLD_SIZE": "4"},
     (1, 3, 4)),
    ("slurm", {"SLURM_LOCALID": "0", "SLURM_PROCID": "2",
               "SLURM_NTASKS": "8"}, (0, 2, 8)),
    ("openmpi", {"OMPI_COMM_WORLD_LOCAL_RANK": "1",
                 "OMPI_COMM_WORLD_RANK": "5",
                 "OMPI_COMM_WORLD_SIZE": "6"}, (1, 5, 6)),
    ("none", {}, (0, 0, 1))])
def test_world_info_from_env_reads_what_jax_reads(monkeypatch, launcher, env,
                                                  expect):
    """The three launcher conventions, in JAX's order, and none."""
    for names in pboot.LAUNCHERS:
        for name in names:
            monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert pboot.world_info_from_env() == jboot.world_info_from_env() == \
        expect


def test_backend_follows_the_device(monkeypatch):
    """gloo for CPU ranks; one process initialises nothing."""
    for names in pboot.LAUNCHERS:
        for name in names:
            monkeypatch.delenv(name, raising=False)
    assert pboot.backend_and_device("cpu", 1)[0] == "gloo"
    info = pboot.init_distributed_device("cpu")
    assert info["world_size"] == 1 and not info["distributed"]
    assert info["backend"] is None and str(info["device"]) == "cpu"
    assert pmesh.make_mesh() == pmesh.World(0, 1, None)
    assert pmesh.is_primary()


@pytest.mark.parametrize("method", ["dota", "mode"])
def test_sharded_matches_jax(runs, method):
    """Each rank's contiguous half of the stream from seed 42 + rank: the
    summed accuracies equal JAX's, each rank's final state JAX's shard."""
    want, got, _ = runs
    jstates, jsummary = want[f"sharded_{method}"]
    for rank in range(2):
        res = _ok(got[rank][f"sharded_{method}"])
        assert res["world"] == (rank, 2)
        assert_summary_close(res["summary"], jsummary)
        assert_state_close(method, res["state"], jstates.method_state, rank)


def test_streams_sharded_matches_jax(runs):
    """4 MODE-DOTA streams over 2 ranks: every stream's acc1 (all-gathered
    in stream order on both ranks) and each rank's two final states."""
    want, got, _ = runs
    jstates, jsummary = want["streams_sharded"]
    for rank in range(2):
        res = _ok(got[rank]["streams_sharded"])
        assert res["summary"]["acc1_per_stream"] == pytest.approx(
            jsummary["acc1_per_stream"], abs=1e-5)
        assert_summary_close(
            {k: v for k, v in res["summary"].items()
             if k != "acc1_per_stream"},
            {k: v for k, v in jsummary.items() if k != "acc1_per_stream"})
        np.testing.assert_allclose(
            res["state"]["mu"],
            np.asarray(jstates.method_state.mu)[2 * rank:2 * rank + 2],
            rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("method", list(METHODS))
def test_psum_matches_jax(runs, method):
    """One batch a rank a step, the fits' statistics summed over the
    ranks: both ranks' states equal bitwise (replicated), and JAX's."""
    want, got, _ = runs
    jstate, jsummary = want[f"psum_{method}"]
    r0, r1 = (_ok(got[r][f"psum_{method}"]) for r in range(2))
    for name in r0["state"]:
        np.testing.assert_array_equal(r0["state"][name], r1["state"][name])
    assert_summary_close(r0["summary"], jsummary)
    assert_state_close(method, r0["state"], jstate.method_state)


def test_refusals_carry_jax_messages():
    """The cache under psum, a stream shorter than the world, and streams
    that do not divide over it: JAX's errors, word for word (raised before
    any collective)."""
    jm, pm = jmesh.make_mesh(2), pmesh.World(0, 2, None)
    cache_j = jcfg.Config(model=jcfg.ModelConfig(**SMALL),
                          dota=jcfg.DotaConfig(use_mode_dota=False))
    cache_p = pcfg.Config(model=pcfg.ModelConfig(**SMALL),
                          dota=pcfg.DotaConfig(use_mode_dota=False))
    one = np.zeros((1, 1, N, 3), np.float32)
    tgt = np.zeros((1, 1), np.int32)
    cases = [
        (lambda: jmesh.run_stream_psum(cache_j, None, None, None, one, one,
                                       tgt, mesh=jm),
         lambda: pmesh.run_stream_psum(cache_p, None, None, one, one, tgt,
                                       mesh=pm)),
        (lambda: jmesh.run_stream_psum(configs("mode")[0], None, None, None,
                                       one, one, tgt, mesh=jm),
         lambda: pmesh.run_stream_psum(configs("mode")[1], None, None, one,
                                       one, tgt, mesh=pm)),
        (lambda: jmesh.run_stream_sharded(configs("mode")[0], None, None,
                                          None, one, one, tgt, mesh=jm),
         lambda: pmesh.run_stream_sharded(configs("mode")[1], None, None,
                                          one, one, tgt, mesh=pm)),
        (lambda: jmesh.run_streams_sharded(
            configs("mode")[0], None, None, None, one[None].repeat(3, 0),
            one[None].repeat(3, 0), tgt[None].repeat(3, 0), mesh=jm),
         lambda: pmesh.run_streams_sharded(
            configs("mode")[1], None, None, one[None].repeat(3, 0),
            one[None].repeat(3, 0), tgt[None].repeat(3, 0), mesh=pm))]
    for jax_call, port_call in cases:
        with pytest.raises(ValueError) as want:
            jax_call()
        with pytest.raises(ValueError) as got:
            port_call()
        assert str(got.value) == str(want.value)


def test_cli_dist_mode_sharded_writes_the_jax_results(runs):
    """`--dist-mode sharded` (plain DOTA) at world 2: rank 0 writes the
    JAX CLI's results.json (its stream sharded over 2 devices, the same
    weights); there is no results_zs.json in either, and rank 1 writes
    nothing."""
    want, got, tmp = runs
    for rank in range(2):
        assert _ok(got[rank]["cli_sharded"]) == want["cli_sharded"]
    port = tmp / "port" / "run"
    assert json.loads((port / "results.json").read_text()) == json.loads(
        (tmp / "jax" / "run" / "results.json").read_text())
    assert not (port / "results_zs.json").exists()
    assert not (tmp / "jax" / "run" / "results_zs.json").exists()
    assert (port / "out.log").exists()
