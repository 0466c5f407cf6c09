"""The port's data-parallel pretraining over a torch.distributed world
against the JAX package on the CPU: `train.make_dp_train_step` at world 2
against JAX's on a 2-device mesh (the gathered negatives, the masked leg
normalised by the global mask count, the averaged gradients), the
`StreamingLoader`'s rows by rank (its rank and world read from the
process group) against JAX's with `process_index` / `process_count`
given, and a two-rank `cli/pretrain.py` run that saves on rank 0 and
resumes on both.  Small dims of tests/test_parallel.py (Uni3D depth 1,
width 48, fp32).

The port's world of two is two processes over gloo, spawned once for the
module (`torch_dist_worker.py`)."""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import uni_adapter_tpu.train as jtrain
from torch_dist_worker import collect, start_world
from uni_adapter_tpu.data import streaming as jstreaming
from uni_adapter_tpu.models.uni3d import Uni3D as JaxUni3D
from uni_adapter_tpu.parallel import mesh as jmesh
from uni_adapter_torch.data import streaming as pstreaming
from uni_adapter_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

WIDTHS = dict(trans_dim=48, embed_dim=32, num_group=8, group_size=8,
              encoder_dim=24, depth=1, num_heads=4)
B, NPTS = 8, 48
OPTIMIZER = dict(lr=1e-3, total_steps=4, warmup_steps=1)
CLI = ["--device", "cpu", "--batch-size", "8", "--depth", "1",
       "--trans-dim", "16", "--embed-dim", "16", "--num-group", "4",
       "--group-size", "4", "--encoder-dim", "8", "--heads", "2",
       "--warmup-steps", "1", "--log-every", "2", "--prefetch", "0"]
#: fp32 sums in other orders: the loss and metrics within rtol 1e-5; the
#: parameters after two steps within 2e-6 (max |Δ| 1.3e-6 here; the first
#: update, at lr 0 under warmup, moves nothing, the second is lr 1e-3 ·
#: m̂/√v̂).  The k LayerNorm's bias has a gradient of 0 in exact
#: arithmetic (a shift of every key by one vector leaves each query's
#: softmax as it is), so both sides' Adam steps normalise rounding noise
#: to O(1): it moves by up to lr·(|m̂/√v̂| ≤ 1.05) either way, and is held
#: within 2·1.05·lr + 4e-4 (max |Δ| 7.4e-4 here).
METRIC_RTOL, PARAM_ATOL, NOISE_ATOL = 1e-5, 2e-6, 2.5e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_train")
    jmodel = JaxUni3D(**WIDTHS, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, NPTS, 6)))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        .astype(np.float32), params)
    batches = [dict(pc=rng.standard_normal((B, NPTS, 6)).astype(np.float32),
                    text=rng.standard_normal((B, 32)).astype(np.float32),
                    image=rng.standard_normal((B, 32)).astype(np.float32),
                    mask=np.array([1, 0, 1, 1, 1, 0, 0, 1], np.float32))
               for _ in range(2)]
    shards = ([], [], [])
    for s in range(2):
        for group, shape in zip(shards, ((20, 16, 6), (20, 8), (20, 8))):
            path = tmp / f"{len(group)}_{len(shape)}_{s}.npy"
            np.save(path, rng.standard_normal(shape).astype(np.float32))
            group.append(str(path))
    cli_runs = [
        ("full", [*CLI, "--out", str(tmp / "full"), "--steps", "4",
                  "--ckpt-every", "100"]),
        ("first", [*CLI, "--out", str(tmp / "resumed"), "--steps", "2",
                   "--ckpt-every", "2"]),
        ("resumed", [*CLI, "--out", str(tmp / "resumed"), "--steps", "4",
                     "--resume"])]
    procs = start_world("dp_train", {
        "widths": WIDTHS, "state_dict": from_jax_params(params),
        "optimizer": OPTIMIZER, "batches": batches, "shards": shards,
        "cli_runs": cli_runs}, tmp)

    tx = jtrain.make_optimizer(**OPTIMIZER)
    ls = jnp.float32(math.log(1 / 0.07))
    state = jtrain.TrainState(params, ls, tx.init((params, ls)), jnp.int32(0))
    mesh = jmesh.make_mesh(2)
    step = jtrain.make_dp_train_step(jmodel, tx, mesh,
                                     axis_name=mesh.axis_names[0])
    metrics = []
    for b in batches:
        state, m = step(state, b["pc"], b["text"], b["image"], b["mask"])
        metrics.append({k: float(v) for k, v in m.items()})
    corpus = jstreaming.ShardedCorpus(*shards)
    rows = [[next(loader) for _ in range(3)] for loader in (
        jstreaming.StreamingLoader(corpus, 8, seed=3, process_index=r,
                                   process_count=2, prefetch=0)
        for r in range(2))]
    want = {"metrics": metrics, "state": state, "rows": rows}
    return want, collect(procs, tmp), tmp


def _ok(result):
    assert "error" not in result, result.get("error")
    return result


def test_dp_step_matches_jax(runs):
    """Two steps of the DP step at world 2 (a masked leg with three rows
    out): every metric (averaged over the ranks) within rtol 1e-5 on both
    ranks, every parameter and the log-scale after the steps within
    PARAM_ATOL of JAX's (the k LayerNorm's bias within NOISE_ATOL), and
    equal bitwise on the two ranks."""
    want, got, _ = runs
    r0, r1 = (_ok(got[r]["dp_steps"]) for r in range(2))
    assert r0["metrics"] == r1["metrics"]
    for g, w in zip(r0["metrics"], want["metrics"]):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=METRIC_RTOL,
                                       err_msg=key)
    jparams = {k: v.numpy() for k, v in
               from_jax_params(want["state"].params).items()}
    assert set(r0["params"]) == set(jparams)
    for name, p in r0["params"].items():
        np.testing.assert_array_equal(p, r1["params"][name])
        atol = NOISE_ATOL if name.endswith("k_norm.bias") else PARAM_ATOL
        np.testing.assert_allclose(p, jparams[name], rtol=0, atol=atol,
                                   err_msg=name)
    np.testing.assert_allclose(r0["logit_scale"],
                               float(want["state"].logit_scale), rtol=1e-6)


def test_loader_rows_by_rank_match_jax(runs):
    """The loader's process index and count default to the process group's
    rank and world; each rank's three batches are JAX's loader's with
    those passed in (the rank-order concatenation is the global batch)."""
    want, got, _ = runs
    for rank in range(2):
        res = _ok(got[rank]["loader_rows"])
        assert res["index"] == (rank, 2)
        for g, w in zip(res["batches"], want["rows"][rank]):
            assert set(g) == set(w)
            for key in w:
                np.testing.assert_array_equal(g[key], w[key])


def test_loader_defaults_to_one_process_and_keeps_the_divisibility_error(
        tmp_path):
    """Without a process group: rank 0 of 1; a global batch that does not
    divide over the processes raises JAX's error."""
    path = tmp_path / "pc.npy"
    np.save(path, np.zeros((10, 4, 6), np.float32))
    corpus = pstreaming.ShardedCorpus([str(path)])
    loader = pstreaming.StreamingLoader(corpus, 4, prefetch=0)
    assert (loader.process_index, loader.process_count) == (0, 1)
    for module in (pstreaming, jstreaming):
        with pytest.raises(ValueError, match="global batch 5 not divisible "
                                             "by 2 processes"):
            module.StreamingLoader(module.ShardedCorpus([str(path)]), 5,
                                   process_index=0, process_count=2)


def test_two_rank_cli_saves_on_rank_0_and_resumes(runs):
    """`--batch-size 8` over two ranks, 4 steps in one go against 2 + 2
    with `--resume`: every parameter and the log-scale bitwise equal, on
    both ranks, and equal across the ranks; rank 0 wrote the checkpoint
    and the log, which says where it resumed."""
    _, got, tmp = runs
    r0, r1 = (_ok(got[r]["cli"]) for r in range(2))
    for res in (r0, r1):
        assert res["first"]["step"] == 2 and res["resumed"]["step"] == 4
        for name, p in res["full"]["params"].items():
            np.testing.assert_array_equal(res["resumed"]["params"][name], p)
        assert res["resumed"]["logit_scale"] == res["full"]["logit_scale"]
    for name, p in r0["resumed"]["params"].items():
        np.testing.assert_array_equal(r1["resumed"]["params"][name], p)
    assert os.path.exists(tmp / "resumed" / "ckpt.npz")
    log = (tmp / "resumed" / "pretrain.log").read_text()
    assert "resumed at train step 2" in log
    assert "distributed: process 0/2, backend gloo" in log


def test_torchrun_launch_bootstraps_gloo_on_the_cpu(tmp_path):
    """`python -m torch.distributed.run --nproc-per-node 2 -m
    uni_adapter_torch.cli.pretrain --device cpu`: each rank reads the
    launcher's variables, joins the group over TCP with gloo
    (`parallel/bootstrap.py`), and the run writes one checkpoint."""
    import subprocess
    import sys

    from torch_dist_worker import REPO

    out = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "uni_adapter_torch.cli.pretrain",
         *CLI, "--out", str(out), "--steps", "2", "--ckpt-every", "2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=50)
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = (out / "pretrain.log").read_text()
    assert "distributed: process 0/2, backend gloo, device cpu" in log
    assert "process 1/2" not in log
    assert os.path.exists(out / "ckpt.npz")
