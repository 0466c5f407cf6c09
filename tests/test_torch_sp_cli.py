"""`--trunk-parallel sp` through the port's TTA CLI and `TTAServer(encode_fn=
...)` (`parallel/trunk.py`, `parallel/sp.py`), `--parallel sp` through
its pretraining CLI, and their errors, against the port's replicated
runs and the JAX CLIs, at small dims (Uni3D width 48, depth 4, D 32, 9
tokens, fp32; the pretraining CLI at its demo size, depth 2).

The world of two ranks is spawned once for the module
(`torch_dist_worker.py`, program `sp_cli`) and runs: the TTA CLI over two
corruptions (the scan; the eager loop with `--continual`), each rank's
results.json equal to the replicated CLI's here; the server, rank 0
serving two clients while rank 1 follows, each client's logits within
1e-4 of its stream through `engine.run_stream` here; the trunk's errors
for OpenShape and an int8 trunk, the JAX CLI's texts; and the
pretraining CLI, 4 steps uninterrupted against 2 and a `--resume` to 4
(bitwise), its logged losses the one-process CLI's and its parameters
within `PARAM_ATOL` of that run's, and a world-2 checkpoint resumed here
in a world of one.
"""
import json
import re
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uni_adapter_torch.checkpoint as port_checkpoint
from test_torch_pp_cli import (CLI_ARGS, CORRUPTIONS, D, N, NOISE_ATOL,
                               PARAM_ATOL, SMALL, _weights)
from torch_dist_worker import _patched_cli, collect, start_world
from uni_adapter_tpu import config as jcfg
from uni_adapter_tpu.models.uni3d import Uni3D as JUni3D
from uni_adapter_tpu.parallel.trunk import prepare_trunk_parallel
from uni_adapter_torch import config as pcfg
from uni_adapter_torch import engine
from uni_adapter_torch.cli import pretrain, tta
from uni_adapter_torch.models.uni3d import create_uni3d
from uni_adapter_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

#: name: flags beside --trunk-parallel sp
RUNS = {"scan": [], "eager_continual": ["--use-scan", "false", "--continual",
                                        "true", "--batch-size", "3"]}
PRETRAIN = ["--device", "cpu", "--batch-size", "8", "--depth", "2",
            "--trans-dim", "16", "--embed-dim", "16", "--num-group", "4",
            "--group-size", "4", "--encoder-dim", "8", "--heads", "2",
            "--warmup-steps", "1", "--log-every", "1", "--prefetch", "0"]
SP = ["--parallel", "sp"]
#: the trunk's errors: name -> (vlm3d, int8)
ERRORS = {"openshape": ("openshape", False), "int8": ("uni3d", True)}


def _pretrain_runs(tmp):
    """(name, argv) of the world's pretraining runs, in order."""
    out = lambda n: ["--out", str(tmp / f"pre_{n}")]  # noqa: E731
    return [("a", [*PRETRAIN, *SP, *out("a"), "--steps", "4",
                   "--ckpt-every", "100"]),
            ("b2", [*PRETRAIN, *SP, *out("b"), "--steps", "2",
                    "--ckpt-every", "2"]),
            ("b", [*PRETRAIN, *SP, *out("b"), "--steps", "4",
                   "--ckpt-every", "100", "--resume"]),
            ("c2", [*PRETRAIN, *SP, *out("c"), "--steps", "2",
                    "--ckpt-every", "2"])]


def _jax_error(vlm3d: str, int8: bool) -> str:
    """The JAX trunk's ValueError for `--trunk-parallel sp`, raised before
    its parameters are read."""
    model = JUni3D(trans_dim=48, embed_dim=D, num_group=8, group_size=8,
                   encoder_dim=24, depth=4, num_heads=4, quantize=int8,
                   dtype=jnp.float32)
    with pytest.raises(ValueError) as e:
        prepare_trunk_parallel(jcfg.Config(
            model=jcfg.ModelConfig(vlm3d=vlm3d),
            run=jcfg.RunConfig(trunk_parallel="sp")), model, None)
    return str(e.value)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world of two (spawned first), then the replicated runs and the
    JAX errors here."""
    tmp = tmp_path_factory.mktemp("sp_cli")
    _, params = _weights()
    sd = from_jax_params(params)
    mcfg = pcfg.ModelConfig(**SMALL)
    models = {"small": (mcfg, sd),
              "int8": (pcfg.ModelConfig(**SMALL, quantize_int8=True), sd)}
    rng = np.random.default_rng(1)
    root = tmp / "data"
    root.mkdir()
    for corr in CORRUPTIONS:
        np.save(root / f"data_{corr}_5.npy",
                rng.standard_normal((6, N, 3)).astype(np.float32))
    np.save(root / "label.npy", rng.integers(0, 40, (6,)).astype(np.int64))
    bank = rng.standard_normal((40, D)).astype(np.float32)
    np.save(tmp / "bank.npy", bank / np.linalg.norm(bank, axis=1,
                                                    keepdims=True))
    common = [*CLI_ARGS, "--root", str(root), "--precomputed-text-features",
              str(tmp / "bank.npy")]
    cli = {name: ([*common, *flags, "--trunk-parallel", "sp",
                   "--output-dir", str(tmp / f"sp_{name}")], "small")
           for name, flags in RUNS.items()}
    text = rng.standard_normal((6, D)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    streams = rng.standard_normal((2, 3, 1, N, 3)).astype(np.float32)
    cfg = pcfg.Config(model=pcfg.ModelConfig(**SMALL),
                      dota=pcfg.DotaConfig(res_learning=False))
    errors = {name: (pcfg.Config(model=pcfg.ModelConfig(vlm3d=vlm3d),
                                 run=pcfg.RunConfig(trunk_parallel="sp")),
                     "int8" if int8 else "small")
              for name, (vlm3d, int8) in ERRORS.items()}
    procs = start_world("sp_cli", {
        "models": models, "cli": cli, "cli_corruptions": CORRUPTIONS,
        "cfg": cfg, "text": text, "streams": streams, "errors": errors,
        "pretrain": _pretrain_runs(tmp), "trunk": "sp"}, tmp / "w2")

    want = {}
    built = create_uni3d(mcfg, "cpu", state_dict=sd)
    for name, flags in RUNS.items():
        want[name] = _patched_cli(tta, built, CORRUPTIONS)(
            [*common, *flags, "--output-dir", str(tmp / f"rep_{name}")])
    want["streams"] = []
    step = engine.make_step_fn(cfg, built)
    for i in range(2):
        logits = []

        def recorded(text_init, state, batch):
            state, out = step(text_init, state, batch)
            logits.append(out.final_logits.numpy())
            return state, out

        pcs = streams[i]
        engine.run_stream(
            cfg, built, torch.from_numpy(text),
            [(pcs[t], np.ones_like(pcs[t]), np.zeros(1, np.int64))
             for t in range(3)], seed=42 + i, step_fn=recorded)
        want["streams"].append(logits)
    want["errors"] = {name: _jax_error(*e) for name, e in ERRORS.items()}
    # the same recipe in one process, --parallel dp (the same weights from
    # the seed, the same whole batches)
    want["one_process"] = pretrain.main(
        [*PRETRAIN, "--out", str(tmp / "one_process"), "--steps", "4",
         "--ckpt-every", "100"])
    got = collect(procs, tmp / "w2", timeout=300.0)
    # the world-2 checkpoint at step 2, resumed to 4 in a world of one
    shutil.copytree(tmp / "pre_c", tmp / "pre_c1")
    want["resumed_at_1"] = pretrain.main(
        [*PRETRAIN, *SP, "--out", str(tmp / "pre_c1"), "--steps", "4",
         "--ckpt-every", "100", "--resume"])
    return want, got, tmp


def _ok(result):
    assert not (isinstance(result, dict) and "error" in result), \
        result.get("error")
    return result


@pytest.mark.parametrize("name", list(RUNS))
def test_sp_cli_matches_the_replicated_cli(runs, name):
    """Both ranks' CLI runs under `--trunk-parallel sp` report the
    replicated CLI's top-1 per corruption; rank 0 wrote results.json and
    results_zs.json, its log names the ring."""
    want, got, tmp = runs
    for r in range(2):
        res = _ok(got[r][f"cli_{name}"])
        assert res["acc1"] == want[name]["acc1"]
        assert res["zs_acc1"] == want[name]["zs_acc1"]
        assert res["steps"] == want[name]["steps"]
    run_dir = tmp / f"sp_{name}" / "run"
    assert json.loads((run_dir / "results.json").read_text()) == \
        want[name]["acc1"]
    assert (run_dir / "results_zs.json").exists()
    log = (run_dir / "out.log").read_text()
    assert "trunk parallelism: sequence (ring attention), 2-way" in log
    assert "trunk parallel sp" in log


def test_sp_server_matches_each_clients_stream(runs):
    """`TTAServer(encode_fn=...)` over a ring of two ranks (rank 0 serves,
    rank 1 follows): the two clients' logits, in ticks of two and one,
    within 1e-4 of each client's stream through `engine.run_stream`."""
    want, got, _ = runs
    assert _ok(got[1]["server"]) == {"followed": True}
    ticks = _ok(got[0]["server"])["ticks"]
    assert [sorted(t) for t in ticks] == [["a", "b"], ["a", "b"], ["a"]]
    for t, tick in enumerate(ticks):
        for i, cid in enumerate("ab"):
            if cid in tick:
                np.testing.assert_allclose(tick[cid], want["streams"][i][t],
                                           rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", list(ERRORS))
def test_sp_trunk_errors_are_the_jax_clis(runs, name):
    """`--trunk-parallel sp` with OpenShape, or with an int8 trunk, raises
    the JAX trunk's ValueError word for word on both ranks."""
    want, got, _ = runs
    assert "int8" in want["errors"]["int8"]
    assert "kind='uni3d'|'ulip'" in want["errors"]["openshape"]
    for r in range(2):
        assert _ok(got[r]["errors"])[name] == want["errors"][name]


def test_sp_pretrain_resumes_bitwise(runs):
    """4 steps of `--parallel sp` at world 2 in one go against 2 + 2 with
    `--resume`: every rank's parameters and moments bit for bit, the
    ranks equal to each other; the checkpoint is one process's tree,
    stamped `"parallel": "sp"`."""
    want, got, tmp = runs
    ranks = [_ok(got[r]["pretrain"]) for r in range(2)]
    for res in ranks:
        a, b = res["a"], res["b"]
        assert a["step"] == b["step"] == 4
        assert a["logit_scale"] == b["logit_scale"]
        for key in ("params", "mu"):
            assert set(a[key]) == set(b[key])
            for n in a[key]:
                np.testing.assert_array_equal(a[key][n], b[key][n],
                                              err_msg=n)
                np.testing.assert_array_equal(
                    a[key][n], ranks[0]["a"][key][n], err_msg=n)
    blob = port_checkpoint.restore_state(str(tmp / "pre_b" / "ckpt"))
    assert blob["parallel"] == "sp"
    assert set(blob["train"].params) == set(want["one_process"].params)
    log = Path(tmp / "pre_b" / "pretrain.log").read_text()
    assert "resumed at train step 2" in log
    assert "sequence parallel: 5 tokens over 2 devices" in log


def _losses(log: str) -> list:
    return re.findall(r"step (\d+)/4  loss (\S+)", log)


def _close_to_one_process(params: dict, ref: dict) -> None:
    assert set(params) == set(ref)
    for n, p in params.items():
        atol = NOISE_ATOL if "k_norm.bias" in n else PARAM_ATOL
        np.testing.assert_allclose(np.asarray(p), ref[n].detach().numpy(),
                                   rtol=0, atol=atol, err_msg=n)


def test_sp_pretrain_matches_the_one_process_cli(runs):
    """`--parallel sp` at world 2 logs the one-process CLI's losses (to
    their 4 decimals) every step on the same seed and batches, and its
    parameters are within `PARAM_ATOL` of that run's (the k LayerNorm's
    bias within `NOISE_ATOL`)."""
    want, got, tmp = runs
    port_log = Path(tmp / "pre_a" / "pretrain.log").read_text()
    one = (tmp / "one_process" / "pretrain.log").read_text()
    assert _losses(port_log) == _losses(one)
    assert len(_losses(port_log)) == 4
    _close_to_one_process(_ok(got[0]["pretrain"])["a"]["params"],
                          want["one_process"].params)


def test_sp_checkpoint_resumes_across_world_sizes(runs):
    """A `--parallel sp` checkpoint saved at world 2 (step 2) resumes in a
    world of one to step 4: the one-process CLI's logged losses, and its
    parameters within `PARAM_ATOL` of that run's."""
    want, got, tmp = runs
    state = want["resumed_at_1"]
    assert state.step == 4
    log = (tmp / "pre_c1" / "pretrain.log").read_text()
    assert "resumed at train step 2" in log
    assert _losses(log) == _losses(
        (tmp / "one_process" / "pretrain.log").read_text())[2:]
    _close_to_one_process({n: p.detach() for n, p in state.params.items()},
                          want["one_process"].params)


@pytest.mark.parametrize("saved,resumed", [("sp", "dp"), ("dp", "sp")])
def test_sp_resume_guard_refuses_another_parallel(monkeypatch, tmp_path,
                                                  saved, resumed):
    """A checkpoint of another `--parallel` refuses `--resume` with the JAX
    CLI's words, sp against dp both ways."""
    import uni_adapter_tpu.checkpoint as jax_checkpoint
    import uni_adapter_tpu.cli.pretrain as jax_pretrain
    import uni_adapter_tpu.parallel.pp as jpp
    import uni_adapter_tpu.train as jax_train

    blob = {"data_seed": 0, "global_batch": 8, "parallel": saved,
            "depth": 2, "wd_mask": "name", "corpus_size": 128, "lr": 1e-3,
            "weight_decay": 0.05, "warmup_steps": 1}
    monkeypatch.setattr(jax_train, "init_train_state", lambda *a: None)
    monkeypatch.setattr(jpp, "init_pp_train_state", lambda *a, **k: None)
    texts = []
    for main, ckpt in ((pretrain.main, port_checkpoint),
                       (jax_pretrain.main, jax_checkpoint)):
        out = tmp_path / main.__module__
        out.mkdir()
        (out / "ckpt.npz").write_bytes(b"")
        monkeypatch.setattr(ckpt, "restore_state",
                            lambda *a, **k: dict(blob, train=None))
        with pytest.raises(ValueError) as e:
            main([*PRETRAIN, "--parallel", resumed, "--out", str(out),
                  "--steps", "4", "--resume"])
        texts.append(str(e.value))
    assert texts[0] == texts[1]
    assert f"--parallel {resumed}" in texts[0]
