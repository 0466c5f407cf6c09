"""`--trunk-parallel pp` through the port's TTA CLI and `TTAServer(encode_fn=
...)` (`parallel/trunk.py`, `parallel/pp.py`), `--parallel pp` through
its pretraining CLI, and their errors and flags, against the port's
replicated runs and the JAX CLIs, at small dims (Uni3D width 48, depth
4, D 32, fp32; the pretraining CLI at its demo size, depth 2).

The world of two ranks is spawned once for the module
(`torch_dist_worker.py`, program `pp_cli`) and runs: the TTA CLI over two
corruptions (the scan, GPipe and interleaved; the eager loop with
`--continual`; `--trunk-stages 1`, rank 1 holding no block and taking
the trunk's output from the broadcast), each rank's results.json equal to
the replicated CLI's here; the server, rank 0 serving two clients while
rank 1 follows, each client's logits within 1e-4 of its stream through
`engine.run_stream` here; the trunk's errors, the JAX CLI's texts; and
the pretraining CLI, 4 steps uninterrupted against 2 and a `--resume` to
4 (bitwise, GPipe and PP × TP), its logged losses equal to the
one-process CLI's on the same seed and batches and its checkpoint one
process's tree within `PARAM_ATOL` of that run's parameters; and its
resume guard's refusals, the JAX CLI's words.
"""
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import uni_adapter_tpu.cli.pretrain as jax_pretrain
import uni_adapter_torch.checkpoint as port_checkpoint
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

D, N = 32, 64
SMALL = dict(pc_feat_dim=48, embed_dim=D, num_group=8, group_size=8,
             pc_encoder_dim=24, eva_depth=4, eva_heads=4,
             compute_dtype="float32")
CORRUPTIONS = ["uniform", "gaussian"]
CLI_ARGS = ["--npoints", "64", "--eva-depth", "4", "--pc-feat-dim", "48",
            "--embed-dim", "32", "--num-group", "8", "--group-size", "8",
            "--pc-encoder-dim", "24", "--eva-heads", "4",
            "--compute-dtype", "float32", "--corruption", "all",
            "--name", "run", "--device", "cpu"]
#: name: flags beside --trunk-parallel pp
RUNS = {"scan": [], "interleave": ["--pp-interleave", "2"],
        "eager_continual": ["--use-scan", "false", "--continual", "true",
                            "--batch-size", "3"],
        "one_stage": ["--trunk-stages", "1"]}
PRETRAIN = ["--device", "cpu", "--batch-size", "8", "--depth", "2",
            "--trans-dim", "16", "--embed-dim", "16", "--num-group", "4",
            "--group-size", "4", "--encoder-dim", "8", "--heads", "2",
            "--warmup-steps", "1", "--log-every", "1", "--prefetch", "0",
            "--parallel", "pp"]
#: four AdamW steps (the first at lr 0) in other summation orders; the k
#: LayerNorm's bias has an exact gradient of 0, so Adam normalises noise
#: (tests/test_torch_dp_train.py)
PARAM_ATOL, NOISE_ATOL = 1e-5, 2.5e-3


def _weights(depth=4):
    m = JUni3D(trans_dim=48, embed_dim=D, num_group=8, group_size=8,
               encoder_dim=24, depth=depth, num_heads=4, dtype=jnp.float32)
    params = jax.jit(m.init)(jax.random.PRNGKey(0),
                             jnp.zeros((1, N, 6), jnp.float32))
    rng = np.random.default_rng(0)
    return m, jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        .astype(np.float32), params)


def _pretrain_runs(tmp):
    """(name, argv) of the world's pretraining runs, in order."""
    runs = []
    for name, extra in (("gpipe", ["--pp-stages", "2"]),
                        ("tp", ["--pp-stages", "1", "--pp-tp-size", "2"])):
        a, b = str(tmp / f"pre_{name}_a"), str(tmp / f"pre_{name}_b")
        runs += [(f"{name}_a", [*PRETRAIN, *extra, "--out", a, "--steps",
                                "4", "--ckpt-every", "100"]),
                 (f"{name}_b2", [*PRETRAIN, *extra, "--out", b, "--steps",
                                 "2", "--ckpt-every", "2"]),
                 (f"{name}_b", [*PRETRAIN, *extra, "--out", b, "--steps",
                                "4", "--ckpt-every", "100", "--resume"])]
    return runs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world of two (spawned first), then the replicated runs and the
    JAX CLIs here."""
    tmp = tmp_path_factory.mktemp("pp_cli")
    _, params = _weights()
    j3, params3 = _weights(depth=3)
    sd = from_jax_params(params)
    mcfg = {"small": pcfg.ModelConfig(**SMALL),
            "depth3": pcfg.ModelConfig(**dict(SMALL, eva_depth=3))}
    models = {"small": (mcfg["small"], sd),
              "depth3": (mcfg["depth3"], from_jax_params(params3))}
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
    cli = {name: ([*common, *flags, "--trunk-parallel", "pp",
                   "--output-dir", str(tmp / f"pp_{name}")], "small")
           for name, flags in RUNS.items()}
    text = rng.standard_normal((6, D)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    streams = rng.standard_normal((2, 3, 1, N, 3)).astype(np.float32)
    cfg = pcfg.Config(model=pcfg.ModelConfig(**SMALL),
                      dota=pcfg.DotaConfig(res_learning=False))
    pp_cfg = lambda **kw: pcfg.Config(  # noqa: E731
        run=pcfg.RunConfig(trunk_parallel="pp", **kw))
    errors = {"depth3": (pp_cfg(), "depth3"),
              "stages3": (pp_cfg(trunk_stages=3), "small")}
    procs = start_world("pp_cli", {
        "models": models, "cli": cli, "cli_corruptions": CORRUPTIONS,
        "cfg": cfg, "text": text, "streams": streams, "errors": errors,
        "pretrain": _pretrain_runs(tmp)}, tmp / "w2")

    want = {}
    built = create_uni3d(mcfg["small"], "cpu", state_dict=sd)
    for name in ("scan", "eager_continual"):
        want[name] = _patched_cli(tta, built, CORRUPTIONS)(
            [*common, *RUNS[name], "--output-dir", str(tmp / f"rep_{name}")])
    # the pipeline's schedule and stage count change nothing replicated
    want["interleave"] = want["one_stage"] = want["scan"]
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
    jerrors = {}
    for name, (model, p, stages) in {"depth3": (j3, params3, 2),
                                     "stages3": (j3, params3, 9)}.items():
        try:
            prepare_trunk_parallel(jcfg.Config(run=jcfg.RunConfig(
                trunk_parallel="pp", trunk_stages=stages)), model, p)
        except ValueError as e:
            jerrors[name] = str(e)
    want["errors"] = jerrors
    # the same recipe in one process, --parallel dp (the same weights from
    # the seed, the same whole batches)
    want["one_process"] = pretrain.main(
        [a for a in PRETRAIN if a not in ("--parallel", "pp")]
        + ["--out", str(tmp / "one_process"), "--steps", "4",
           "--ckpt-every", "100"])
    got = collect(procs, tmp / "w2", timeout=300.0)
    return want, got, tmp


def _ok(result):
    assert not (isinstance(result, dict) and "error" in result), \
        result.get("error")
    return result


@pytest.mark.parametrize("name", list(RUNS))
def test_pp_cli_matches_the_replicated_cli(runs, name):
    """Both ranks' CLI runs under `--trunk-parallel pp` report the
    replicated CLI's top-1 per corruption; rank 0 wrote results.json and
    results_zs.json, its log names the pipeline."""
    want, got, tmp = runs
    for r in range(2):
        res = _ok(got[r][f"cli_{name}"])
        assert res["acc1"] == want[name]["acc1"]
        assert res["zs_acc1"] == want[name]["zs_acc1"]
        assert res["steps"] == want[name]["steps"]
    run_dir = tmp / f"pp_{name}" / "run"
    assert json.loads((run_dir / "results.json").read_text()) == \
        want[name]["acc1"]
    assert (run_dir / "results_zs.json").exists()
    log = (run_dir / "out.log").read_text()
    stages = 1 if name == "one_stage" else 2
    chunks = 2 if name == "interleave" else 1
    assert (f"trunk parallelism: pipeline, {stages} stages x {chunks} "
            "chunks/stage") in log
    assert "trunk parallel pp" in log


def test_pp_server_matches_each_clients_stream(runs):
    """`TTAServer(encode_fn=...)` over a pipeline of two ranks (rank 0
    serves, rank 1 follows): the two clients' logits, in ticks of two and
    one, within 1e-4 of each client's stream through `engine.run_stream`."""
    want, got, _ = runs
    assert _ok(got[1]["server"]) == {"followed": True}
    ticks = _ok(got[0]["server"])["ticks"]
    assert [sorted(t) for t in ticks] == [["a", "b"], ["a", "b"], ["a"]]
    for t, tick in enumerate(ticks):
        for i, cid in enumerate("ab"):
            if cid in tick:
                np.testing.assert_allclose(tick[cid], want["streams"][i][t],
                                           rtol=1e-4, atol=1e-4)


def test_pp_errors_are_the_jax_clis(runs):
    """A depth of 3 over two stages raises the JAX CLI's text word for word
    (its stage mesh is the first two devices); `--trunk-stages 3` in a
    world of two raises JAX's text with the world's size in its device
    count's place."""
    want, got, _ = runs
    for r in range(2):
        errs = _ok(got[r]["errors"])
        assert errs["depth3"] == want["errors"]["depth3"]
        assert "depth 3 not divisible by 2 stages" in errs["depth3"]
        assert errs["stages3"] == "--trunk-stages 3 must be in [1, 2]"
        assert want["errors"]["stages3"] == "--trunk-stages 9 must be in " \
            "[1, 8]"


@pytest.mark.parametrize("flags", [
    ["--trunk-parallel", "pp", "--dist-mode", "ep"],
    ["--trunk-parallel", "pp", "--dist-mode", "sharded"],
    ["--trunk-parallel", "pp", "--vmap-corruptions", "true"],
    ["--trunk-parallel", "pp", "--trunk-stages", "2", "--dist-mode",
     "psum"],
])
def test_pp_flags_validate_as_jax(flags):
    """The combinations the JAX parser refuses raise its ValueError, word
    for word."""
    with pytest.raises(ValueError) as jerr:
        jcfg.parse_args(flags)
    with pytest.raises(ValueError) as perr:
        pcfg.parse_args(flags)
    assert str(perr.value) == str(jerr.value)


def _pretrain(runs):
    return {n: r for n, r in _ok(runs[1][0]["pretrain"]).items()}, \
        {n: r for n, r in _ok(runs[1][1]["pretrain"]).items()}


@pytest.mark.parametrize("name", ["gpipe", "tp"])
def test_pp_pretrain_resumes_bitwise(runs, name):
    """4 steps of `--parallel pp` in one go against 2 + 2 with `--resume`
    (GPipe over two stages; PP × TP, one stage over a model pair): every
    rank's parameters and moments bit for bit; the checkpoint is one
    process's whole tree, stamped."""
    want, got, tmp = runs
    for r in range(2):
        res = _ok(got[r]["pretrain"])
        a, b = res[f"{name}_a"], res[f"{name}_b"]
        assert a["step"] == b["step"] == 4
        assert a["logit_scale"] == b["logit_scale"]
        for key in ("params", "mu"):
            assert set(a[key]) == set(b[key])
            for n in a[key]:
                np.testing.assert_array_equal(a[key][n], b[key][n],
                                              err_msg=n)
    blob = port_checkpoint.restore_state(str(tmp / f"pre_{name}_b" / "ckpt"))
    assert (blob["pp_stages"], blob["pp_interleave"], blob["pp_tp_size"]) \
        == ((2, 1, 1) if name == "gpipe" else (1, 1, 2))
    assert blob["parallel"] == "pp"
    full = blob["train"].params
    assert any(".blocks.1." in n for n in full)
    log = Path(tmp / f"pre_{name}_b" / "pretrain.log").read_text()
    assert "resumed at train step 2" in log


@pytest.mark.parametrize("name", ["gpipe", "tp"])
def test_pp_pretrain_matches_the_one_process_cli(runs, name):
    """`--parallel pp` at world 2 (two stages; one stage over a model pair)
    logs the one-process CLI's losses (to their 4 decimals) every step on
    the same seed and batches, and its checkpoint holds one process's
    tree, within `PARAM_ATOL` of that run's final parameters (the k
    LayerNorm's bias within `NOISE_ATOL`)."""
    want, _, tmp = runs
    losses = lambda log: re.findall(r"step (\d+)/4  loss (\S+)", log)  # noqa
    port_log = Path(tmp / f"pre_{name}_a" / "pretrain.log").read_text()
    one = (tmp / "one_process" / "pretrain.log").read_text()
    assert losses(port_log) == losses(one)
    assert len(losses(port_log)) == 4
    full = port_checkpoint.restore_state(
        str(tmp / f"pre_{name}_a" / "ckpt"))["train"].params
    ref = want["one_process"].params
    assert set(full) == set(ref)
    for n, p in full.items():
        atol = NOISE_ATOL if "k_norm.bias" in n else PARAM_ATOL
        np.testing.assert_allclose(p.numpy(), ref[n].detach().numpy(),
                                   rtol=0, atol=atol, err_msg=n)


@pytest.mark.parametrize("key,value", [("pp_stages", 2),
                                       ("pp_interleave", 2),
                                       ("pp_stages", None)])
def test_pp_resume_guard_refuses_as_the_jax_cli(monkeypatch, tmp_path, key,
                                                value):
    """A `--parallel pp` checkpoint of another stage count or interleave,
    or without the stamp, refuses `--resume` with the JAX CLI's words."""
    import uni_adapter_tpu.checkpoint as jax_checkpoint
    import uni_adapter_tpu.parallel.pp as jpp
    import uni_adapter_tpu.train as jax_train

    blob = {"data_seed": 0, "global_batch": 8, "parallel": "pp",
            "depth": 2, "wd_mask": "name", "corpus_size": 128, "lr": 1e-3,
            "weight_decay": 0.05, "warmup_steps": 1, "pp_stages": 1,
            "pp_interleave": 1, "pp_tp_size": 1}
    if value is None:
        del blob[key]
    else:
        blob[key] = value
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
            main([*PRETRAIN, "--pp-stages", "1", "--out", str(out),
                  "--steps", "4", "--resume"])
        texts.append(str(e.value))
    assert texts[0] == texts[1]
    assert key in texts[0]


def test_tp_with_another_backbone_raises_jax_error():
    """`make_pp_encode_fn` composes PP × TP for Uni3D only: asked for it
    with ULIP-2 it raises the JAX function's ValueError (its `tp_axis`
    named `tp_group` here), before anything is sharded."""
    from jax.sharding import Mesh

    from uni_adapter_tpu.models.pointbert import ULIP as JULIP
    from uni_adapter_tpu.parallel import pp as jpp
    from uni_adapter_torch.models.pointbert import ULIP
    from uni_adapter_torch.parallel import pp

    with pytest.raises(ValueError) as want:
        jpp.make_pp_encode_fn(JULIP(), Mesh(np.asarray(jax.devices()[:1]),
                                            ("stage",)), "ulip",
                              tp_axis="model")
    with pytest.raises(ValueError) as got:
        pp.make_pp_encode_fn(ULIP(depth=1), pp.make_stages(1), "ulip",
                             tp_group=object())
    assert str(got.value) == str(want.value).replace("tp_axis", "tp_group")
