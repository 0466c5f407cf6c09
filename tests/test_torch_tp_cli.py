"""`--trunk-parallel tp` through the port's TTA CLI and `TTAServer(encode_fn=
...)` (`parallel/trunk.py`, `serve.py`) against the port's replicated
runs, and the flags' validation against the JAX parser, at the small
dims of tests/test_torch_ep.py (Uni3D depth 1, width 48, D 32, fp32).

The world of two ranks is spawned once for the module
(`torch_dist_worker.py`, program `tp_cli`) and runs: the CLI over two
corruptions (the scan; the eager loop with `--continual`; the int8
trunk, which the JAX CLI runs with `--trunk-parallel tp` too), each
rank's results.json equal to the replicated CLI's here; the server, rank
0 serving two clients and a client restored from a snapshot while rank 1
follows, each client's logits within 1e-4 of its stream through
`engine.run_stream` here; and a model of 3 heads, which does not divide
over two ranks, raising the JAX CLI's error text.
"""
import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist_worker import _patched_cli, collect, start_world
from uni_adapter_tpu import config as jcfg
from uni_adapter_tpu.models.uni3d import Uni3D as JUni3D
from uni_adapter_tpu.parallel.trunk import prepare_trunk_parallel
from uni_adapter_torch import config as pcfg
from uni_adapter_torch import engine
from uni_adapter_torch.cli import tta
from uni_adapter_torch.models.uni3d import create_uni3d
from uni_adapter_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

D, N = 32, 64
SMALL = dict(pc_feat_dim=48, embed_dim=D, num_group=8, group_size=8,
             pc_encoder_dim=24, eva_depth=1, eva_heads=4,
             compute_dtype="float32")
CORRUPTIONS = ["uniform", "gaussian"]
CLI_ARGS = ["--npoints", "64", "--eva-depth", "1", "--pc-feat-dim", "48",
            "--embed-dim", "32", "--num-group", "8", "--group-size", "8",
            "--pc-encoder-dim", "24", "--eva-heads", "4",
            "--compute-dtype", "float32", "--corruption", "all",
            "--name", "run", "--device", "cpu"]
#: name: (flags, model)
RUNS = {"scan": ([], "small"),
        "eager_continual": (["--use-scan", "false", "--continual", "true",
                             "--batch-size", "3"], "small"),
        "int8": (["--quantize-int8", "true", "--dota-res-learning",
                  "false"], "int8")}


def _weights(trans_dim=48, heads=4):
    m = JUni3D(trans_dim=trans_dim, embed_dim=D, num_group=8, group_size=8,
               encoder_dim=24, depth=1, num_heads=heads, dtype=jnp.float32)
    params = jax.jit(m.init)(jax.random.PRNGKey(0),
                             jnp.zeros((1, N, 6), jnp.float32))
    rng = np.random.default_rng(0)
    return m, jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape)
        .astype(np.float32), params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world of two (spawned first), then the replicated runs here."""
    tmp = tmp_path_factory.mktemp("tp_cli")
    _, params = _weights()
    jodd, odd_params = _weights(trans_dim=36, heads=3)
    sd = from_jax_params(params)
    mcfg = {"small": pcfg.ModelConfig(**SMALL),
            "int8": pcfg.ModelConfig(**SMALL, quantize_int8=True),
            "odd": pcfg.ModelConfig(**dict(SMALL, pc_feat_dim=36,
                                           eva_heads=3))}
    models = {"small": (mcfg["small"], sd), "int8": (mcfg["int8"], sd),
              "odd": (mcfg["odd"], from_jax_params(odd_params))}
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
    cli = {name: ([*common, *flags, "--trunk-parallel", "tp",
                   "--output-dir", str(tmp / f"tp_{name}")], model)
           for name, (flags, model) in RUNS.items()}
    text = rng.standard_normal((6, D)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    streams = rng.standard_normal((2, 4, 1, N, 3)).astype(np.float32)
    cfg = pcfg.Config(model=pcfg.ModelConfig(**SMALL),
                      dota=pcfg.DotaConfig(res_learning=False))
    procs = start_world("tp_cli", {
        "models": models, "cli": cli, "cli_corruptions": CORRUPTIONS,
        "cfg": cfg, "text": text, "streams": streams,
        "snapshot": str(tmp / "snap_a"),
        "tp_cfg": pcfg.Config(run=pcfg.RunConfig(trunk_parallel="tp"))},
        tmp / "w2")

    want = {}
    built = {k: create_uni3d(c, "cpu", state_dict=sd)
             for k, c in mcfg.items() if k != "odd"}
    for name, (flags, model) in RUNS.items():
        want[name] = _patched_cli(tta, built[model], CORRUPTIONS)(
            [*common, *flags, "--output-dir", str(tmp / f"rep_{name}")])
    want["streams"] = []
    step = engine.make_step_fn(cfg, built["small"])
    for i in range(2):
        logits = []

        def recorded(text_init, state, batch):
            state, out = step(text_init, state, batch)
            logits.append(out.final_logits.numpy())
            return state, out

        pcs = streams[i]
        engine.run_stream(
            cfg, built["small"], torch.from_numpy(text),
            [(pcs[t], np.ones_like(pcs[t]), np.zeros(1, np.int64))
             for t in range(4)], seed=42 + i, step_fn=recorded)
        want["streams"].append(logits)
    try:
        prepare_trunk_parallel(jcfg.Config(run=jcfg.RunConfig(
            trunk_parallel="tp")), jodd, odd_params)
    except ValueError as e:
        want["indivisible"] = str(e)
    got = collect(procs, tmp / "w2", timeout=300.0)
    return want, got, tmp


def _ok(result):
    assert not (isinstance(result, dict) and "error" in result), \
        result.get("error")
    return result


@pytest.mark.parametrize("name", list(RUNS))
def test_tp_cli_matches_the_replicated_cli(runs, name):
    """Both ranks' CLI runs under `--trunk-parallel tp` report the
    replicated CLI's top-1 per corruption; rank 0 wrote results.json and
    results_zs.json, its log names the TP trunk."""
    want, got, tmp = runs
    for r in range(2):
        res = _ok(got[r][f"cli_{name}"])
        assert res["acc1"] == want[name]["acc1"]
        assert res["zs_acc1"] == want[name]["zs_acc1"]
        assert res["steps"] == want[name]["steps"]
    run_dir = tmp / f"tp_{name}" / "run"
    assert json.loads((run_dir / "results.json").read_text()) == \
        want[name]["acc1"]
    assert (run_dir / "results_zs.json").exists()
    log = (run_dir / "out.log").read_text()
    assert "trunk parallelism: tensor (Megatron), 2-way" in log
    assert "trunk parallel tp" in log


def test_tp_server_matches_each_clients_stream(runs):
    """`TTAServer(encode_fn=...)` over two ranks (rank 0 serves, rank 1
    follows): the two clients' logits, in ticks of two and one, within
    1e-4 of each client's stream through `engine.run_stream`, and a client
    restored from a's snapshot steps as a does."""
    want, got, _ = runs
    assert _ok(got[1]["server"]) == {"followed": True}
    res = _ok(got[0]["server"])
    ticks = res["ticks"]
    assert [sorted(t) for t in ticks] == [["a", "b"], ["a", "b"], ["a"]]
    for t, tick in enumerate(ticks):
        for i, cid in enumerate("ab"):
            if cid in tick:
                np.testing.assert_allclose(tick[cid], want["streams"][i][t],
                                           rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res["last"]["a"], want["streams"][0][3],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(res["last"]["a"], res["last"]["c"])


def test_tp_indivisible_heads_raise_jax_error(runs):
    """Three heads over two ranks: the JAX CLI's error around the reason,
    the mesh's size the world's."""
    want, got, _ = runs
    for r in range(2):
        text = _ok({"r": got[r]["indivisible"]})["r"]
        assert text is not None and "3 heads do not divide" in text
        pre, post = re.split(r" \(.*\)\)?\.  ", text, maxsplit=1)
        jpre, jpost = re.split(r" \(.*\)\)?\.  ", want["indivisible"],
                               maxsplit=1)
        assert pre == jpre.replace("8-device", "2-device")
        assert post == jpost


@pytest.mark.parametrize("flags", [
    ["--trunk-parallel", "tp", "--dist-mode", "ep"],
    ["--trunk-parallel", "tp", "--dist-mode", "psum"],
    ["--trunk-parallel", "tp", "--vmap-corruptions", "true"],
    ["--trunk-parallel", "xx"],
])
def test_trunk_parallel_flags_validate_as_jax(flags):
    """The combinations the JAX parser refuses raise its ValueError, word
    for word."""
    with pytest.raises(ValueError) as jerr:
        jcfg.parse_args(flags)
    with pytest.raises(ValueError) as perr:
        pcfg.parse_args(flags)
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("mode", ["pp", "sp"])
def test_pipeline_and_sequence_trunks_still_refused(mode):
    """Neither trunk is refused any more: `pp` and `sp` parse as the JAX
    parser reads them (pp's stage count and interleave too) and run
    (tests/test_torch_pp_cli.py, tests/test_torch_sp_cli.py); here, in a
    world of this process alone, the trunk's encoder gives the plain
    encoder's features within 1e-5."""
    import torch

    from uni_adapter_torch import engine
    from uni_adapter_torch.models.uni3d import create_uni3d
    from uni_adapter_torch.parallel.trunk import prepare_trunk_parallel

    flags = ["--trunk-parallel", mode] + (
        ["--trunk-stages", "1", "--pp-interleave", "2"] if mode == "pp"
        else [])
    got, want = pcfg.parse_args(flags).run, jcfg.parse_args(flags).run
    assert (got.trunk_parallel, got.trunk_stages, got.pp_interleave) == \
        (want.trunk_parallel, want.trunk_stages, want.pp_interleave)
    mcfg = pcfg.ModelConfig(pc_feat_dim=48, embed_dim=32, num_group=8,
                            group_size=8, pc_encoder_dim=24, eva_depth=2,
                            eva_heads=4, compute_dtype="float32")
    cfg = dataclasses.replace(pcfg.parse_args(flags), model=mcfg)
    model = create_uni3d(mcfg, "cpu")
    pc = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 64, 3)).astype(np.float32))
    rgb = torch.ones_like(pc)
    with torch.no_grad():
        _, encode = prepare_trunk_parallel(cfg, model)
        feat = engine.drive(engine.encoded(encode, pc, rgb), None)
        plain = engine.encode_with("uni3d", model)(pc, rgb)
    torch.testing.assert_close(feat, plain, rtol=1e-5, atol=1e-5)
