"""The port's entry point, data, anchors and config on the CPU, and the
rule that the port imports nothing of JAX or of the JAX package."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from uni_adapter_tpu import config as jcfg
from uni_adapter_tpu.anchors import load_precomputed as jax_load_precomputed
from uni_adapter_tpu.data import datasets as jdata
from uni_adapter_torch import config as pcfg
from uni_adapter_torch.anchors import load_precomputed
from uni_adapter_torch.cli import tta
from uni_adapter_torch.data import datasets as pdata
from torch_threads import one_torch_thread  # noqa: F401


REPO = Path(__file__).resolve().parent.parent
SMALL_ARGS = ["--npoints", "128", "--eva-depth", "2", "--pc-feat-dim", "64",
              "--num-group", "16", "--group-size", "8",
              "--pc-encoder-dim", "32", "--eva-heads", "4",
              "--compute-dtype", "float32",
              "--precomputed-text-features", "large"]


@pytest.fixture
def stream_dir(tmp_path):
    """The fast recipe's synthetic corruption set (8 clouds × 128 points)."""
    rng = np.random.default_rng(0)
    np.save(tmp_path / "data_uniform_5.npy",
            rng.standard_normal((8, 128, 3)).astype(np.float32))
    np.save(tmp_path / "label.npy", rng.integers(0, 40, (8,)).astype(np.int64))
    return tmp_path


def test_cli_on_cpu_writes_both_result_files(stream_dir, tmp_path):
    summary = tta.main(["--device", "cpu", "--root", str(stream_dir),
                        "--corruption", "uniform", "--output-dir",
                        str(tmp_path / "out"), "--name", "run",
                        *SMALL_ARGS])
    log_dir = tmp_path / "out" / "run"
    for name in ("results.json", "results_zs.json"):
        res = json.loads((log_dir / name).read_text())
        assert set(res) == {"uniform"} and 0.0 <= res["uniform"] <= 100.0
    assert (log_dir / "out.log").exists()
    assert len(summary["step_ms"]["uniform"]) == 8
    assert summary["finite"]["uniform"]


def test_cli_cache_path_on_cpu_writes_both_result_files(stream_dir,
                                                        tmp_path):
    """`--dota-use-mode-dota false` runs the prototype cache path."""
    summary = tta.main(["--device", "cpu", "--root", str(stream_dir),
                        "--corruption", "uniform", "--output-dir",
                        str(tmp_path / "out"), "--name", "cache",
                        "--dota-use-mode-dota", "false", *SMALL_ARGS])
    log_dir = tmp_path / "out" / "cache"
    for name in ("results.json", "results_zs.json"):
        res = json.loads((log_dir / name).read_text())
        assert set(res) == {"uniform"} and 0.0 <= res["uniform"] <= 100.0
    assert len(summary["step_ms"]["uniform"]) == 8
    assert summary["finite"]["uniform"]
    assert summary["steps"]["uniform"] == [0, 8]


def test_cli_cache_path_with_batch_above_one_raises(stream_dir, tmp_path):
    """The cache path is batch 1 (the JAX engine's ValueError)."""
    with pytest.raises(ValueError, match="batch_size=1"):
        tta.main(["--device", "cpu", "--root", str(stream_dir),
                  "--corruption", "uniform", "--output-dir",
                  str(tmp_path / "out"), "--dota-use-mode-dota", "false",
                  "--batch-size", "2", *SMALL_ARGS])


def test_cli_without_gpu_and_without_device_cpu_raises(stream_dir):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tta.main(["--root", str(stream_dir), "--corruption", "uniform",
                  *SMALL_ARGS])


@pytest.mark.parametrize("flags,item", [
    (["--trunk-parallel", "pp"], "pipeline, 1 stages x 1 chunks/stage"),
    (["--trunk-parallel", "sp"], "sequence (ring attention), 1-way"),
])
def test_unported_paths_raise_and_name_their_roadmap_item(flags, item,
                                                          stream_dir,
                                                          tmp_path):
    """Nothing waits for ROADMAP M16 any more: the pipeline-parallel trunk
    and the sequence-parallel one run.  In a world of this process alone
    the pipeline is one stage and the ring one shard, and results.json is
    the run's without them; the log names the trunk (`item`).  (Their
    multi-rank runs: test_torch_pp_cli.py, test_torch_sp_cli.py;
    `--dist-mode sharded` and `psum`: tests/test_torch_parallel.py; `ep`:
    test_torch_ep.py and below; `--trunk-parallel tp`:
    test_torch_tp_cli.py.)"""
    argv = ["--device", "cpu", "--root", str(stream_dir), *SMALL_ARGS,
            "--corruption", "uniform", "--name", "run"]
    got = tta.main([*argv, *flags, "--output-dir", str(tmp_path / "trunk")])
    want = tta.main([*argv, "--output-dir", str(tmp_path / "plain")])
    assert got["acc1"] == want["acc1"]
    log = (tmp_path / "trunk" / "run" / "out.log").read_text()
    assert f"trunk parallelism: {item}" in log


@pytest.mark.parametrize("cli", ["tta", "serve"])
def test_unknown_backbone_raises_the_jax_clis_error(cli, stream_dir,
                                                    tmp_path):
    """`--vlm3d foo` raises the JAX CLIs' ValueError, its type and text
    (their `build_model`), before a backbone is built."""
    import importlib

    argv = ["--device", "cpu", "--root", str(stream_dir), *SMALL_ARGS,
            "--corruption", "uniform", "--vlm3d", "foo"]
    errors = []
    for package in ("uni_adapter_torch", "uni_adapter_tpu"):
        main = importlib.import_module(f"{package}.cli.{cli}").main
        with pytest.raises(Exception) as e:
            main([*argv, "--output-dir", str(tmp_path / package)])
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1] == (ValueError, "foo")


@pytest.mark.parametrize("flags", [
    ["--corruption", "uniform"],
    ["--corruption", "all", "--vmap-corruptions", "true"],
    ["--corruption", "all", "--continual", "true"],
])
def test_dist_mode_ep_runs_where_it_was_refused(flags, tmp_path):
    """`--dist-mode ep` alone, with `--vmap-corruptions` and with
    `--continual`, in a world of this process alone: results.json is the
    replicated run's, the continual carry's step counters chain, and there
    is no results_zs.json (the JAX CLI writes none under ep).  (Two ranks:
    tests/test_torch_ep.py.)"""
    from uni_adapter_torch.config import CORRUPTIONS

    rng = np.random.default_rng(0)
    for corr in CORRUPTIONS:
        np.save(tmp_path / f"data_{corr}_5.npy",
                rng.standard_normal((2, 128, 3)).astype(np.float32))
    np.save(tmp_path / "label.npy", rng.integers(0, 40, (2,)).astype(np.int64))
    common = ["--device", "cpu", "--root", str(tmp_path), *SMALL_ARGS,
              *flags, "--dota-res-learning", "false"]
    base = tta.main([*common, "--output-dir", str(tmp_path / "base"),
                     "--name", "run"])
    got = tta.main([*common, "--output-dir", str(tmp_path / "ep"),
                    "--name", "run", "--dist-mode", "ep"])
    assert got["acc1"] == base["acc1"]
    assert json.loads((tmp_path / "ep" / "run" / "results.json")
                      .read_text()) == base["acc1"]
    assert not (tmp_path / "ep" / "run" / "results_zs.json").exists()
    if "--continual" in flags:
        assert got["steps"] == base["steps"]
        assert got["steps"][CORRUPTIONS[-1]] == [28, 30]


def test_port_imports_no_jax_and_builds_nothing():
    """Import every module of the port in a fresh interpreter (this test
    process has JAX loaded by conftest.py)."""
    code = """
import importlib, pkgutil, sys
before = set(sys.modules)
import uni_adapter_torch
for m in pkgutil.walk_packages(uni_adapter_torch.__path__, "uni_adapter_torch."):
    importlib.import_module(m.name)
new = set(sys.modules) - before
bad = sorted(n for n in new if n.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "uni_adapter_tpu", "triton",
              "regex", "ftfy", "sklearn", "matplotlib"))
assert not bad, bad
from uni_adapter_torch.ops import build
from uni_adapter_torch.native import loader
assert build.load.cache_info().currsize == 0
assert loader._lib is None and not loader._build_failed
print(" ".join(sorted(n for n in new if n.startswith("uni_adapter_torch"))))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert len(names) >= 32
    assert {f"uni_adapter_torch.{m}" for m in (
        "adapt.dota", "adapt.gmm", "adapt.adaptive", "utils.kmeans",
        "utils.profiling", "ops.pointnet", "utils.tokenizer",
        "models.clip_text", "models.loader", "cli.build_anchors",
        "checkpoint", "serve", "serve_http", "client", "cli.serve",
        "utils.logging", "train", "models.losses", "models.dvae",
        "models.dvae_train", "cli.pretrain", "data.streaming",
        "data.augment", "data.synthetic_stream", "native.loader",
        "parallel.bootstrap", "parallel.mesh", "parallel.collectives",
        "analysis.cross_class", "cli.cross_class", "utils.tsne")} <= names


def test_as_arrays_and_iter_batches_match_jax_on_ragged_clouds():
    """Clouds of other sizes are resampled with the same seeded draws."""
    rng = np.random.default_rng(5)
    data = np.empty(5, dtype=object)
    for i, n in enumerate((100, 128, 90, 128, 140)):
        data[i] = rng.standard_normal((n, 3)).astype(np.float32)
    labels = rng.integers(0, 40, 5)
    pds = pdata.TTADataset(data, labels, pdata.MODELNET40_CLASSES)
    jds = jdata.TTADataset(data, labels, jdata.MODELNET40_CLASSES)
    for a, b in zip(pds.as_arrays(2, npoints=128, seed=3),
                    jds.as_arrays(2, npoints=128, seed=3)):
        np.testing.assert_array_equal(a, b)
    for pa, ja in zip(pds.iter_batches(2, npoints=128, seed=3),
                      jds.iter_batches(2, npoints=128, seed=3)):
        for a, b in zip(pa, ja):
            np.testing.assert_array_equal(a, b)


def test_modelnet_loader_matches_jax(stream_dir):
    cfg_p = pcfg.Config(data=pcfg.DataConfig(root=str(stream_dir),
                                             corruption="uniform"))
    cfg_j = jcfg.Config(data=jcfg.DataConfig(root=str(stream_dir),
                                             corruption="uniform"))
    p = pdata.load_tta_dataset(cfg_p)
    j = jdata.load_tta_dataset(cfg_j)
    np.testing.assert_array_equal(p.data, j.data)
    np.testing.assert_array_equal(p.labels, j.labels)
    assert p.class_names == j.class_names


def test_anchor_bank_is_the_jax_packages():
    got = load_precomputed("large", "modelnet")
    assert got.dtype == torch.float32 and got.shape == (40, 1024)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_load_precomputed("large", "modelnet")))


def test_anchor_bank_from_npz_and_missing_paths_as_in_jax(tmp_path,
                                                         monkeypatch):
    """A .npz archive gives its first array; a missing path ending in .npy
    or .npz raises FileNotFoundError, in both packages."""
    bank = np.random.default_rng(0).standard_normal((40, 512))
    np.savez(tmp_path / "bank.npz", bank, np.zeros(3))
    path = str(tmp_path / "bank.npz")
    got = load_precomputed(path)
    assert got.dtype == torch.float32 and got.shape == (40, 512)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_load_precomputed(path)))
    monkeypatch.chdir(tmp_path)
    for missing in ("missing.npz", "missing.npy"):
        for load in (load_precomputed, jax_load_precomputed):
            with pytest.raises(FileNotFoundError):
                load(missing)


def test_config_copy_keeps_the_jax_defaults():
    for pc, jc in ((pcfg.ModelConfig, jcfg.ModelConfig),
                   (pcfg.DotaConfig, jcfg.DotaConfig),
                   (pcfg.CacheConfig, jcfg.CacheConfig),
                   (pcfg.DataConfig, jcfg.DataConfig),
                   (pcfg.RunConfig, jcfg.RunConfig)):
        jdefaults = {f.name: f.default for f in dataclasses.fields(jc)}
        for f in dataclasses.fields(pc):
            if f.name == "device":     # the port runs on cuda by default
                assert f.default == "cuda"
                continue
            if f.name in ("labels_path", "templates_path"):
                # the port's own copy of the file
                assert Path(f.default).read_bytes() == Path(
                    jdefaults[f.name]).read_bytes()
                assert Path(f.default).parent == REPO / (
                    "uni_adapter_torch/assets")
                continue
            assert f.default == jdefaults[f.name], (pc.__name__, f.name)
    cfg = pcfg.parse_args(["--eva-depth", "2", "--dota-mode-M", "3"])
    assert cfg.model.eva_depth == 2 and cfg.dota.mode_M == 3
    assert {f.name for f in dataclasses.fields(pcfg.CacheConfig)} == {
        f.name for f in dataclasses.fields(jcfg.CacheConfig)}
    # quantize_int8 is a model variant (held to the JAX default above);
    # the kernel-selection fields stay out
    assert "quantize_int8" in {f.name for f in
                               dataclasses.fields(pcfg.ModelConfig)}
    assert not any(f.name.startswith("use_pallas") or f.name == "approx_knn"
                   for f in dataclasses.fields(pcfg.ModelConfig))


@pytest.mark.parametrize("argv", [
    [], ["--dataset-name", "scanobjectnn"], ["--dataset-name", "shapenetcore"],
    ["--dataset-name", "objaverse_lvis"],
    ["--dataset-name", "shapenetcore", "--cache-lambda-reg", "0.3",
     "--cache-use-new-approximation", "true", "--cache-shot-capacity", "8",
     "--cache-graph-mode", "prototype", "--cache-cg-tol", "1e-3"],
])
def test_cache_table_and_flags_as_in_jax(argv):
    """The per-dataset cache table, explicit --cache-* flags beating it,
    and `get_hyperparams`, as the JAX parser gives them."""
    got, want = pcfg.parse_args(argv).cache, jcfg.parse_args(argv).cache
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    name = dict(zip(argv[::2], argv[1::2])).get("--dataset-name", "modelnet")
    assert pcfg.get_hyperparams(name) == jcfg.get_hyperparams(name)


def test_eager_loop_keeps_the_short_last_batch_as_the_jax_cli(stream_dir,
                                                             tmp_path,
                                                             monkeypatch):
    """`--use-scan false --batch-size 3` over 8 clouds: 3 steps (3, 3 and 2
    clouds), all 8 counted, as the JAX CLI's eager loop
    (`iter_batches`) takes them; on the JAX CLI's own random weights, its
    results.json equal to the port's.  The scan path keeps whole batches
    only (2 steps, 6 clouds), as JAX's does."""
    from uni_adapter_tpu.cli import tta as jtta
    from uni_adapter_torch.models.uni3d import create_uni3d
    from uni_adapter_torch.weights import from_jax_params

    built = {}

    def build_model(cfg):
        built["model"], built["params"] = jax_build(cfg)
        return built["model"], built["params"]

    jax_build = jtta.build_model
    monkeypatch.setattr(jtta, "build_model", build_model)
    base = ["--device", "cpu", "--root", str(stream_dir), "--corruption",
            "uniform", "--batch-size", "3", *SMALL_ARGS]
    argv = [*base, "--use-scan", "false"]
    want = jtta.main([*argv, "--output-dir", str(tmp_path / "jax"),
                      "--name", "run"])
    port = create_uni3d(pcfg.parse_args(argv).model, "cpu",
                        state_dict=from_jax_params(built["params"]))
    monkeypatch.setattr(tta, "build_backbone",
                        lambda *a, **k: (port, None, None))
    calls = []
    run_stream = tta.engine.run_stream

    def counted(*args, **kwargs):
        res = run_stream(*args, **kwargs)
        calls.append(res["n"])
        return res

    monkeypatch.setattr(tta.engine, "run_stream", counted)
    summary = tta.main([*argv, "--output-dir", str(tmp_path / "out"),
                        "--name", "run"])
    assert summary["steps"]["uniform"] == [0, 3]
    assert len(summary["step_ms"]["uniform"]) == 3
    assert calls == [8] and summary["n"]["uniform"] == 8
    assert summary["acc1"] == want
    assert json.loads((tmp_path / "out" / "run" / "results.json")
                      .read_text()) == json.loads(
        (tmp_path / "jax" / "run" / "results.json").read_text())
    scan = tta.main([*base, "--output-dir", str(tmp_path / "scan"),
                     "--name", "run"])
    assert scan["steps"]["uniform"] == [0, 2] and scan["n"]["uniform"] == 6


@pytest.mark.parametrize("variant", ["dota", "gmm-dota", "adaptive-dota"])
def test_cli_runs_each_dota_variant_scan_and_eager(stream_dir, tmp_path,
                                                   variant):
    """`--dota-use-mode-dota false --dota-use-<variant> true`: the scan and
    the eager loop write the same results.json and results_zs.json, 8
    steps, finite logits, and the batch-0 figure."""
    out = {}
    for scan in ("true", "false"):
        summary = tta.main([
            "--device", "cpu", "--root", str(stream_dir), "--corruption",
            "uniform", "--output-dir", str(tmp_path / scan), "--name", "run",
            "--dota-use-mode-dota", "false", f"--dota-use-{variant}", "true",
            "--use-scan", scan, *SMALL_ARGS])
        assert summary["steps"]["uniform"] == [0, 8]
        assert summary["finite"]["uniform"]
        log_dir = tmp_path / scan / "run"
        out[scan] = [json.loads((log_dir / f).read_text())
                     for f in ("results.json", "results_zs.json")]
        assert (log_dir / "vis_uniform_batch_0.html").exists()
    assert out["true"] == out["false"]


def test_batch0_figure_and_profile_dir(stream_dir, tmp_path):
    """At batch 2, the batch-0 figure holds the first two clouds under the
    JAX CLI's names; `--profile-dir` writes a Chrome trace of the loop
    that holds the step's operators."""
    prof = tmp_path / "prof"
    tta.main(["--device", "cpu", "--root", str(stream_dir), "--corruption",
              "uniform", "--output-dir", str(tmp_path / "out"), "--name",
              "run", "--profile-dir", str(prof), "--batch-size", "2",
              *SMALL_ARGS])
    html = (tmp_path / "out" / "run" / "vis_uniform_batch_0.html").read_text()
    labels = np.load(stream_dir / "label.npy")
    for j in range(2):
        name = pdata.MODELNET40_CLASSES[labels[j]]
        assert f"Sample_{j}_{name}" in html
    assert "uniform batch 0 input" in html
    traces = list(prof.glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_fetch_synced_time_times_each_call():
    """`utils/profiling.fetch_synced_time`: one untimed call, then the
    repeats; the last output and seconds a call."""
    from uni_adapter_torch.utils import profiling

    calls = []
    out, sec = profiling.fetch_synced_time(
        lambda x: calls.append(x) or x * 2, 3, repeats=4)
    assert out == 6 and len(calls) == 5 and 0 <= sec < 1
