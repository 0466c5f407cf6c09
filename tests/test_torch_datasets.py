"""The dataset families, labels and shipped anchor banks of the port against
the JAX package's, on tiny synthetic `.npy` files, and CPU runs of the
CLI on a ScanObjectNN-C stream (shipped bank) and an Objaverse-LVIS stream
(a 1156-row bank file)."""
import json

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


#: (dataset name, number of classes); OmniObject3D has no labels.json key
#: of its own, so its runs name one.
FAMILIES = [("scanobjectnn", 15), ("shapenetcore", 55),
            ("objaverse_lvis", 1156), ("omniobject3d", 1156)]


def _write_stream(root, n_classes, n_clouds=7, n_points=64, label_rows=False):
    rng = np.random.default_rng(n_classes)
    np.save(root / "data_uniform_5.npy",
            rng.standard_normal((n_clouds, n_points, 3)).astype(np.float32))
    labels = rng.integers(0, n_classes, n_clouds).astype(np.int64)
    # ScanObjectNN stores its labels as [1, T]
    np.save(root / "label.npy", labels[None] if label_rows else labels)


def _configs(root, name, debug=False):
    key = "objaverse_lvis_openshape" if "omniobject" in name else None
    kw = dict(root=str(root), dataset_name=name, corruption="uniform",
              debug=debug, validate_dataset_name=key)
    return (pcfg.Config(data=pcfg.DataConfig(**kw)).resolve(),
            jcfg.Config(data=jcfg.DataConfig(**kw)).resolve())


@pytest.mark.parametrize("debug", [False, True])
@pytest.mark.parametrize("name,n_classes", FAMILIES)
def test_family_loaders_match_jax(tmp_path, name, n_classes, debug):
    _write_stream(tmp_path, n_classes, label_rows=name == "scanobjectnn")
    p_cfg, j_cfg = _configs(tmp_path, name, debug)
    assert p_cfg.data.validate_dataset_name == j_cfg.data.validate_dataset_name
    p = pdata.load_tta_dataset(p_cfg)
    j = jdata.load_tta_dataset(j_cfg)
    assert len(p) == len(j) == (5 if debug else 7)
    np.testing.assert_array_equal(p.data, j.data)
    np.testing.assert_array_equal(p.labels, j.labels)
    assert p.class_names == j.class_names and len(p.class_names) == n_classes
    assert p[2][2] == j[2][2]


def test_unknown_family_and_missing_files_raise_as_in_jax(tmp_path):
    for module, config in ((pdata, pcfg), (jdata, jcfg)):
        cfg = config.Config(data=config.DataConfig(
            root=str(tmp_path), dataset_name="kitti", corruption="uniform"))
        with pytest.raises(NotImplementedError, match="Dataset kitti is not"):
            module.load_tta_dataset(cfg)
        np.save(tmp_path / "data_uniform_5.npy", np.zeros((1, 8, 3)))
        cfg = config.Config(data=config.DataConfig(
            root=str(tmp_path), dataset_name="scanobjectnn",
            corruption="uniform"))
        with pytest.raises(FileNotFoundError, match="Label file not found"):
            module.load_tta_dataset(cfg)


@pytest.mark.parametrize("name", ["modelnet40_c", "ScanObjectNN", "shapenet",
                                  "objaverse_lvis", "lvis", "omniobject3d"])
def test_labels_key_and_labels_match_jax(name):
    """The key inferred from the name, `resolve` leaving None where it
    cannot infer (OmniObject3D), and the labels read for the key."""
    try:
        want = jcfg.labels_key_for(name)
    except ValueError:
        with pytest.raises(ValueError, match="--validate-dataset-name"):
            pcfg.labels_key_for(name)
        assert pcfg.Config(data=pcfg.DataConfig(dataset_name=name)).resolve(
            ).data.validate_dataset_name is None
        with pytest.raises(ValueError):
            pcfg.load_labels(pcfg.Config(data=pcfg.DataConfig(
                dataset_name=name)))
        return
    assert pcfg.labels_key_for(name) == want
    p_cfg = pcfg.parse_args(["--dataset-name", name])
    assert p_cfg.data.validate_dataset_name == want
    assert pcfg.load_labels(p_cfg) == jcfg.load_labels(
        jcfg.parse_args(["--dataset-name", name]))


def test_explicit_labels_key_wins_and_is_read_from_labels_path(tmp_path):
    path = tmp_path / "labels.json"
    path.write_text(json.dumps({"mine": ["a", "b"]}))
    cfg = pcfg.parse_args(["--dataset-name", "omniobject3d",
                           "--validate-dataset-name", "mine",
                           "--labels-path", str(path)])
    assert pcfg.load_labels(cfg) == ["a", "b"]
    cfg = pcfg.parse_args(["--dataset-name", "scanobjectnn",
                           "--validate-dataset-name",
                           "objaverse_lvis_openshape"])
    assert len(pcfg.load_labels(cfg)) == 1156


@pytest.mark.parametrize("size,dataset,shape", [
    ("large", "modelnet", (40, 1024)), ("giant", "modelnet40", (40, 1024)),
    ("large", "scanobjectnn", (15, 1024)), ("large", "shapenetcore",
                                            (55, 1024)),
    ("large", None, (40, 1024))])
def test_shipped_banks_are_the_jax_packages(size, dataset, shape):
    got = load_precomputed(size, dataset)
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_load_precomputed(size, dataset)))


@pytest.mark.parametrize("size,dataset,match", [
    ("large", "objaverse_lvis", "no shipped anchor-bank family"),
    ("giant", "scanobjectnn", "available sizes: \\['large'\\]"),
    ("huge", "modelnet", "no shipped 'huge' bank")])
def test_bank_family_errors_as_in_jax(size, dataset, match):
    for load in (load_precomputed, jax_load_precomputed):
        with pytest.raises(KeyError, match=match):
            load(size, dataset)


SMALL_UNI3D = ["--npoints", "64", "--eva-depth", "1", "--pc-feat-dim", "64",
               "--num-group", "8", "--group-size", "8", "--pc-encoder-dim",
               "32", "--eva-heads", "4", "--compute-dtype", "float32"]
SMALL_ULIP = ["--vlm3d", "ulip", "--npoints", "64", "--ulip-trans-dim", "64",
              "--ulip-depth", "1", "--ulip-heads", "4", "--num-group", "8",
              "--ulip-group-size", "8", "--ulip-encoder-dim", "32",
              "--ulip-embed-dim", "32", "--compute-dtype", "float32"]


@pytest.mark.parametrize("name,n_classes,flags,bank", [
    ("scanobjectnn", 15, SMALL_UNI3D, "large"),
    ("objaverse_lvis", 1156, SMALL_ULIP, 32),
], ids=["scanobjectnn-shipped-bank", "objaverse_lvis-bank-file"])
def test_cli_on_cpu_runs_a_family(tmp_path, name, n_classes, flags, bank):
    """The CLI streams the family's clouds; K comes from the bank (15 rows
    of the shipped ScanObjectNN bank, 1156 of a seeded file)."""
    _write_stream(tmp_path, n_classes, n_clouds=4,
                  label_rows=name == "scanobjectnn")
    if bank != "large":
        rows = np.random.default_rng(0).standard_normal((n_classes, bank))
        np.save(tmp_path / "bank.npy", (rows / np.linalg.norm(
            rows, axis=1, keepdims=True)).astype(np.float32))
        bank = str(tmp_path / "bank.npy")
    summary = tta.main(["--device", "cpu", "--root", str(tmp_path),
                        "--dataset-name", name, "--corruption", "uniform",
                        "--precomputed-text-features", bank,
                        "--output-dir", str(tmp_path / "out"), "--name",
                        "run", *flags])
    for f in ("results.json", "results_zs.json"):
        res = json.loads((tmp_path / "out" / "run" / f).read_text())
        assert set(res) == {"uniform"} and 0.0 <= res["uniform"] <= 100.0
    assert len(summary["step_ms"]["uniform"]) == 4
    assert summary["finite"]["uniform"]
