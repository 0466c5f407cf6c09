"""The port's pretraining CLI (`cli/pretrain.py`) on the CPU at the demo
size: its synthetic corpus bitwise the JAX CLI's, a resumed run (sync and
`--ckpt-async`) bitwise equal to an uninterrupted one, every refusal of
the resume guard word for word the JAX CLI's, and `--parallel pp` and
`--parallel sp` in a world of one."""
import os
from pathlib import Path

import pytest
import torch

import uni_adapter_tpu.checkpoint as jax_checkpoint
import uni_adapter_tpu.cli.pretrain as jax_cli
import uni_adapter_tpu.train as jax_train
import uni_adapter_torch.checkpoint as port_checkpoint
from uni_adapter_torch.cli import pretrain
from uni_adapter_torch.train import LOGIT_SCALE
from torch_threads import one_torch_thread  # noqa: F401

COMMON = ["--device", "cpu", "--batch-size", "8", "--depth", "1",
          "--trans-dim", "16", "--embed-dim", "16", "--num-group", "4",
          "--group-size", "4", "--encoder-dim", "8", "--heads", "2",
          "--warmup-steps", "1", "--log-every", "2", "--prefetch", "0"]


def test_synthetic_corpus_is_the_jax_clis_bitwise(tmp_path):
    port = pretrain._synthetic_corpus(str(tmp_path / "p"), dim=32)
    want = jax_cli._synthetic_corpus(str(tmp_path / "j"), dim=32)
    for a, b in zip(port, want):
        assert [Path(p).name for p in a] == [Path(p).name for p in b]
        for pa, pb in zip(a, b):
            assert Path(pa).read_bytes() == Path(pb).read_bytes()


def assert_states_equal(a, b):
    assert a.step == b.step
    assert a.opt_state.count == b.opt_state.count
    assert torch.equal(a.logit_scale, b.logit_scale)
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), name
    for x, y in ((a.opt_state.mu, b.opt_state.mu),
                 (a.opt_state.nu, b.opt_state.nu)):
        assert set(x) == set(y)
        assert all(torch.equal(x[n], y[n]) for n in x)


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_resumed_run_equals_uninterrupted_bitwise(tmp_path, async_ckpt):
    """4 steps in one go against 2 + 2 with `--resume` (with
    `--ckpt-async`, a checkpoint every step): the same parameters, moments,
    count and log-scale, bit for bit; the final checkpoint holds them."""
    extra = ["--ckpt-async"] if async_ckpt else []
    a = pretrain.main(COMMON + ["--out", str(tmp_path / "a"), "--steps", "4",
                                "--ckpt-every", "100"])
    out_b = str(tmp_path / "b")
    pretrain.main(COMMON + extra + ["--out", out_b, "--steps", "2",
                                    "--ckpt-every", "1" if async_ckpt
                                    else "2"])
    assert (port_checkpoint.restore_state(os.path.join(out_b, "ckpt"))
            ["train"].step == 2)
    b = pretrain.main(COMMON + extra + ["--out", out_b, "--steps", "4",
                                        "--ckpt-every", "100", "--resume"])
    assert a.step == b.step == 4
    assert_states_equal(a, b)
    saved = port_checkpoint.restore_state(os.path.join(out_b, "ckpt"))
    assert_states_equal(saved["train"], b)
    assert saved["wd_mask"] == "name" and saved["lr"] == 1e-3
    assert LOGIT_SCALE in b.opt_state.mu
    log = Path(out_b, "pretrain.log").read_text()
    assert "resumed at train step 2" in log


def test_resume_with_another_recipe_refuses(tmp_path):
    out = str(tmp_path / "r")
    pretrain.main(COMMON + ["--out", out, "--steps", "2", "--ckpt-every",
                            "2"])
    with pytest.raises(ValueError, match="data_seed"):
        pretrain.main(COMMON + ["--out", out, "--steps", "4", "--seed", "1",
                                "--resume"])
    with pytest.raises(ValueError, match="lr"):
        pretrain.main(COMMON + ["--out", out, "--steps", "4", "--lr", "0.01",
                                "--resume"])


def stamps() -> dict:
    """The stamps a checkpoint of a COMMON run over the synthetic corpus
    carries."""
    return {"data_seed": 0, "global_batch": 8, "parallel": "dp", "depth": 1,
            "wd_mask": "name", "corpus_size": 128, "lr": 1e-3,
            "weight_decay": 0.05, "warmup_steps": 1}


#: A checkpoint's stamps, changed; each refused by both CLIs.
REFUSALS = {
    "data_seed": {"data_seed": 1}, "global_batch": {"global_batch": 16},
    "depth": {"depth": 2}, "corpus_size": {"corpus_size": 64},
    "lr": {"lr": 0.01}, "weight_decay": {"weight_decay": 0.1},
    "warmup_steps": {"warmup_steps": 5}, "no lr stamp": {"lr": None},
    "no depth stamp": {"depth": None}, "parallel": {"parallel": "pp"},
    "wd_mask": {"wd_mask": "rank"}, "unstamped wd_mask": {"wd_mask": None},
}


def refusal(monkeypatch, tmp_path, cli_main, ckpt_module, blob) -> str:
    """The ValueError a `--resume` of `cli_main` raises on a checkpoint
    holding `blob`: its restore patched to return it, the JAX CLI's
    parameter init skipped (the guard runs before the state is used)."""
    out = tmp_path / cli_main.__module__
    out.mkdir()
    (out / "ckpt.npz").write_bytes(b"")
    monkeypatch.setattr(ckpt_module, "restore_state",
                        lambda *a, **k: dict(blob, train=None))
    monkeypatch.setattr(jax_train, "init_train_state", lambda *a: None)
    with pytest.raises(ValueError) as e:
        cli_main(COMMON + ["--out", str(out), "--steps", "4", "--resume"])
    return str(e.value)


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_resume_guard_refuses_as_the_jax_cli(monkeypatch, tmp_path, case):
    blob = stamps()
    for key, value in REFUSALS[case].items():
        if value is None:
            del blob[key]
        else:
            blob[key] = value
    got = refusal(monkeypatch, tmp_path, pretrain.main, port_checkpoint,
                  blob)
    want = refusal(monkeypatch, tmp_path, jax_cli.main, jax_checkpoint, blob)
    assert got == want


@pytest.fixture(scope="module")
def plain_run(tmp_path_factory):
    """Two steps of the plain one-process run (`--parallel dp`)."""
    return pretrain.main(COMMON + ["--out", str(tmp_path_factory.mktemp(
        "plain")), "--steps", "2"])


@pytest.mark.parametrize("flags", [
    ["--parallel", "pp"], ["--parallel", "sp"], ["--pp-stages", "2"],
    ["--pp-microbatches", "4"], ["--pp-interleave", "2"],
    ["--pp-tp-size", "2"]])
def test_parallel_modes_wait_for_m16(tmp_path, flags, plain_run):
    """Nothing waits for ROADMAP M16 any more.  In a world of one process
    `--parallel pp` is one stage and `--parallel sp` one shard of the
    tokens: their two steps equal the plain run's within 1e-6 (the
    clipping norm summed in another order; the ring's restated attention
    for sp), but for sp's k LayerNorm bias, whose exact gradient is 0, so
    that Adam's second step normalises noise (within `NOISE_ATOL`, as
    tests/test_torch_pp.py holds it); the `--pp-*` flags without pp are
    ignored, as the JAX CLI ignores them (the run bitwise the plain one).
    Their multi-rank runs: tests/test_torch_pp_cli.py,
    tests/test_torch_sp_cli.py."""
    state = pretrain.main(COMMON + flags + ["--out", str(tmp_path),
                                            "--steps", "2"])
    assert state.step == plain_run.step == 2
    for name, p in plain_run.params.items():
        if "sp" in flags and "k_norm.bias" in name:
            torch.testing.assert_close(state.params[name], p, rtol=0,
                                       atol=2.5e-3)
        elif "pp" in flags or "sp" in flags:
            torch.testing.assert_close(state.params[name], p, rtol=0,
                                       atol=1e-6)
        else:
            assert torch.equal(state.params[name], p), name


def test_multi_process_launch_waits_for_m16(tmp_path, monkeypatch):
    """A multi-process launch runs `--parallel dp` (two ranks:
    tests/test_torch_dp_train.py), `--parallel pp`
    (tests/test_torch_pp_cli.py) and `--parallel sp`
    (tests/test_torch_sp_cli.py); under one, a pipeline whose stages × tp
    size is not the world raises the JAX CLI's texts (the launch's size in
    the device count's place), all before any process group is set up."""
    import re

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    for flags, jflags in (
            (["--pp-stages", "4"], ["--pp-stages", "16"]),
            (["--pp-tp-size", "3"], ["--pp-tp-size", "3"])):
        with pytest.raises(ValueError) as got:
            pretrain.main(COMMON + ["--parallel", "pp", *flags, "--out",
                                    str(tmp_path / "p")])
        monkeypatch.delenv("WORLD_SIZE")
        with pytest.raises(ValueError) as want:
            jax_cli.main([a for a in COMMON if a != "cpu" and a != "--device"]
                         + ["--device", "cpu", "--parallel", "pp", *jflags,
                            "--out", str(tmp_path / "j")])
        monkeypatch.setenv("WORLD_SIZE", "2")
        digits = lambda t: re.sub(r"\d+", "N", str(t.value))  # noqa: E731
        assert digits(got) == digits(want)
    with pytest.raises(ValueError, match="needs a launch of exactly 1 "
                       "processes, this one has 2"):
        pretrain.main(COMMON + ["--parallel", "pp", "--pp-stages", "1",
                                "--out", str(tmp_path / "q")])
    assert not torch.distributed.is_initialized()


def test_cuda_without_a_gpu_raises_and_cli_returns_0(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in COMMON if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        pretrain.main(args + ["--out", str(tmp_path / "g")])
    monkeypatch.setattr("sys.argv", ["pretrain"] + COMMON + [
        "--out", str(tmp_path / "c"), "--steps", "1"])
    assert pretrain.cli() == 0
