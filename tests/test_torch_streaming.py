"""The port's streaming ingestion (`data/streaming.py`) and native .npy
reader (`native/loader.py`) against the JAX package's on the same shard
files: the same batches through epochs, reshuffles, rank slices,
prefetch, mid-epoch resume and retried gathers, the same validation
errors, and reads equal to numpy's."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from uni_adapter_tpu.data.streaming import ShardedCorpus as JaxCorpus
from uni_adapter_tpu.data.streaming import StreamingLoader as JaxLoader
from uni_adapter_torch.data.streaming import (ShardedCorpus, StreamingLoader,
                                              global_batch)
from uni_adapter_torch.native import loader as native
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
N, C, D = 8, 6, 4
SHARD_SIZES = (5, 7, 4)          # 16 samples
KEYS = ("pc", "text_embed", "image_embed", "mask")


@pytest.fixture()
def shards(tmp_path):
    """Shard files whose content encodes each sample's global index."""
    g = 0
    paths = {"pc": [], "tx": [], "im": []}
    for si, n in enumerate(SHARD_SIZES):
        pc = np.zeros((n, N, C), np.float32)
        tx = np.zeros((n, D), np.float32)
        im = np.zeros((n, D), np.float32)
        for r in range(n):
            pc[r], tx[r], im[r] = g, 10 * g, 100 * g
            g += 1
        for arr, tag in ((pc, "pc"), (tx, "tx"), (im, "im")):
            p = str(tmp_path / f"{tag}_{si}.npy")
            np.save(p, arr)
            paths[tag].append(p)
    return paths


def both(shards):
    args = (shards["pc"], shards["tx"], shards["im"])
    return ShardedCorpus(*args), JaxCorpus(*args)


def assert_same(a, b):
    assert a["step"] == b["step"] and a["epoch"] == b["epoch"]
    for k in KEYS:
        np.testing.assert_array_equal(a[k], b[k])


def test_gather_matches_jax_across_shards(shards):
    port, jax_ = both(shards)
    idx = np.array([0, 4, 5, 11, 12, 15])
    got, want = port.gather(idx), jax_.gather(idx)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["mask"].tolist() == [0.0] + [1.0] * 5
    assert len(port) == len(jax_) == 16


@pytest.mark.parametrize("count", [1, 2, 4])
def test_epochs_and_rank_slices_match_jax(shards, count):
    """Every rank's batches over three epochs (reshuffled each epoch) equal
    JAX's, and the ranks' slices concatenate to the one-process stream."""
    port, jax_ = both(shards)
    whole = StreamingLoader(port, 8, seed=3, prefetch=0)
    for rank in range(count):
        p = StreamingLoader(port, 8, seed=3, process_index=rank,
                            process_count=count, prefetch=0)
        j = JaxLoader(jax_, 8, seed=3, process_index=rank,
                      process_count=count, prefetch=0)
        for _ in range(6):
            assert_same(next(p), next(j))
    rows = [[next(StreamingLoader(port, 8, seed=3, process_index=r,
                                  process_count=count, prefetch=0))["pc"]
             for r in range(count)]]
    np.testing.assert_array_equal(np.concatenate(rows[0]), next(whole)["pc"])


def test_prefetch_matches_sync_and_jax(shards):
    port, jax_ = both(shards)
    pre = StreamingLoader(port, 4, seed=1, prefetch=3)
    sync = JaxLoader(jax_, 4, seed=1, process_index=0, process_count=1,
                     prefetch=0)
    for _ in range(9):
        assert_same(next(pre), next(sync))
    pre.close()


def test_resume_mid_epoch_with_prefetch(shards):
    port, jax_ = both(shards)
    a = StreamingLoader(port, 4, seed=9, prefetch=2)
    [next(a) for _ in range(3)]
    state = a.state_dict()
    assert state == {"epoch": 0, "step": 3, "seed": 9}
    tail = [next(a) for _ in range(3)]            # crosses the epoch edge
    a.close()
    j = JaxLoader(jax_, 4, seed=9, process_index=0, process_count=1,
                  prefetch=2)
    j.load_state_dict(state)
    b = StreamingLoader(port, 4, seed=9, prefetch=2)
    b.load_state_dict(state)
    for x in tail:
        y, z = next(b), next(j)
        assert_same(x, y)
        assert_same(x, z)
    # load_state_dict rewinds a loader that is already running
    [next(b) for _ in range(2)]
    b.load_state_dict(state)
    assert_same(next(b), tail[0])
    b.close()
    j.close()


class Flaky:
    def __init__(self, inner):
        self.inner, self.fail_next = inner, 0

    def __len__(self):
        return len(self.inner)

    def gather(self, idx):
        if self.fail_next > 0:
            self.fail_next -= 1
            raise ValueError("transient read failure")
        return self.inner.gather(idx)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_failed_gather_is_retried_at_the_same_batch(shards, prefetch):
    port, _ = both(shards)
    flaky = Flaky(port)
    ld = StreamingLoader(flaky, 4, seed=5, prefetch=prefetch)
    ref = StreamingLoader(port, 4, seed=5, prefetch=0)
    if prefetch:
        flaky.fail_next = 1                       # the producer's first batch
        with pytest.raises(ValueError, match="transient"):
            next(ld)
        assert_same(next(ld), next(ref))
    else:
        assert_same(next(ld), next(ref))
        flaky.fail_next = 1
        with pytest.raises(ValueError, match="transient"):
            next(ld)
        assert_same(next(ld), next(ref))
    ld.close()


def raised(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_validation_errors_match_jax(shards, tmp_path):
    port, jax_ = both(shards)
    for p_call, j_call in (
            (lambda: StreamingLoader(port, 5, process_index=0,
                                     process_count=2),
             lambda: JaxLoader(jax_, 5, process_index=0, process_count=2)),
            (lambda: StreamingLoader(port, 32),
             lambda: JaxLoader(jax_, 32, process_index=0, process_count=1))):
        assert raised(p_call) == raised(j_call)
    ld = StreamingLoader(port, 4, seed=1)
    jl = JaxLoader(jax_, 4, seed=1, process_index=0, process_count=1)
    bad_seed = {"epoch": 0, "step": 0, "seed": 2}
    assert (raised(lambda: ld.load_state_dict(bad_seed))
            == raised(lambda: jl.load_state_dict(bad_seed)))
    rows = str(tmp_path / "rows.npy")
    np.save(rows, np.zeros((3, D), np.float32))
    wide = str(tmp_path / "wide.npy")
    np.save(wide, np.zeros((7, 1), np.float32))    # broadcastable: refused
    other_n = str(tmp_path / "n.npy")
    np.save(other_n, np.zeros((7, N + 1, C), np.float32))
    for args in (([shards["pc"][0]], [rows]),
                 (shards["pc"][:2], [shards["tx"][0], wide]),
                 ([shards["pc"][0], other_n], [shards["tx"][0],
                                               shards["tx"][1]]),
                 ([shards["pc"][0]], shards["tx"])):
        assert (raised(lambda: ShardedCorpus(*args))
                == raised(lambda: JaxCorpus(*args)))


def test_no_image_shards_zero_mask(shards):
    c = ShardedCorpus(shards["pc"][:1], shards["tx"][:1])
    b = c.gather(np.arange(3))
    assert b["mask"].tolist() == [0.0, 0.0, 0.0]
    np.testing.assert_array_equal(b["image_embed"], np.zeros((3, D)))


def test_global_batch_moves_arrays_and_refuses_a_mesh(shards):
    """The local batch as tensors: over a world of ranks, the rows this
    rank's loader read, its slice of the global batch.  It takes no mesh:
    the JAX package's `global_batch(local, mesh)` raises here."""
    port, _ = both(shards)
    local = next(StreamingLoader(port, 4, seed=0, prefetch=0))
    out = global_batch(local, torch.device("cpu"))
    assert isinstance(out["pc"], torch.Tensor) and out["step"] == 0
    np.testing.assert_array_equal(out["pc"].numpy(), local["pc"])
    with pytest.raises(TypeError, match="mesh"):
        global_batch(local, "cpu", mesh=object())


def test_native_reader_equals_numpy(tmp_path):
    """float32, float64 and int64 archives read sample by sample, with and
    without the prefetch ring, equal numpy's reads."""
    rng = np.random.default_rng(0)
    arrays = {"f32": rng.standard_normal((5, 7, 3)).astype(np.float32),
              "f64": rng.standard_normal((4, 6)),
              "i64": rng.integers(-9, 9, (6,)).astype(np.int64)}
    assert native.native_available()
    for name, arr in arrays.items():
        p = str(tmp_path / f"{name}.npy")
        np.save(p, arr)
        for prefetch in (0, 3):
            r = native.NativeNpy(p, prefetch=prefetch)
            assert r.native and r.shape == arr.shape and len(r) == len(arr)
            for i in range(len(arr)):
                if name == "i64":
                    assert r.read_i64(i) == arr[i]
                else:
                    np.testing.assert_array_equal(
                        r.read_f32(i), arr[i].astype(np.float32))
            r.close()


def test_importing_builds_nothing():
    """Importing the reader and the loader builds and loads no library."""
    code = ("import uni_adapter_torch.data.streaming, "
            "uni_adapter_torch.native.loader as n; "
            "assert n._lib is None and not n._build_failed; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ------------------------------------------- augmentation, synthetic stream


def test_augmentations_match_jax_on_the_jax_draw():
    """Each transform, handed the random tensor the JAX function draws
    from its key, gives the JAX function's output."""
    import jax
    import jax.numpy as jnp

    import uni_adapter_tpu.data.augment as jaug
    from uni_adapter_torch.data import augment

    xyz = np.random.default_rng(2).standard_normal((3, 50, 3)).astype(
        np.float32)
    x = torch.from_numpy(xyz)
    key = jax.random.PRNGKey(4)
    t = lambda a: torch.from_numpy(np.asarray(a))
    cases = {
        "jitter": (jaug.jitter_points(key, xyz), augment.jitter_points(
            x, noise=t(jax.random.normal(key, xyz.shape)))),
        "scale": (jaug.random_scale(key, xyz), augment.random_scale(
            x, scale=t(jax.random.uniform(key, (3, 1, 1), minval=0.8,
                                          maxval=1.25)))),
        "translate": (jaug.random_translate(key, xyz),
                      augment.random_translate(x, offset=t(
                          jax.random.uniform(key, (3, 1, 3), minval=-0.1,
                                             maxval=0.1)))),
        "rotate": (jaug.random_rotate_z(key, xyz), augment.random_rotate_z(
            x, theta=t(jax.random.uniform(key, (3,), maxval=2 * jnp.pi)))),
        "normalize": (jaug.normalize_cloud(xyz), augment.normalize_cloud(x)),
    }
    for name, (want, got) in cases.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    center = t(jax.random.normal(key, (3, 1, 3)))
    fixed = np.array([0.0, 0.0, 1.0], np.float32)
    for (jk, jc), (pk, pc) in (
            (jaug.separate_point_cloud(key, xyz, 20),
             augment.separate_point_cloud(x, 20, center=center)),
            (jaug.separate_point_cloud(key, xyz, 7, jnp.asarray(fixed)),
             augment.separate_point_cloud(x, 7,
                                          fixed_center=t(fixed)))):
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))


def test_worker_seed_and_draws_are_deterministic():
    from uni_adapter_torch.data import augment

    x = torch.zeros(2, 5, 3)
    a = augment.jitter_points(x, augment.worker_seed(3, 1))
    b = augment.jitter_points(x, augment.worker_seed(3, 1))
    c = augment.jitter_points(x, augment.worker_seed(3, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.abs().max() <= 0.05


def test_synthetic_streams_are_the_jax_packages():
    """The toy problems' arrays are the JAX package's bit for bit, and the
    toy encoder and zero-shot accuracy agree."""
    import jax.numpy as jnp

    import uni_adapter_tpu.data.synthetic_stream as jss
    from uni_adapter_torch.data import synthetic_stream as ss

    for got, want in ((ss.make_problem(1, steps=40),
                       jss.make_problem(1, steps=40)),
                      (ss.make_problem_sphere(2, K=12, D=64, T=30),
                       jss.make_problem_sphere(2, K=12, D=64, T=30))):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    pcs, y, text, W = ss.make_problem(1, steps=40)
    assert ss.zero_shot_acc(pcs, y, text, W) == jss.zero_shot_acc(
        pcs, y, text, W)
    pc = np.concatenate([pcs[:, 0], np.ones_like(pcs[:, 0])], axis=-1)
    np.testing.assert_allclose(
        ss.ToyEncoder(W)(torch.from_numpy(pc)).numpy(),
        np.asarray(jss.ToyEncoder(W).apply({}, jnp.asarray(pc))), rtol=1e-5,
        atol=1e-6)
    assert ss.nn_spacing(ss._fibonacci_sphere(40)) == jss.nn_spacing(
        jss._fibonacci_sphere(40))


def test_run_adapter_tracks_jax_on_the_toy_stream():
    """MODE-DOTA through the port's scan on a 24-step toy stream: its
    accuracy is the JAX package's and its final logits (≈ 60, the logit
    scale 100) within 2e-3 of JAX's: the method rounds its prediction
    input to fp16 (`fp16_predict_input`), where the two frameworks' last
    fp32 bits can round apart (measured: 3 of 192 logits ~1e-3 apart, the
    rest within 1e-4)."""
    import uni_adapter_tpu.data.synthetic_stream as jss
    from uni_adapter_torch.data import synthetic_stream as ss

    pcs, y, text, W = ss.make_problem(0, steps=24)
    acc, logits = ss.run_adapter("mode", text, pcs, y, W)
    jacc, jlogits = jss.run_adapter("mode", text, pcs, y, W)
    np.testing.assert_allclose(logits, jlogits, rtol=2e-3)
    assert acc == jacc


def test_open_native_reads_the_corruption_pair_as_jax(tmp_path):
    from uni_adapter_tpu.data.datasets import open_native as jax_open
    from uni_adapter_torch.data.datasets import open_native

    rng = np.random.default_rng(1)
    np.save(tmp_path / "data_uniform_5.npy",
            rng.standard_normal((4, 16, 3)).astype(np.float32))
    np.save(tmp_path / "label.npy", rng.integers(0, 40, 4))
    (d, lab), (jd, jlab) = (f(str(tmp_path), "uniform", 5)
                            for f in (open_native, jax_open))
    assert d.shape == jd.shape == (4, 16, 3) and len(lab) == 4
    for i in range(4):
        np.testing.assert_array_equal(d.read_f32(i), jd.read_f32(i))
        assert lab.read_i64(i) == jlab.read_i64(i)
    for r in (d, lab, jd, jlab):
        r.close()
