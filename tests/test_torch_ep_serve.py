"""`TTAServer(dist_mode='ep')` and `cli/serve.py --dist-mode ep` over two
gloo ranks (rank 0 serves, rank 1 follows it, `serve.follow`), against
the JAX package's EP server on a 2-device CPU mesh and against each
client's own stream through `run_stream_ep`, at tests/test_serve.py's
small Uni3D (K 5, which pads to 6 over two ranks).

JAX's PRNG cannot be reproduced in torch, so MODE-DOTA's noise is off
(`noise_std=0`, residuals off); the logits are held to JAX's serve
tolerance (rtol / atol 1e-4), the port's server to its own sequential
runs and to a replicated server in this process within 1e-5.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist_worker import collect, start_world
from uni_adapter_tpu import config as jcfg
from uni_adapter_tpu.models.uni3d import Uni3D as JaxUni3D
from uni_adapter_tpu.parallel import ep as jep
from uni_adapter_tpu.serve import TTAServer as JaxServer
from uni_adapter_torch import checkpoint
from uni_adapter_torch import config as pcfg
from uni_adapter_torch.models.uni3d import create_uni3d
from uni_adapter_torch.serve import TTAServer
from uni_adapter_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

K, D, N, T = 5, 24, 48, 3
SMALL = dict(pc_feat_dim=32, embed_dim=D, num_group=8, group_size=8,
             pc_encoder_dim=16, eva_depth=1, eva_heads=4,
             compute_dtype="float32")
DOTA = dict(use_mode_dota=True, mode_M=2, res_learning=False, noise_std=0.0)
SERVE_ARGS = ["--gather-ms", "0", "--device", "cpu", "--npoints", str(N),
              "--eva-depth", "1", "--pc-feat-dim", "32", "--embed-dim",
              str(D), "--num-group", "8", "--group-size", "8",
              "--pc-encoder-dim", "16", "--eva-heads", "4",
              "--compute-dtype", "float32", "--dota-mode-M", "2",
              "--dota-res-learning", "false", "--dota-noise-std", "0",
              "--dist-mode", "ep"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep_serve")
    jmodel = JaxUni3D(trans_dim=32, embed_dim=D, num_group=8, group_size=8,
                      encoder_dim=16, depth=1, num_heads=4,
                      dtype=jnp.float32)
    rng = np.random.default_rng(0)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, N, 6), jnp.float32))
    text = rng.standard_normal((K, D)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    streams = rng.standard_normal((2, T, 1, N, 3)).astype(np.float32)
    np.save(tmp / "bank.npy", text)
    state_dict = from_jax_params(params)
    snaps = {c: str(tmp / f"snap_{c}") for c in ("a", "b", "c")}
    # a snapshot whose structure file reads but whose arrays do not (a
    # truncated archive)
    (tmp / "garbled.json").write_text(json.dumps(
        {"format": checkpoint.FORMAT, "structure": None}))
    (tmp / "garbled.npz").write_bytes(b"PK\x03\x04 truncated")
    inputs = {"model_cfg": pcfg.ModelConfig(**SMALL),
              "state_dict": state_dict, "text": text, "streams": streams,
              "cfg": pcfg.Config(model=pcfg.ModelConfig(**SMALL),
                                 dota=pcfg.DotaConfig(**DOTA)),
              "snapshot": str(tmp / "snap_tick2"), "final_snapshots": snaps,
              "missing": str(tmp / "no_such_snapshot"),
              "garbled": str(tmp / "garbled"),
              "fault_snapshot": str(tmp / "snap_after_faults"),
              "serve_argv": [*SERVE_ARGS, "--precomputed-text-features",
                             str(tmp / "bank.npy"), "--output-dir",
                             str(tmp / "serve")]}
    procs = start_world("ep_serve", inputs, tmp)

    # JAX's EP server through the same ticks: a and b twice, a snapshot
    # of a restored as c, then a, b and c
    jc = jcfg.Config(model=jcfg.ModelConfig(compute_dtype="float32"),
                     dota=jcfg.DotaConfig(**DOTA))
    js = JaxServer(jc, jmodel, params, text, seed=42, dist_mode="ep",
                   mesh=jep.make_classes_mesh(2))
    ticks = []
    for cid in ("a", "b"):
        js.register(cid)
    for t in range(2):
        ticks.append(js.submit([(cid, streams[i, t], None)
                                for i, cid in enumerate(("a", "b"))]))
    js.snapshot("a", str(tmp / "jax_snap"))
    js.restore("c", str(tmp / "jax_snap"))
    ticks.append(js.submit([("a", streams[0, 2], None),
                            ("b", streams[1, 2], None),
                            ("c", streams[0, 2], None)]))
    # the port's replicated server in this process: the HTTP run's
    # reference (client x seeded 42, stream 0)
    model = create_uni3d(pcfg.ModelConfig(**SMALL), "cpu",
                         state_dict=state_dict)
    ref = TTAServer(inputs["cfg"], model, torch.from_numpy(text), seed=42)
    ref.register("x")
    ref_logits = [ref.submit([("x", streams[0, t], None)])["x"]
                  for t in range(2)]
    got = collect(procs, tmp, timeout=300.0)
    return ticks, ref_logits, got, {**snaps,
                                    "faults": inputs["fault_snapshot"]}


def _ok(result):
    assert "error" not in result, result.get("error")
    return result


def test_ep_server_matches_jax_ep_server(runs):
    """Two clients two ticks, a snapshot of a restored as a new client c,
    then a tick of all three: every client's logits within rtol / atol
    1e-4 of JAX's EP server (2-device mesh); the ladder is [1]."""
    jticks, _, got, _ = runs
    res = _ok(got[0]["server"])
    assert res["sizes"] == [1]
    assert _ok(got[1]["server"]) == {"followed": True}
    assert len(res["ticks"]) == len(jticks)
    for tick, jtick in zip(res["ticks"], jticks):
        assert set(tick) == set(jtick)
        for cid in jtick:
            np.testing.assert_allclose(tick[cid], np.asarray(jtick[cid]),
                                       rtol=1e-4, atol=1e-4, err_msg=cid)
    assert res["refused"] is not None and "nobody" in res["refused"]


def test_ep_server_clients_are_their_streams(runs):
    """Each client's full-K carry after three ticks (a snapshot, gathered
    from both ranks) is its stream's through `run_stream_ep` (seed
    42 + i) within 1e-6, and the client restored from a's tick-2 snapshot
    took a's third step: its carry is a's, bitwise."""
    _, _, got, snaps = runs
    streams = _ok(got[0]["by_stream"])
    final = {c: checkpoint.restore_state(snaps[c]) for c in ("a", "b", "c")}
    for i, cid in enumerate(("a", "b")):
        for name in final[cid].method_state._fields:
            np.testing.assert_allclose(
                getattr(final[cid].method_state, name).numpy(),
                streams[i][name], rtol=1e-6, atol=1e-7,
                err_msg=f"{cid}.{name}")
        assert final[cid].step == streams[i]["step"] == T
        assert final[cid].method_state.mu.shape[0] == K
    for a, c in zip(final["a"].method_state, final["c"].method_state):
        assert torch.equal(a, c)


def test_ep_server_outlives_a_failed_restore(runs):
    """A restore of a missing snapshot (for a known client and for a new
    one) and of an unreadable one raises on rank 0 and on rank 1 alike:
    rank 1 logs it and keeps following, so the next step answers (a's
    first tick's logits, as the first server's) and the next snapshot,
    gathered from both ranks, holds a's full-K carry after one step; the
    new client is not left registered, and rank 1 returns at the stop."""
    jticks, _, got, snaps = runs
    res = _ok(got[0]["faults"])
    assert _ok(got[1]["faults"]) == {"followed": True}
    assert res["errors"] == ["FileNotFoundError", "FileNotFoundError",
                             "BadZipFile"]
    assert res["clients"] == ["a"]
    np.testing.assert_allclose(res["logits"],
                               _ok(got[0]["server"])["ticks"][0]["a"],
                               rtol=1e-6, atol=1e-7)
    state = checkpoint.restore_state(snaps["faults"])
    assert state.step == 1
    assert state.method_state.mu.shape[0] == K


def test_serve_cli_dist_mode_ep_over_http(runs):
    """`cli.serve --dist-mode ep` at world 2: rank 0 answers one client
    over HTTP, its logits within 1e-5 of a replicated server's in this
    process (the same weights, bank and seed); rank 1 follows until rank
    0 stops it, and both ranks return."""
    _, ref_logits, got, _ = runs
    res = _ok(got[0]["http"])
    assert _ok(got[1]["http"]) == {"followed": True}
    for a, b in zip(res["logits"], ref_logits):
        assert a.shape == (1, K)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    assert res["health"]["clients"] == 1 and res["health"]["sizes"] == [1]
