"""The port's serving layer (`uni_adapter_torch.serve.TTAServer`) against
the JAX package's `TTAServer` and against each client's own
`engine.run_stream`, on the CPU, at tests/test_serve.py's small Uni3D
(the same weights in both packages).

JAX's PRNG cannot be reproduced in torch, so the comparisons with the JAX
server run with MODE-DOTA's noise off (`noise_std=0`); the comparisons
with the port's own sequential runs draw the noise from the generators.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uni_adapter_tpu import config as jcfg
from uni_adapter_tpu.models.uni3d import Uni3D as JaxUni3D
from uni_adapter_tpu.serve import TTAServer as JaxServer
from uni_adapter_torch import config as pcfg
from uni_adapter_torch import engine
from uni_adapter_torch.models.uni3d import create_uni3d
from uni_adapter_torch.serve import TTAServer
from uni_adapter_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

K, D, N, T = 4, 24, 48, 5
SMALL = dict(pc_feat_dim=32, embed_dim=D, num_group=8, group_size=8,
             pc_encoder_dim=16, eva_depth=1, eva_heads=4,
             compute_dtype="float32")
CG = 5


@pytest.fixture(scope="module")
def setup():
    """tests/test_serve.py's model, anchors and three streams, and the
    port's model on the same weights."""
    jmodel = JaxUni3D(trans_dim=32, embed_dim=D, num_group=8, group_size=8,
                      encoder_dim=16, depth=1, num_heads=4,
                      dtype=jnp.float32)
    rng = np.random.default_rng(0)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, N, 6), jnp.float32))
    text = rng.standard_normal((K, D)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    streams = rng.standard_normal((3, T, 1, N, 3)).astype(np.float32)
    pmodel = create_uni3d(pcfg.ModelConfig(**SMALL), "cpu",
                          state_dict=from_jax_params(params))
    return jmodel, params, pmodel, torch.from_numpy(text), text, streams


def configs(res_learning=False, noise_std=0.0, cache=False):
    dota = dict(use_mode_dota=not cache, mode_M=2, res_learning=res_learning,
                noise_std=noise_std)
    return (jcfg.Config(model=jcfg.ModelConfig(compute_dtype="float32"),
                        dota=jcfg.DotaConfig(**dota),
                        cache=jcfg.CacheConfig(cg_max_iter=CG)),
            pcfg.Config(model=pcfg.ModelConfig(**SMALL),
                        dota=pcfg.DotaConfig(**dota),
                        cache=pcfg.CacheConfig(cg_max_iter=CG)))


def servers(setup, sizes, jsizes=None, seed=42, **kw):
    jmodel, params, pmodel, text, text_np, _ = setup
    jc, pc = configs(**kw)
    return (JaxServer(jc, jmodel, params, text_np, sizes=jsizes or sizes,
                      seed=seed),
            TTAServer(pc, pmodel, text, sizes=sizes, seed=seed))


def both_submit(jserver, server, reqs):
    """One tick on both servers: each client's logits within JAX's serve
    tolerance (rtol / atol 1e-4) and equal step counts."""
    want, got = jserver.submit(reqs), server.submit(reqs)
    assert set(got) == set(want)
    for cid in want:
        np.testing.assert_allclose(got[cid], np.asarray(want[cid]),
                                   rtol=1e-4, atol=1e-4, err_msg=cid)
        assert server.states[cid].step == int(jserver.states[cid].step)
    return got


@pytest.fixture(scope="module")
def mode_dota_pair(setup):
    """One JAX server on the ladder (1, 2, 4, 8) for the MODE-DOTA
    scenarios (each its own clients; with noise off the seeds draw
    nothing), compiled once."""
    return servers(setup, (1, 2, 4, 8))[0]


def test_interleaved_clients_match_jax(setup, mode_dota_pair):
    """Three clients in every tick on the ladder (1, 2, 4): 3 = 2 + 1."""
    streams = setup[-1]
    server = servers(setup, (1, 2, 4))[1]
    for cid in "abc":
        mode_dota_pair.register(cid)
        server.register(cid)
    for t in range(T):
        both_submit(mode_dota_pair, server,
                    [(c, streams[i, t], None) for i, c in enumerate("abc")])
    assert server.states["a"].step == T


def test_ragged_ticks_match_jax(setup, mode_dota_pair):
    """Client d every tick, e every other: chunks of one client at step t
    and one at about t / 2."""
    streams = setup[-1]
    server = servers(setup, (1, 2, 4))[1]
    for cid in "de":
        mode_dota_pair.register(cid)
        server.register(cid)
    for t in range(T):
        reqs = [("d", streams[0, t], None)]
        if t % 2 == 0:
            reqs.append(("e", streams[1, t], None))
        both_submit(mode_dota_pair, server, reqs)
    assert (server.states["d"].step, server.states["e"].step) == (
        T, (T + 1) // 2)


def test_nine_client_tick_splits_eight_plus_one(setup, mode_dota_pair):
    """A 9-client tick on (1, 2, 4, 8): chunks 8 and 1, no padding, as the
    JAX server cuts it (both spied)."""
    rng = np.random.default_rng(7)
    server = servers(setup, (1, 2, 4, 8))[1]
    ids = [f"n{i}" for i in range(9)]
    chunks = {"jax": [], "port": []}
    for name, srv in (("jax", mode_dota_pair), ("port", server)):
        for cid in ids:
            srv.register(cid)
        orig = srv._run_chunk

        def spy(requests, size, orig=orig, seen=chunks[name]):
            seen.append((len(requests), size))
            return orig(requests, size)

        srv._run_chunk = spy
    try:
        pcs = rng.standard_normal((9, 1, N, 3)).astype(np.float32)
        both_submit(mode_dota_pair, server,
                    [(cid, pcs[i], None) for i, cid in enumerate(ids)])
    finally:
        del mode_dota_pair._run_chunk
    assert chunks["port"] == chunks["jax"] == [(8, 8), (1, 1)]


def test_padded_chunk_matches_jax(setup):
    """On the ladder (2, 4) three clients are a chunk of 2 and a padded
    chunk of 2: the padding copy's state is dropped and its client steps
    once."""
    streams = setup[-1]
    jserver, server = servers(setup, (2, 4))
    for srv in (jserver, server):
        for cid in "abc":
            srv.register(cid)
    for t in range(3):
        both_submit(jserver, server,
                    [(c, streams[i, t], None) for i, c in enumerate("abc")])
    assert [server.states[c].step for c in "abc"] == [3, 3, 3]


def assert_residuals_close(jserver, server, cid):
    """A client's residuals in the envelope of the port's residual tests
    (median < 1e-6, 90th percentile < 2e-4: Adam's first steps move an
    element whose gradient is near zero by ±lr on a last-bit difference),
    its Adam count and step count equal to JAX's."""
    got = server.states[cid].res_state
    want = jserver.states[cid].res_state
    d = np.abs(got.residuals.numpy() - np.asarray(want.residuals))
    assert np.median(d) < 1e-6 and np.quantile(d, 0.9) < 2e-4, (
        cid, np.median(d), np.quantile(d, 0.9))
    assert int(got.count) == int(want.opt_state[0].count)
    assert server.states[cid].step == int(jserver.states[cid].step)


def test_residual_gates_mixed_in_one_chunk(setup):
    """Residual learning on: client a steps alone, then a (step 1: the
    Adam loop) and b (step 0: none) share a chunk.  Both ticks' logits
    within rtol 1e-4 of JAX's (they read the residuals from before the
    loop); after the mixed tick a's residuals in the envelope and b's
    residual state its initial one bitwise; after one more tick (b's
    first Adam loop, a's second) both in the envelope."""
    streams = setup[-1]
    jserver, server = servers(setup, (1, 2), res_learning=True)
    for srv in (jserver, server):
        srv.register("a")
    both_submit(jserver, server, [("a", streams[0, 0], None)])
    for srv in (jserver, server):
        srv.register("b")
    b0 = server.states["b"].res_state
    both_submit(jserver, server, [("a", streams[0, 1], None),
                                  ("b", streams[1, 0], None)])
    assert all(torch.equal(x, y) for x, y in
               zip(server.states["b"].res_state, b0))
    assert_residuals_close(jserver, server, "a")
    reqs = [("a", streams[0, 2], None), ("b", streams[1, 1], None)]
    jserver.submit(reqs)
    server.submit(reqs)
    for cid in "ab":
        assert_residuals_close(jserver, server, cid)


def test_cache_clients_match_jax(setup):
    """The prototype cache, two clients in every tick (a chunk of 2: the
    stacked cache step with per-stream CG stopping)."""
    streams = setup[-1]
    jserver, server = servers(setup, (1, 2), cache=True)
    for srv in (jserver, server):
        for cid in "ab":
            srv.register(cid)
    for t in range(T):
        both_submit(jserver, server,
                    [(c, streams[i, t], None) for i, c in enumerate("ab")])


def sequential_logits(setup, cfg, stream, seed):
    _, _, pmodel, text, _, _ = setup
    outs = []
    step = engine.make_step_fn(cfg, pmodel)

    def collect(text, state, batch):
        state, out = step(text, state, batch)
        outs.append(out.final_logits.numpy())
        return state, out

    engine.run_stream(cfg, pmodel, text,
                      [(pc, np.ones_like(pc), np.zeros(1, np.int64))
                       for pc in stream], seed=seed, step_fn=collect)
    return np.stack(outs)


def test_noisy_server_equals_each_clients_own_stream(setup):
    """Noise on (each client's generator, seeded 42 + i): three ragged
    clients on the ladder (1, 2, 4) against each one's own
    `engine.run_stream` of what it submitted, final logits within atol
    1e-4 (the stacked step against the single one's fp32 rounding)."""
    streams = setup[-1]
    _, cfg = configs(noise_std=0.05)
    server = TTAServer(cfg, setup[2], setup[3], sizes=(1, 2, 4), seed=42)
    got = {c: [] for c in "abc"}
    for cid in "abc":
        server.register(cid)
    for t in range(T):
        clients = [c for i, c in enumerate("abc") if t % (i + 1) == 0]
        out = server.submit([(c, streams["abc".index(c), t], None)
                             for c in clients])
        for c in clients:
            got[c].append(out[c])
    for i, c in enumerate("abc"):
        seen = [streams[i, t] for t in range(T) if t % (i + 1) == 0]
        want = sequential_logits(setup, cfg, seen, 42 + i)
        np.testing.assert_allclose(np.stack(got[c]), want, atol=1e-4,
                                   err_msg=c)
        assert server.states[c].step == len(seen)


def gen_states(server):
    return {c: s.generator.get_state() for c, s in server.states.items()}


def test_failed_tick_leaves_every_client_as_it_was(setup):
    """The last chunk of a tick fails (a 2-channel cloud): no client
    steps, and every client's tensors and generator are as before, also
    those of the chunk that ran (JAX's test_submit_atomic_on_chunk_failure
    with the noise on); the retried client then follows its own stream."""
    streams = setup[-1]
    _, cfg = configs(noise_std=0.05)
    server = TTAServer(cfg, setup[2], setup[3], sizes=(1, 2), seed=11)
    for cid in "abc":
        server.register(cid)
    server.submit([("c", streams[2, 0], None)])
    before = {c: engine.clone_state(s) for c, s in server.states.items()}
    gens = gen_states(server)
    bad = np.zeros((1, N, 2), np.float32)
    with pytest.raises(Exception):
        server.submit([("a", streams[0, 0], None), ("b", streams[1, 0], None),
                       ("c", bad, None)])      # chunks: [a, b] then [c]
    for cid, state in server.states.items():
        assert state.step == before[cid].step, cid
        assert torch.equal(state.generator.get_state(), gens[cid]), cid
        assert all(torch.equal(x, y) for x, y in
                   zip(state.method_state, before[cid].method_state)), cid
    got = [server.submit([("a", streams[0, t], None)])["a"]
           for t in range(T)]
    np.testing.assert_allclose(np.stack(got),
                               sequential_logits(setup, cfg, streams[0], 11),
                               atol=1e-4)


def test_warmup_touches_no_client(setup):
    """warmup() runs every ladder size on a scratch state: no client is
    created, and a client registered after follows its own stream."""
    streams = setup[-1]
    _, cfg = configs(noise_std=0.05)
    server = TTAServer(cfg, setup[2], setup[3], sizes=(1, 2), seed=42)
    server.warmup(npoints=N, batch=1)
    assert not server.states
    server.register("a")
    got = [server.submit([("a", streams[0, t], None)])["a"]
           for t in range(2)]
    np.testing.assert_allclose(
        np.stack(got), sequential_logits(setup, cfg, streams[0, :2], 42),
        atol=1e-4)


def test_guards_and_jax_messages(setup):
    """Duplicate register, unknown and repeated clients, and reset of an
    unknown client raise as the JAX server does, with its message."""
    streams = setup[-1]
    jserver, server = servers(setup, (1,), seed=7)
    errors = []
    for srv in (jserver, server):
        srv.register("a")
        with pytest.raises(ValueError, match="already registered"):
            srv.register("a")
        with pytest.raises(KeyError):
            srv.submit([("ghost", streams[0, 0], None)])
        with pytest.raises(ValueError, match="one request per client"):
            srv.submit([("a", streams[0, 0], None),
                        ("a", streams[0, 1], None)])
        with pytest.raises(ValueError, match="not registered") as e:
            srv.reset("nobody")
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_dist_modes(setup):
    """'ep' serves (here a world of this process alone: the ladder is [1]
    and a client's logits are the replicated server's); any other
    unknown mode raises JAX's ValueError.  (EP over two ranks:
    tests/test_torch_ep_serve.py.)"""
    _, cfg = configs()
    streams = setup[-1]
    srv = TTAServer(cfg, setup[2], setup[3], dist_mode="ep")
    ref = TTAServer(cfg, setup[2], setup[3], sizes=[1])
    assert srv.sizes == [1] and srv.primary
    for s in (srv, ref):
        s.register("a")
    for t in range(2):
        got = srv.submit([("a", streams[0, t], None)])["a"]
        want = ref.submit([("a", streams[0, t], None)])["a"]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="sweep CLI"):
        TTAServer(cfg, setup[2], setup[3], dist_mode="psum")


@pytest.mark.parametrize("blocking", [True, False])
def test_snapshot_round_trip_is_exact(setup, tmp_path, blocking):
    """A snapshot after two ticks (blocking, or on the background thread
    while the server ticks on), restored into the same server and into a
    fresh one (the client unregistered there): the next tick's logits
    bitwise equal to the uninterrupted server's, noise on."""
    streams = setup[-1]
    _, cfg = configs(res_learning=True, noise_std=0.05)
    server = TTAServer(cfg, setup[2], setup[3], sizes=(1, 2), seed=7)
    server.register("a")
    for t in range(2):
        server.submit([("a", streams[0, t], None)])
    path = str(tmp_path / "snap_a")
    server.snapshot("a", path, blocking=blocking)
    live = server.submit([("a", streams[0, 2], None)])["a"]
    server.drain_snapshots()
    server.restore("a", path)
    np.testing.assert_array_equal(
        server.submit([("a", streams[0, 2], None)])["a"], live)
    fresh = TTAServer(cfg, setup[2], setup[3], sizes=(1, 2), seed=7)
    fresh.restore("a", path)
    assert fresh.states["a"].step == 2
    np.testing.assert_array_equal(
        fresh.submit([("a", streams[0, 2], None)])["a"], live)


def test_restore_failure_unwinds_the_registration(setup, tmp_path):
    _, cfg = configs()
    server = TTAServer(cfg, setup[2], setup[3], sizes=(1,))
    with pytest.raises(FileNotFoundError):
        server.restore("a", os.path.join(tmp_path, "missing"))
    assert "a" not in server.states
