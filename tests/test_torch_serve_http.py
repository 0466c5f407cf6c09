"""The port's HTTP front end (`serve_http.HTTPTTAServer`, `client.TTAClient`,
`cli/serve.py`) on the CPU: the same scripted requests against the JAX
package's endpoint and the port's get the same status codes, content
types, JSON keys and error texts; threaded clients get what the
library-level server gives; ticks coalesce by shape, fail an unknown
client alone and withdraw a request that times out in the queue.

Servers bind 127.0.0.1 on a free port, and every wait has a timeout.
"""
import http.client
import io
import json
import threading

import numpy as np
import pytest

from test_torch_serve import K, T, configs, setup  # noqa: F401
from uni_adapter_tpu.serve import TTAServer as JaxServer
from uni_adapter_tpu.serve_http import HTTPTTAServer as JaxHTTPServer
from uni_adapter_torch.client import ServerError, TTAClient
from uni_adapter_torch.serve import TTAServer
from uni_adapter_torch.serve_http import HTTPTTAServer
from torch_threads import one_torch_thread  # noqa: F401

WAIT = 120


def request(port, method, path, body=b"", length=None):
    """(status, content type, body); `length` sends that Content-Length
    and no body."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
    try:
        if length is None:
            conn.request(method, path, body=body)
        else:
            conn.putrequest(method, path)
            conn.putheader("Content-Length", length)
            conn.endheaders()
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def submit(port, client, pc):
    status, _, body = request(port, "POST", f"/submit?client={client}",
                              npz(pc=pc))
    assert status == 200, body
    return np.load(io.BytesIO(body))


def script(streams):
    """The scripted requests: (method, path, body[, Content-Length])."""
    pc = streams[0, 0]
    return [
        ("POST", "/register?client=a", b""),
        ("POST", "/register?client=a", b""),              # 409
        ("POST", "/submit?client=ghost", npz(pc=pc)),     # 404
        ("POST", "/reset?client=ghost", b""),             # 404
        ("POST", "/frobnicate", b""),                     # 404
        ("GET", "/nope", b""),                            # 404
        ("POST", "/register", b""),                       # 400
        ("POST", "/snapshot?client=a", b""),              # 400
        *(("POST", f"/snapshot?client=a&name={name}", b"")
          for name in ("../esc", "a/b", ".", "..")),      # 400
        ("POST", "/submit?client=a", b"not an npz"),      # 400
        ("POST", "/submit?client=a", npz(pc=np.zeros((3, 4), np.float32))),
        ("POST", "/submit?client=a", npz(pc=np.zeros((1, 4, 2), np.float32))),
        ("POST", "/submit?client=a",
         npz(pc=pc, rgb=np.ones((1, 3, 3), np.float32))),
        ("POST", "/submit?client=a", b"", str(2 << 20)),  # over the limit
        ("POST", "/submit?client=a", npz(pc=pc)),         # 200, .npy
        ("POST", "/snapshot?client=a&name=s1", b""),
        ("POST", "/snapshot?client=a&name=s2&blocking=0", b""),
        ("POST", "/restore?client=a&name=s1", b""),
        ("POST", "/reset?client=a", b""),
        ("GET", "/healthz", b""),
    ]


def test_protocol_matches_jax(setup, tmp_path):
    """Every scripted request: equal status codes, content types, JSON
    keys and error texts; the one step's logits within 1e-4 and /healthz
    equal."""
    jmodel, params, pmodel, text, text_np, streams = setup
    jc, pc = configs()
    replies = {}
    for name, server, http_cls in (
            ("jax", JaxServer(jc, jmodel, params, text_np, sizes=(1, 2),
                              seed=7), JaxHTTPServer),
            ("port", TTAServer(pc, pmodel, text, sizes=(1, 2), seed=7),
             HTTPTTAServer)):
        with http_cls(server, snapshot_dir=str(tmp_path / name),
                      max_body_bytes=1 << 20) as http_srv:
            replies[name] = [request(http_srv.port, *r[:3], *r[3:])
                             for r in script(streams)]
    codes = []
    for (method, path, *_), j, p in zip(script(streams), replies["jax"],
                                        replies["port"], strict=True):
        assert (p[0], p[1]) == (j[0], j[1]), (method, path)
        codes.append(p[0])
        if p[1] == "application/json":
            jb, pb = json.loads(j[2]), json.loads(p[2])
            assert pb == jb, (method, path)
        else:
            np.testing.assert_allclose(np.load(io.BytesIO(p[2])),
                                       np.load(io.BytesIO(j[2])),
                                       rtol=1e-4, atol=1e-4)
    assert codes == [200, 409, 404, 404, 404, 404, 400, 400, 400, 400, 400,
                     400, 400, 400, 400, 400, 400, 200, 200, 200, 200, 200,
                     200]
    assert set(json.loads(replies["port"][-1][2])) == {
        "ok", "clients", "ticks", "sizes"}


def test_threaded_clients_equal_the_library_server(setup):
    """Three clients posting from threads, noise on: each one's logits
    within atol 1e-4 of the library-level server's (ticks of all three:
    the wire's ticks coalesce as the threads arrive)."""
    _, _, pmodel, text, _, streams = setup
    _, cfg = configs(noise_std=0.05)
    library = TTAServer(cfg, pmodel, text, sizes=(1, 2, 4), seed=42)
    for cid in "abc":
        library.register(cid)
    want = [library.submit([(c, streams[i, t], None)
                            for i, c in enumerate("abc")]) for t in range(T)]
    server = TTAServer(cfg, pmodel, text, sizes=(1, 2, 4), seed=42)
    got = {c: [None] * T for c in "abc"}
    with HTTPTTAServer(server, gather_ms=20.0) as http_srv:
        for cid in "abc":
            assert request(http_srv.port, "POST",
                           f"/register?client={cid}")[0] == 200

        def run(i, cid):
            for t in range(T):
                got[cid][t] = submit(http_srv.port, cid, streams[i, t])

        threads = [threading.Thread(target=run, args=(i, c))
                   for i, c in enumerate("abc")]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT)
        assert not any(th.is_alive() for th in threads)
        health = json.loads(request(http_srv.port, "GET", "/healthz")[2])
    assert health["clients"] == 3 and health["ticks"] >= T
    for c in "abc":
        np.testing.assert_allclose(np.stack(got[c]),
                                   np.stack([w[c] for w in want]),
                                   atol=1e-4, err_msg=c)
        assert server.states[c].step == T


def test_mixed_shapes_deferred_and_a_bad_client_fails_alone(setup):
    """A tick stacks same-shape requests only (a 2N-point cloud waits for
    its own tick), and an unregistered client queued beside valid ones
    fails alone with 404."""
    _, _, pmodel, text, _, streams = setup
    _, cfg = configs()
    server = TTAServer(cfg, pmodel, text, sizes=(1, 2, 4), seed=11)
    results = {}
    with HTTPTTAServer(server, gather_ms=30.0) as http_srv:
        for cid in "ab":
            assert request(http_srv.port, "POST",
                           f"/register?client={cid}")[0] == 200

        def post(cid, pc):
            results[cid] = request(http_srv.port, "POST",
                                   f"/submit?client={cid}", npz(pc=pc))

        wide = np.concatenate([streams[1, 0]] * 2, axis=1)    # (1, 2N, 3)
        threads = [threading.Thread(target=post, args=a) for a in (
            ("a", streams[0, 0]), ("b", wide), ("ghost", streams[2, 0]))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT)
        assert not any(th.is_alive() for th in threads)
    assert [results[c][0] for c in ("a", "b", "ghost")] == [200, 200, 404]
    for c in "ab":
        out = np.load(io.BytesIO(results[c][2]))
        assert out.shape == (1, K) and np.isfinite(out).all()


def test_a_request_that_times_out_in_the_queue_is_withdrawn(setup):
    """With the ticker held (the state lock taken), a second request of a
    client whose first is in the running tick times out in the queue: it
    raises and is withdrawn, so the client steps once."""
    _, _, pmodel, text, _, streams = setup
    _, cfg = configs()
    server = TTAServer(cfg, pmodel, text, sizes=(1,), seed=3)
    server.register("a")
    with HTTPTTAServer(server, gather_ms=0.0) as http_srv:
        batcher, first = http_srv.batcher, {}
        with http_srv._lock:
            th = threading.Thread(target=lambda: first.setdefault(
                "out", batcher.submit("a", streams[0, 0], None)))
            th.start()
            for _ in range(200):     # until the ticker has taken it
                with batcher._lock:
                    if not batcher._queue:
                        break
                threading.Event().wait(0.01)
            with pytest.raises(TimeoutError, match="not scheduled"):
                batcher.submit("a", streams[0, 1], None, timeout=0.2)
            with batcher._lock:
                assert not batcher._queue
        th.join(timeout=WAIT)
        assert not th.is_alive()
    assert first["out"].shape == (1, K)
    assert server.states["a"].step == 1


def test_client_round_trip(setup, tmp_path):
    """TTAClient: errors as ServerError with the status, register,
    submit, snapshot and restore by name (the replayed step bitwise
    equal), reset, healthz, and ids and names with reserved characters."""
    _, _, pmodel, text, _, streams = setup
    _, cfg = configs(noise_std=0.05)
    server = TTAServer(cfg, pmodel, text, sizes=(1, 2), seed=3)
    with HTTPTTAServer(server, snapshot_dir=str(tmp_path)) as http_srv:
        c = TTAClient("127.0.0.1", http_srv.port, "cli-a", timeout=WAIT)
        with pytest.raises(ServerError) as e:
            c.submit(streams[0, 0])
        assert e.value.status == 404
        c.register()
        with pytest.raises(ServerError) as e:
            c.register()
        assert e.value.status == 409
        assert c.submit(streams[0, 0]).shape == (1, K)
        c.snapshot("s1.v-2_x")
        out = c.submit(streams[0, 1])
        c.restore("s1.v-2_x")
        np.testing.assert_array_equal(c.submit(streams[0, 1]), out)
        c.snapshot("async", blocking=False)
        c.restore("async")
        assert server.states["cli-a"].step == 2
        c.reset()
        assert server.states["cli-a"].step == 0
        assert c.healthz()["clients"] == 1
        c2 = TTAClient("127.0.0.1", http_srv.port, "robot 7&x=1",
                       timeout=WAIT)
        c2.register()
        assert "robot 7&x=1" in server.states
        assert c2.submit(streams[1, 0]).shape == (1, K)


def test_serve_cli_starts_and_serves(tmp_path):
    """`cli.serve.main` on the CPU builds the model and the bundled
    anchors, warms up and serves one client over the wire; with
    `--trunk-parallel sp` (one process: one shard of the tokens) it
    answers the same request with the same logits, within 1e-4."""
    from uni_adapter_torch.cli import serve as serve_cli

    argv = ["--port", "0", "--gather-ms", "0", "--sizes", "1,2", "--warmup",
            "--device", "cpu", "--npoints", "64", "--eva-depth", "1",
            "--pc-feat-dim", "64", "--num-group", "8", "--group-size", "8",
            "--pc-encoder-dim", "32", "--eva-heads", "4",
            "--compute-dtype", "float32", "--precomputed-text-features",
            "large", "--output-dir", str(tmp_path)]
    http_srv = serve_cli.main(argv)
    cloud = np.random.default_rng(0).standard_normal((1, 64, 3)).astype(
        np.float32)
    try:
        port = http_srv.port
        assert request(port, "POST", "/register?client=x")[0] == 200
        out = submit(port, "x", cloud)
        assert out.shape == (1, 40) and np.isfinite(out).all()
        health = json.loads(request(port, "GET", "/healthz")[2])
        assert health["clients"] == 1 and health["sizes"] == [1, 2]
    finally:
        http_srv.close()
    assert (tmp_path / "serve.log").exists()
    http_srv = serve_cli.main([*argv, "--trunk-parallel", "sp"])
    try:
        assert request(http_srv.port, "POST", "/register?client=x")[0] == 200
        sp_out = submit(http_srv.port, "x", cloud)
        np.testing.assert_allclose(sp_out, out, rtol=1e-4, atol=1e-4)
    finally:
        http_srv.close()
