"""HTTP front end for the online-TTA server (mirror of
`uni_adapter_tpu/serve_http.py`, the same protocol).

Wraps `serve.TTAServer` (per-client adaptation state, greedy ticks on the
stream axis) in a threaded HTTP server with a micro-batching queue:
requests that arrive while a tick is running coalesce into the next
tick, so concurrent clients share one stream-axis step exactly as in the
library API — each client's trajectory stays what a dedicated stream
would produce (tests/test_torch_serve_http.py holds it through the
wire).  All device work runs on the batcher's one ticker thread;
register, reset, snapshot and restore run under the state lock.

Protocol (binary npy/npz over HTTP — no serialization framework needed):

  POST /register?client=ID                  -> 200 {"ok": true}, 409 dup
  POST /reset?client=ID                     -> 200, 404 unknown
  POST /submit?client=ID   body: .npz with `pc` (B,N,3) [+ `rgb`]
                                            -> 200 .npy final logits (B,K)
  POST /snapshot?client=ID&name=NAME[&blocking=0]  -> 200
  POST /restore?client=ID&name=NAME         -> 200
  GET  /healthz                             -> 200 {"clients":…,"ticks":…}

Snapshots live under the server-owned `snapshot_dir` keyed by NAME
(`[A-Za-z0-9._-]`, no path separators) — clients never supply filesystem
paths.  One request per client per tick is enforced by deferral, not
rejection; a tick only coalesces requests of identical array shape (the
stream-axis step stacks them), others wait for the next tick.
"""
from __future__ import annotations

import io
import json
import logging
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from uni_adapter_torch.serve import TTAServer

_NAME_RE = re.compile(r"^[A-Za-z0-9._-]{1,128}$")


class _BadRequest(ValueError):
    """Malformed request (missing/invalid parameter or payload) -> 400."""


class _Pending:
    __slots__ = ("client", "pc", "rgb", "event", "result", "error")

    def __init__(self, client: str, pc: np.ndarray, rgb: Optional[np.ndarray]):
        self.client = client
        self.pc = pc
        self.rgb = rgb
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None


class _Batcher:
    """Micro-batching queue in front of TTAServer.submit.

    A single ticker thread drains the queue; while a tick computes, newly
    arriving requests pile up for the next one (natural coalescing — no
    fixed gather window needed beyond `gather_ms` for the very first
    request of a tick).  Per tick: at most one request per client, all
    requests of one array shape (the stream-axis step stacks them); the rest
    stay queued.  Invalid requests (unregistered client) fail
    individually before the tick runs, never poisoning co-batched
    clients.
    """

    def __init__(self, server: TTAServer, gather_ms: float = 2.0,
                 max_batch: Optional[int] = None,
                 state_lock: Optional[threading.Lock] = None):
        self._server = server
        self._gather_s = gather_ms / 1e3
        self._max_batch = max_batch or max(server.sizes)
        # guards server.states against concurrent register/reset/snapshot
        # (a reset landing mid-tick must not be overwritten by the tick's
        # state write-back)
        self._state_lock = state_lock or threading.Lock()
        self._lock = threading.Lock()
        self._queue: List[_Pending] = []
        self._wakeup = threading.Event()
        self._stop = False
        self.ticks = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tta-http-batcher")
        self._thread.start()

    def submit(self, client: str, pc: np.ndarray,
               rgb: Optional[np.ndarray], timeout: float = 300.0
               ) -> np.ndarray:
        req = _Pending(client, pc, rgb)
        with self._lock:
            if self._stop:
                raise ConnectionError("server is shutting down")
            self._queue.append(req)
        self._wakeup.set()
        if not req.event.wait(timeout):
            # still queued -> withdraw (state untouched); already taken ->
            # the tick WILL apply it, so wait it out rather than letting
            # the client believe the step never happened
            with self._lock:
                if req in self._queue:
                    self._queue.remove(req)
                    raise TimeoutError(
                        f"request not scheduled within {timeout}s")
            if not req.event.wait(timeout):
                raise TimeoutError(f"tick did not complete within "
                                   f"{2 * timeout}s; the step may still "
                                   f"apply — reset or restore the client")
        if req.error is not None:
            raise req.error
        return req.result

    def shutdown(self) -> None:
        with self._lock:
            self._stop = True
        self._wakeup.set()
        self._thread.join(timeout=10)
        self._drain_queue(ConnectionError("server shut down"))

    def _drain_queue(self, error: Exception) -> None:
        with self._lock:
            abandoned, self._queue = self._queue, []
        for req in abandoned:
            req.error = error
            req.event.set()

    def _take_tick(self) -> List[_Pending]:
        """Pop up to max_batch same-shape requests, at most one per client,
        preserving arrival order for the rest.  Unregistered clients are
        failed individually here (never reaching the shared tick)."""
        with self._lock:
            tick: List[_Pending] = []
            seen = set()
            rest: List[_Pending] = []
            rejected: List[_Pending] = []
            shape = None
            for req in self._queue:
                if req.client not in self._server.states:
                    rejected.append(req)
                    continue
                if shape is None:
                    shape = req.pc.shape
                if (req.client in seen or len(tick) >= self._max_batch
                        or req.pc.shape != shape):
                    rest.append(req)
                    continue
                seen.add(req.client)
                tick.append(req)
            self._queue = rest
            if not self._queue:
                self._wakeup.clear()
        for req in rejected:
            req.error = KeyError(f"client {req.client!r} not registered")
            req.event.set()
        return tick

    def _loop(self) -> None:
        while not self._stop:
            if not self._wakeup.wait(timeout=0.5):
                continue
            # small gather window so a burst arriving together shares the
            # first tick too (subsequent bursts coalesce behind the running
            # tick without any window)
            if self._gather_s:
                time.sleep(self._gather_s)
            tick = self._take_tick()
            if not tick:
                continue
            try:
                with self._state_lock:
                    out = self._server.submit(
                        [(r.client, r.pc, r.rgb) for r in tick])
                for r in tick:
                    r.result = out[r.client]
            except Exception as e:  # surface per-request, keep serving
                for r in tick:
                    r.error = e
            finally:
                self.ticks += 1
                for r in tick:
                    r.event.set()
        self._drain_queue(ConnectionError("server shut down"))


def _param(q: Dict[str, str], name: str) -> str:
    try:
        return q[name]
    except KeyError:
        raise _BadRequest(f"missing required query parameter {name!r}") \
            from None


def _make_handler(owner: "HTTPTTAServer"):
    server, lock = owner.server, owner._lock

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through logging, not stderr
            logging.debug("serve_http: " + fmt, *args)

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _npy(self, arr: np.ndarray) -> None:
            buf = io.BytesIO()
            np.save(buf, arr)
            body = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _q(self) -> Tuple[str, Dict[str, str]]:
            u = urlparse(self.path)
            return u.path, {k: v[0] for k, v in parse_qs(u.query).items()}

        def _snapshot_path(self, q: Dict[str, str]) -> str:
            name = _param(q, "name")
            # the regex admits "." and "..", which name snapshot_dir
            # and its parent: rejected explicitly
            if not _NAME_RE.match(name) or name in (".", ".."):
                raise _BadRequest(
                    "snapshot name must match [A-Za-z0-9._-]{1,128} and "
                    "may not be '.' or '..'")
            os.makedirs(owner.snapshot_dir, exist_ok=True)
            return os.path.join(owner.snapshot_dir, name)

        def _read_body(self) -> bytes:
            n = int(self.headers.get("Content-Length", 0))
            if n > owner.max_body_bytes:
                raise _BadRequest(
                    f"request body {n} bytes exceeds the "
                    f"{owner.max_body_bytes}-byte limit")
            return self.rfile.read(n)

        def do_GET(self):
            path, _ = self._q()
            if path == "/healthz":
                with lock:
                    n = len(server.states)
                self._json(200, {"ok": True, "clients": n,
                                 "ticks": owner.batcher.ticks,
                                 "sizes": list(server.sizes)})
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            path, q = self._q()
            try:
                if path == "/register":
                    with lock:
                        server.register(_param(q, "client"))
                    self._json(200, {"ok": True})
                elif path == "/reset":
                    with lock:
                        server.reset(_param(q, "client"))
                    self._json(200, {"ok": True})
                elif path == "/submit":
                    client = _param(q, "client")
                    body = self._read_body()
                    try:
                        with np.load(io.BytesIO(body)) as z:
                            pc = z["pc"]
                            rgb = z["rgb"] if "rgb" in z.files else None
                    except Exception as e:
                        raise _BadRequest(
                            f"body must be an .npz with 'pc' [+ 'rgb']: "
                            f"{e}") from None
                    if pc.ndim != 3 or pc.shape[-1] != 3:
                        raise _BadRequest(
                            f"pc must be (B, N, 3); got shape {pc.shape}")
                    # full validation HERE, before the shared tick: a
                    # malformed rgb must 400 this request alone, never
                    # fail clients co-batched with it (the tick coalesces
                    # on pc.shape only)
                    if rgb is not None and rgb.shape != pc.shape:
                        raise _BadRequest(
                            f"rgb shape {rgb.shape} must equal pc shape "
                            f"{pc.shape}")
                    try:
                        pc = np.asarray(pc, np.float32)
                        rgb = (np.asarray(rgb, np.float32)
                               if rgb is not None else None)
                    except (TypeError, ValueError) as e:
                        raise _BadRequest(
                            f"pc/rgb must cast to float32: {e}") from None
                    self._npy(owner.batcher.submit(client, pc, rgb))
                elif path == "/snapshot":
                    blocking = q.get("blocking", "1") != "0"
                    target = self._snapshot_path(q)
                    with lock:
                        server.snapshot(_param(q, "client"), target,
                                        blocking=blocking)
                    self._json(200, {"ok": True})
                elif path == "/restore":
                    target = self._snapshot_path(q)
                    with lock:
                        server.restore(_param(q, "client"), target)
                    self._json(200, {"ok": True})
                else:
                    self._json(404, {"error": f"unknown path {path}"})
            except _BadRequest as e:
                self._json(400, {"error": str(e)})
            except KeyError as e:
                self._json(404, {"error": str(e)})
            except TimeoutError as e:
                self._json(503, {"error": str(e)})
            except ConnectionError as e:
                self._json(503, {"error": str(e)})
            except ValueError as e:
                msg = str(e)
                code = (409 if "already registered" in msg
                        else 404 if "not registered" in msg else 400)
                self._json(code, {"error": msg})
            except Exception as e:
                logging.exception("serve_http: %s failed", path)
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class HTTPTTAServer:
    """Owns the HTTP listener + batcher around a TTAServer.

    `start()` binds (port=0 picks a free port — read `.port` after) and
    serves on a daemon thread; `wait()` blocks until `close()`, which
    stops the listener, drains the batcher and any async snapshots.
    """

    def __init__(self, server: TTAServer, host: str = "127.0.0.1",
                 port: int = 0, gather_ms: float = 2.0,
                 max_batch: Optional[int] = None,
                 snapshot_dir: str = "snapshots",
                 max_body_bytes: int = 64 * 1024 * 1024):
        self.server = server
        self.snapshot_dir = snapshot_dir
        self.max_body_bytes = max_body_bytes
        self._lock = threading.Lock()   # guards register/reset/snapshot
        self.batcher: Optional[_Batcher] = None
        # bind BEFORE starting the batcher thread: a bind failure (port in
        # use) must not leak a forever-polling ticker
        self._httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self._httpd.daemon_threads = True
        self.batcher = _Batcher(server, gather_ms=gather_ms,
                                max_batch=max_batch, state_lock=self._lock)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_port

    def start(self) -> "HTTPTTAServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="tta-http-listener")
        self._thread.start()
        logging.info("HTTP TTA server listening on :%d (snapshots under "
                     "%s)", self.port, self.snapshot_dir)
        return self

    def wait(self) -> None:
        """Block the caller until the listener stops (close() or process
        signal) — the console script's serve-forever."""
        if self._thread is not None:
            self._thread.join()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.batcher.shutdown()
        self.server.drain_snapshots()

    def __enter__(self) -> "HTTPTTAServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
