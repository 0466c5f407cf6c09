"""Python client for the HTTP online-TTA endpoint (serve_http.py; mirror
of `uni_adapter_tpu/client.py`).

Stdlib and numpy only (http.client): register a stream, submit point
clouds, get final logits back as arrays — the wire protocol is npz in /
npy out, so nothing here depends on a serialization framework.

    from uni_adapter_torch.client import TTAClient
    c = TTAClient("127.0.0.1", 8080, client_id="robot-7")
    c.register()
    logits = c.submit(pc)            # (B, N, 3) float32 -> (B, K)
    c.snapshot("end-of-shift")       # server-side, by name
"""
from __future__ import annotations

import http.client
import io
import json
from typing import Optional
from urllib.parse import quote

import numpy as np


class ServerError(RuntimeError):
    """Non-2xx response from the serving endpoint."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class TTAClient:
    def __init__(self, host: str, port: int, client_id: str,
                 timeout: float = 300.0):
        self.host = host
        self.port = port
        self.client_id = client_id
        self.timeout = timeout

    # -- transport -------------------------------------------------------
    def _request(self, method: str, path: str, body: bytes = b"") -> bytes:
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)
        try:
            conn.request(method, path, body=body)
            r = conn.getresponse()
            data = r.read()
            if r.status != 200:
                try:
                    msg = json.loads(data)["error"]
                except Exception:
                    msg = data.decode(errors="replace")
                raise ServerError(r.status, msg)
            return data
        finally:
            conn.close()

    @property
    def _cid(self) -> str:
        # reserved characters in a client id (space, &, #, non-ASCII)
        # would otherwise corrupt the request line / query string
        return quote(self.client_id, safe="")

    # -- protocol --------------------------------------------------------
    def register(self) -> None:
        self._request("POST", f"/register?client={self._cid}")

    def reset(self) -> None:
        self._request("POST", f"/reset?client={self._cid}")

    def submit(self, pc: np.ndarray,
               rgb: Optional[np.ndarray] = None) -> np.ndarray:
        """One online-adaptation step: (B, N, 3) -> final logits (B, K)."""
        buf = io.BytesIO()
        if rgb is None:
            np.savez(buf, pc=np.asarray(pc, np.float32))
        else:
            np.savez(buf, pc=np.asarray(pc, np.float32),
                     rgb=np.asarray(rgb, np.float32))
        body = self._request("POST", f"/submit?client={self._cid}",
                             buf.getvalue())
        return np.load(io.BytesIO(body))

    def snapshot(self, name: str, blocking: bool = True) -> None:
        blk = "1" if blocking else "0"
        self._request("POST", f"/snapshot?client={self._cid}"
                              f"&name={quote(name, safe='')}&blocking={blk}")

    def restore(self, name: str) -> None:
        self._request("POST",
                      f"/restore?client={self._cid}"
                      f"&name={quote(name, safe='')}")

    def healthz(self) -> dict:
        return json.loads(self._request("GET", "/healthz"))
