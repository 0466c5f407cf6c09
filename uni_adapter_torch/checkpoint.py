"""Snapshots of adaptation and training state (mirror of
`uni_adapter_tpu/checkpoint.py`).

A carry (`engine.EngineState`: every method's NamedTuple state, the
residual state, the step count and each stream's `torch.Generator`), a
trainer's state (`train.TrainState` with its AdamW moments and count,
`models/dvae_train.DVAETrainState`), or a dict or list of these, tensors,
numbers and strings (`engine.run_stream`'s resume point, the pretraining
CLI's stamped checkpoint), is written as two files:

  * `PATH.npz`: every tensor, number, string and generator state, as
    numpy arrays (a generator's state is its `get_state()` bytes);
  * `PATH.json`: the structure alone: the types, field names, the device
    of each tensor and generator, and which array holds each.

No code object is pickled, and the structure holds no value, so a
structure file fits every snapshot of the same carry.  Both files are
written to temp names and `os.replace`d, the structure first, as the JAX
package orders them: a crash between the two leaves the previous `.npz`
beside a structure that reads it.

Snapshots of the JAX package (an `.npz` beside a pickled treedef, with a
JAX PRNG key for the generator) are not readable here, nor the other way
round.  `AsyncSnapshotter` writes the same two files from a background
thread (there is no orbax here), so a restore reads either kind the same
way.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

FORMAT = "uni_adapter_torch.snapshot/1"


def _named_tuples() -> dict:
    """The NamedTuple states a carry may hold, by name."""
    from uni_adapter_torch import train
    from uni_adapter_torch.adapt import (adaptive, cache, dota, gmm,
                                         mode_dota, residual)
    from uni_adapter_torch.models import dvae_train

    types = (mode_dota.ModeDotaState, cache.CacheState, dota.DOTAState,
             gmm.GMMDotaState, adaptive.AdaptiveState,
             residual.ResidualState, train.TrainState, train.AdamWState,
             dvae_train.DVAETrainState)
    return {t.__name__: t for t in types}


def _encode(obj: Any, arrays: dict) -> Any:
    """The structure of `obj`, its values moved into `arrays`."""
    from uni_adapter_torch.engine import EngineState

    def leaf(kind: str, value: np.ndarray, **extra) -> dict:
        key = f"a{len(arrays)}"
        arrays[key] = value
        return {"kind": kind, "key": key, **extra}

    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return leaf("tensor", obj.detach().cpu().numpy(),
                    device=obj.device.type)
    if isinstance(obj, torch.Generator):
        return leaf("generator", obj.get_state().numpy(),
                    device=obj.device.type)
    if isinstance(obj, bool):
        return leaf("bool", np.asarray(obj))
    if isinstance(obj, int):
        return leaf("int", np.asarray(obj, np.int64))
    if isinstance(obj, float):
        return leaf("float", np.asarray(obj, np.float64))
    if isinstance(obj, str):
        return leaf("str", np.asarray(obj))
    if isinstance(obj, EngineState):
        return {"kind": "EngineState",
                "fields": {f.name: _encode(getattr(obj, f.name), arrays)
                           for f in dataclasses.fields(obj)}}
    if isinstance(obj, tuple) and type(obj).__name__ in _named_tuples():
        return {"kind": type(obj).__name__,
                "items": [_encode(v, arrays) for v in obj]}
    if type(obj) in (list, tuple):
        return {"kind": type(obj).__name__,
                "items": [_encode(v, arrays) for v in obj]}
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise TypeError("a snapshot's dict keys must be str")
        return {"kind": "dict",
                "fields": {k: _encode(v, arrays) for k, v in obj.items()}}
    raise TypeError(f"cannot snapshot a {type(obj).__name__}")


def _decode(node: Any, arrays, device) -> Any:
    from uni_adapter_torch.engine import EngineState

    if node is None:
        return None
    kind = node["kind"]
    if kind == "tensor":
        return torch.from_numpy(arrays[node["key"]].copy()).to(
            device if device is not None else node["device"])
    if kind == "generator":
        dev = torch.device(device if device is not None else node["device"])
        if dev.type != node["device"]:
            raise ValueError(f"a {node['device']} generator's state cannot "
                             f"be restored onto {dev.type}")
        gen = torch.Generator(device=dev)
        gen.set_state(torch.from_numpy(arrays[node["key"]].copy()))
        return gen
    if kind in ("bool", "int", "float", "str"):
        return {"bool": bool, "int": int, "float": float, "str": str}[kind](
            arrays[node["key"]].item())
    if kind in ("EngineState", "dict"):
        fields = {k: _decode(v, arrays, device)
                  for k, v in node["fields"].items()}
        return EngineState(**fields) if kind == "EngineState" else fields
    items = [_decode(v, arrays, device) for v in node["items"]]
    if kind == "list":
        return items
    if kind == "tuple":
        return tuple(items)
    return _named_tuples()[kind](*items)


def _write(path: str, structure: dict, arrays: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # the temp name must end in .npz or np.savez appends another suffix
    tmp_npz, tmp_json = path + ".tmp.npz", path + ".json.tmp"
    np.savez(tmp_npz, **arrays)
    with open(tmp_json, "w") as f:
        json.dump({"format": FORMAT, "structure": structure}, f)
    os.replace(tmp_json, path + ".json")
    os.replace(tmp_npz, path + ".npz")


def save_state(path: str, state: Any) -> None:
    """Write `state` (a carry, or a dict/list of carries, tensors and
    numbers) as PATH.json + PATH.npz.  Blocks until both are on disk."""
    arrays: dict = {}
    structure = _encode(state, arrays)
    _write(path, structure, arrays)


def restore_state(path: str, device=None) -> Any:
    """Read what `save_state` (or `AsyncSnapshotter`) wrote at `path`:
    tensors and generators on `device`, or on the device each was saved
    from.  A generator restores only onto its own device type."""
    if not os.path.isfile(path + ".json"):
        hint = (" (a JAX package snapshot: not readable by this package)"
                if os.path.isfile(path + ".treedef") else "")
        raise FileNotFoundError(f"no snapshot at {path!r}: {path}.json is "
                                f"missing{hint}")
    with open(path + ".json") as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}.json is not a {FORMAT} structure file")
    with np.load(path + ".npz") as arrays:
        return _decode(meta["structure"], arrays, device)


def copy_state(obj: Any) -> Any:
    """A copy of what `save_state` takes that shares no tensor and no
    generator with it (a carry through `engine.clone_state`)."""
    from uni_adapter_torch.engine import EngineState, clone_state

    if isinstance(obj, EngineState):
        return clone_state(obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, torch.Generator):
        gen = torch.Generator(device=obj.device)
        gen.set_state(obj.get_state())
        return gen
    if isinstance(obj, dict):
        return {k: copy_state(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(copy_state(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(copy_state(v) for v in obj)
    return obj


class AsyncSnapshotter:
    """Non-blocking snapshots of a carry, or of anything `save_state`
    takes: `save` takes a device-side copy of it at the call
    (`copy_state`, and an event recorded on the card), then one background
    thread moves the copy to the host and writes the same two files as
    `save_state`, in call order.  The copy matters: PyTorch's tensors are
    mutable, and a trainer updates its parameters in place while the
    write is in flight.  `wait()` blocks until every save so far is on
    disk and raises the first error a save met."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="snapshot")
        self._pending: list[Future] = []
        self._lock = threading.Lock()

    def save(self, path: str, state) -> None:
        copy = copy_state(state)
        event = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            event = torch.cuda.Event()
            event.record()

        def write():
            if event is not None:
                event.synchronize()
            save_state(path, copy)

        with self._lock:
            self._pending.append(self._pool.submit(write))

    def wait(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "AsyncSnapshotter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
