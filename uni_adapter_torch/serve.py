"""Online serving: many clients, each its own adaptation stream (mirror of
`uni_adapter_tpu/serve.py`, its replicated mode).

Each client is an independent online-adaptation stream with its own
`engine.EngineState`: mixture, residuals or cache, step count and
`torch.Generator`.  The requests of one tick (at most one a client) are
cut greedily into chunks of the sizes of a ladder (9 → 8 + 1): a chunk of
one request takes the single-stream step, a larger one stacks its
clients' carries on the stream axis (`engine.stack_states`) for one step
of the stream-axis path the corruption sweep runs (one encoder forward of
all the chunk's clouds) and unstacks them after.  The clients of a chunk
may stand at different points of their streams: every count is read per
stream (engine module docstring).  So each client's logits are what a
dedicated `engine.run_stream` of its stream gives (the step of one stream
against the step of a stack: fp32 rounding apart).

Only where the ladder cannot express the tick's remainder (no size 1)
does the last chunk pad with an inert copy of its first request, whose
state is dropped.  A tick is atomic: the clients' carries are committed
only after every chunk has run, and every chunk steps on copies of the
clients' generators (the port's generators advance in place, where JAX's
keys are values), so a tick that fails leaves every client's tensors and
generators as they were.

The tick runs eagerly, on the device of the model and the anchors.
Client i is seeded `seed + i` (the reference's seed+rank), and a seed slot
is never reused.

`dist_mode='ep'` serves with every client's classes over the ranks of a
process group (`parallel/ep.py`): each rank holds its block of every
client's padded carry, the ladder is [1] (the class group already works
on every request), and snapshots hold the full-K carry, gathered from
the ranks, which `restore` pads onto this world again (so a snapshot
moves between worlds and to a replicated server).  The JAX server is one
process over a mesh; here each rank is a process, so rank 0 serves (the
HTTP front end and its batcher call it) and every other rank runs
`follow`: before each operation rank 0 broadcasts it (step, register,
reset, warmup, snapshot, restore, stop) over a gloo control group with a
timeout, and the followers run the same operation, collectives and all.
Rank 0 sends a heartbeat while idle, so a follower whose rank 0 has
stopped answering raises at the timeout instead of waiting for ever.

`encode_fn` swaps the encoder forward, as the JAX server's does: a
tensor-parallel trunk (`parallel/tp.make_tp_encode_fn`) whose blocks sum
over a model group, or a pipeline-parallel one
(`parallel/pp.make_pp_encode_fn`) whose stages shift their activations
along a ring and broadcast the trunk's output.  Every rank of the world then runs every operation,
so rank 0 serves and the other ranks follow it as under EP; the
replicated ladder is kept (each rank holds every client's carry).  With
`dist_mode='ep'` and a (classes, model) grid (`tp.make_tp_grid`: the
class group as `mesh`, the trunk over the model group) it serves EP ×
TP.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from uni_adapter_torch import checkpoint, engine
from uni_adapter_torch.config import Config
from uni_adapter_torch.parallel import ep as pep
from uni_adapter_torch.parallel.mesh import World, make_mesh


def _own_generator(state: engine.EngineState) -> engine.EngineState:
    """The carry with a copy of its generator: a step on it leaves the
    original generator where it was."""
    return dataclasses.replace(
        state, generator=engine.copy_generator(state.generator))


class _Control:
    """Rank 0's channel to the other ranks of an EP server: operations
    broadcast over a gloo group of the world's ranks (its own timeout),
    one at a time, and a heartbeat from rank 0 when it has sent nothing
    for `heartbeat_s` seconds."""

    def __init__(self, timeout_s: float = 120.0, heartbeat_s: float = 20.0):
        self.group = dist.new_group(backend="gloo",
                                    timeout=timedelta(seconds=timeout_s))
        self.primary = dist.get_rank() == 0
        self.lock = threading.RLock()
        self._heartbeat_s = heartbeat_s
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._beat = None
        if self.primary:
            self._beat = threading.Thread(target=self._beats, daemon=True,
                                          name="tta-ep-heartbeat")
            self._beat.start()

    def send(self, op: tuple) -> None:
        with self.lock:
            dist.broadcast_object_list([op], src=0, group=self.group)
            self._last = time.monotonic()

    def receive(self) -> tuple:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def _beats(self) -> None:
        while not self._stop.wait(self._heartbeat_s / 4):
            with self.lock:
                if self._stop.is_set():
                    return
                if time.monotonic() - self._last >= self._heartbeat_s:
                    self.send(("noop",))

    def close(self) -> None:
        self._stop.set()
        if self._beat is not None:
            self._beat.join(timeout=10)


class TTAServer:
    """Stateful multi-client test-time-adaptation server."""

    def __init__(self, cfg: Config, model, text_features: torch.Tensor,
                 sizes: Sequence[int] = (1, 2, 4, 8, 16), seed: int = 42,
                 dist_mode: str = "replicated",
                 mesh: Optional[World] = None, encode_fn=None):
        """`model` and `text_features` lie on the device the server runs
        on.  `dist_mode` 'ep' splits the clients' classes over the ranks
        of `mesh` (default: the initialised process group, else this
        process alone).  `encode_fn` replaces the model's forward
        (`engine.make_step_fn`): a tensor- or pipeline-parallel trunk, in
        a world of several ranks served by rank 0 and followed by the
        others."""
        if dist_mode not in ("replicated", "ep"):
            raise ValueError(
                f"dist_mode {dist_mode!r}: the serving loop supports "
                "'replicated' (per-client vmap ladder) or 'ep' "
                "(class-sharded state); stream sharding modes belong to "
                "the sweep CLI")
        self.cfg = cfg
        self.text = text_features
        self.device = text_features.device
        self.seed = seed
        self.sizes = sorted(sizes)
        self.states: Dict[str, engine.EngineState] = {}
        self._next_client = 0
        self._snapshotter: Optional[checkpoint.AsyncSnapshotter] = None
        self._ep: Optional[pep.ClassShard] = None
        self._control: Optional[_Control] = None
        world = mesh or make_mesh()
        if dist_mode == "ep":
            shard = pep.class_shard(world, text_features.shape[0])
            self._ep, self._full_text = shard, text_features
            self.text = pep.pad_classes(text_features, shard.n)[0][
                shard.offset:shard.offset + shard.k_local]
            self._step = pep.make_ep_step_fn(cfg, model, shard,
                                             encode_fn=encode_fn)
            self.sizes = [1]
            logging.info("EP serving: K=%d over %d ranks (%d classes a "
                         "rank; ladder [1])", shard.num_classes, shard.n,
                         shard.k_local)
        else:
            self._step = engine.make_step_fn(cfg, model, encode_fn=encode_fn)
        # every rank runs each operation where the step has collectives
        # over other processes: the class group's, the trunk's
        if (world.group is not None and dist_mode == "ep") or (
                encode_fn is not None and make_mesh().size > 1):
            self._control = _Control()

    @property
    def primary(self) -> bool:
        """Whether this process serves (rank 0, or a world of one)."""
        return self._control is None or self._control.primary

    def _call(self, name: str, *args):
        """Run operation `name`: on rank 0 of an EP or a tensor-parallel
        world, first sent to the other ranks (which run it in
        `follow`)."""
        if self._control is None or not self._control.primary:
            return getattr(self, "_" + name)(*args)
        with self._control.lock:
            self._control.send((name, *args))
            return getattr(self, "_" + name)(*args)

    def stop(self) -> None:
        """End the other ranks' `follow` loops (rank 0 of an EP or a
        tensor-parallel world; a no-op otherwise)."""
        if self._control is not None and self._control.primary:
            self._control.close()
            self._control.send(("stop",))

    def _new_state(self, seed: int) -> engine.EngineState:
        if self._ep is not None:
            return pep.local_padded_state(self.cfg, self._full_text,
                                          self._ep, seed)
        return engine.init_state(self.cfg, self.text, seed)

    def warmup(self, npoints: int, batch: int = 1) -> None:
        self._call("warmup", npoints, batch)

    def _warmup(self, npoints: int, batch: int = 1) -> None:
        """One step of every ladder size (and the single-request path) on
        a scratch state: every kernel of the path is built (nvcc runs at
        its first launch) before the first request.  No client state is
        touched; a kernel that fails to build raises here."""
        pc = torch.zeros((batch, npoints, 3), device=self.device)
        rgb = torch.ones_like(pc)
        targets = torch.zeros((batch,), dtype=torch.int64, device=self.device)
        self._step(self.text, self._new_state(0), (pc, rgb, targets))
        for size in self.sizes:
            if size == 1:
                continue   # a size-1 chunk takes the single-stream step
            stacked = engine.stack_states(
                [engine.init_state(self.cfg, self.text, 0)
                 for _ in range(size)])
            self._step(self.text, stacked,
                       tuple(a.expand(size, *a.shape).contiguous()
                             for a in (pc, rgb, targets)))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        logging.info("warmed up the step for sizes %s (npoints=%d, "
                     "batch=%d)", list(self.sizes), npoints, batch)

    def register(self, client_id: str) -> None:
        """Create a fresh adaptation stream for a client (seeded seed+i —
        the reference's seed+rank convention)."""
        self._call("register", client_id)

    def _register(self, client_id: str) -> None:
        if client_id in self.states:
            raise ValueError(f"client {client_id!r} already registered")
        self.states[client_id] = self._new_state(self.seed
                                                 + self._next_client)
        self._next_client += 1

    def reset(self, client_id: str) -> None:
        """Restart a client's adaptation from scratch (fresh seed — seed
        slots are never reused, so restarted streams stay decorrelated)."""
        self._call("reset", client_id)

    def _reset(self, client_id: str) -> None:
        if client_id not in self.states:
            raise ValueError(f"client {client_id!r} is not registered "
                             f"(known: {sorted(self.states)})")
        del self.states[client_id]
        self._register(client_id)

    def submit(self, requests: List[Tuple[str, np.ndarray,
                                          Optional[np.ndarray]]]
               ) -> Dict[str, np.ndarray]:
        """Process one tick of requests.

        Args:
          requests: list of (client_id, pc (B,N,3), rgb (B,N,3) or None).
            At most one request per client per tick; clients must be
            registered.
        Returns:
          {client_id: final_logits (B, K)} as numpy arrays.

        Atomicity: no client state is written back until every chunk of
        the tick has run.  If any chunk raises, every client's carry,
        generator included, is left as it was: a client that retries
        after an error cannot double-step its stream.
        """
        return self._call("submit", requests)

    def _submit(self, requests) -> Dict[str, np.ndarray]:
        if not requests:
            return {}
        ids = [r[0] for r in requests]
        if len(set(ids)) != len(ids):
            raise ValueError("one request per client per tick")
        for cid in ids:
            if cid not in self.states:
                raise KeyError(f"client {cid!r} not registered")

        # greedy decomposition into ladder sizes: the largest size ≤ what
        # remains, the smallest size (padded) only for a remainder the
        # ladder cannot express
        result: Dict[str, np.ndarray] = {}
        new_states: Dict[str, engine.EngineState] = {}
        i = 0
        while i < len(requests):
            rem = len(requests) - i
            fit = [s for s in self.sizes if s <= rem]
            size = max(fit) if fit else self.sizes[0]
            chunk = requests[i:i + size]
            states, logits = self._run_chunk(chunk, size)
            new_states.update(states)
            result.update(logits)
            i += len(chunk)
        self.states.update(new_states)   # commit only after all chunks ran
        return result

    def _inputs(self, pc, rgb) -> tuple:
        pc = torch.as_tensor(np.asarray(pc, np.float32), device=self.device)
        rgb = (torch.ones_like(pc) if rgb is None else torch.as_tensor(
            np.asarray(rgb, np.float32), device=self.device))
        return pc, rgb

    def _run_chunk(self, requests, size: int):
        """Run ≤ size requests as one step of width size.  Returns
        ({client: new_state}, {client: logits}) without touching
        self.states — submit() commits after the whole tick succeeds."""
        if len(requests) == 1 and size == 1:
            cid, pc, rgb = requests[0]
            pc, rgb = self._inputs(pc, rgb)
            targets = torch.zeros(pc.shape[0], dtype=torch.int64,
                                  device=self.device)   # unused label
            new_state, outs = self._step(
                self.text, _own_generator(self.states[cid]),
                (pc, rgb, targets))
            return ({cid: new_state},
                    {cid: outs.final_logits.cpu().numpy()})
        ids = [r[0] for r in requests]
        pad = size - len(requests)     # only a ladder-remainder chunk pads
        inputs = [self._inputs(r[1], r[2]) for r in requests]
        inputs += inputs[:1] * pad
        # every slot steps on its own copy of a generator; the padding
        # slot's is a second copy of the first client's, so that client's
        # stream advances once
        states = [_own_generator(self.states[c])
                  for c in ids + ids[:1] * pad]
        pcs = torch.stack([p for p, _ in inputs])
        rgbs = torch.stack([r for _, r in inputs])
        targets = torch.zeros(pcs.shape[:2], dtype=torch.int64,
                              device=self.device)       # unused label
        new, outs = self._step(self.text, engine.stack_states(states),
                               (pcs, rgbs, targets))
        logits = outs.final_logits.cpu().numpy()
        return ({cid: engine.unstack_state(new, i)
                 for i, cid in enumerate(ids)},
                {cid: logits[i] for i, cid in enumerate(ids)})

    def snapshot(self, client_id: str, path: str,
                 blocking: bool = True) -> None:
        """Persist one client's adaptation state (exact resume: the carry
        holds the generator and the step count) as `checkpoint.save_state`
        writes it.  With `blocking=False` the write runs on a background
        thread from a copy taken now, and serving goes on (call
        `drain_snapshots()` before reading it or shutting down).  An EP
        server writes the full-K carry, gathered from the ranks (rank 0
        writes)."""
        self._call("snapshot", client_id, path, blocking)

    def _snapshot(self, client_id: str, path: str, blocking: bool) -> None:
        state = self.states[client_id]
        if self._ep is not None:
            state = pep.gather_state(state, self._ep)
        if not self.primary:
            return
        if blocking:
            checkpoint.save_state(path, state)
            return
        if self._snapshotter is None:
            self._snapshotter = checkpoint.AsyncSnapshotter()
        self._snapshotter.save(path, state)

    def drain_snapshots(self) -> None:
        """Block until all non-blocking snapshots are on disk."""
        if self._snapshotter is not None:
            self._snapshotter.wait()

    def restore(self, client_id: str, path: str) -> None:
        """Load a client's carry from a snapshot.  Blocking and
        non-blocking snapshots write one format, so the path names one
        pair of files (no choice by modification time, as the JAX
        server's between an orbax directory and an .npz); pending
        non-blocking snapshots are drained first.  An unknown client is
        registered first (the restarted-process case), and that is undone
        if the load fails.  An EP server pads the full-K carry onto its
        ranks (every rank reads the file)."""
        self.drain_snapshots()
        self._call("restore", client_id, path)

    def _restore(self, client_id: str, path: str) -> None:
        fresh = client_id not in self.states
        if fresh:
            self._register(client_id)
        try:
            loaded = checkpoint.restore_state(path, self.device)
            if not isinstance(loaded, engine.EngineState):
                raise ValueError(f"{path!r} holds no adaptation state")
            if self._ep is not None:
                loaded = pep.local_padded_state(
                    self.cfg, self._full_text, self._ep, self.seed,
                    initial_state=loaded)
            self.states[client_id] = loaded
        except Exception:
            if fresh:
                del self.states[client_id]
            raise
        logging.info("client %s state restored", client_id)


def follow(server: TTAServer) -> None:
    """The loop of an EP or a tensor-parallel server's rank other than 0
    (`TTAServer.primary` false): run each operation
    rank 0 sends, until it sends 'stop'.  An operation that raises is
    logged and the loop goes on, as rank 0 goes on serving after it:
    what an operation checks (the clients, the request, the snapshot's
    files) every rank holds alike and checks before its first
    collective, so the ranks raise alike (an unknown client, a missing
    or unreadable snapshot)."""
    control = server._control
    while True:
        name, *args = control.receive()
        if name == "stop":
            return
        if name == "noop":
            continue
        try:
            getattr(server, "_" + name)(*args)
        except Exception as e:
            logging.warning("follower: %s failed: %r", name, e)
