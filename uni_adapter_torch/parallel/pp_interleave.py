"""Interleaved virtual-stage pipeline schedule (mirror of
`uni_adapter_tpu/parallel/pp_interleave.py`), and the ring executor both
of the port's schedules run.

GPipe's bubble is (S−1)/(m+S−1) of the ticks.  Interleaving splits every
rank's blocks into V virtual chunks of L/(S·V) blocks: logical stage
j ∈ [0, S·V) runs on rank j mod S as its chunk j div S, a microbatch
rides the ring V times, a tick is a chunk's time, and the bubble shrinks
by about V (Megatron's (p−1)/(v·m)).

The schedule (which chunk and microbatch each rank runs at every tick,
which queue slot feeds it, where each arrival is stored) is the JAX
module's, computed on the host by the same deterministic drain-first
greedy simulation (`build_interleaved_schedule`, copied: the JAX file
imports `jax`), and its numpy tables are bitwise JAX's.
`gpipe_schedule` writes the GPipe schedule of `parallel/pp.py` in the
same tables (one chunk, one queue slot).

The executor (`run_ticks`) is a parts generator: at each tick this rank
computes its scheduled chunk (only where the schedule has it busy; an
idle tick computes nothing, where JAX computes a dead buffer) and then
yields one 'shift' request where it sends or receives: its output to
the next rank of the stage ring, the previous rank's into a queue slot.
A microbatch's last logical stage (rank S−1's chunk V−1) sends nothing:
its output is kept there, and the caller broadcasts the finished
microbatches from that rank at the end (JAX lands them on device 0 and
psums).  Every rank's sequence of requests is static, and a pair of
ranks posts each send and its receive at the same tick.  The
per-microbatch constants (ULIP's positional embedding, PPTA's rel-pe
deltas) never ride the ring: each rank takes the extras of the
microbatch it computes from the replicated store by the schedule's
`cmp_m` table.  A stage group of one rank issues no shift: its arrivals
are its own outputs.

With `record` the executor detaches each tick's input and keeps (input,
extras, output) for `parallel/pp.py`'s backward, which runs the ticks in
reverse with the reverse shifts (ppermute's transpose).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from uni_adapter_torch.parallel.collectives import Collective


@dataclasses.dataclass(frozen=True)
class InterleavedSchedule:
    """Static tick tables for the interleaved ring executor.

    All tables are (T, S) int32, indexed [tick, device].  `cmp_*` describe
    the chunk a device computes that tick (chunk 0 on garbage for idle
    ticks — routed to the trash slot, never observable); `rcv_slot`/`out_m`
    describe where the buffer ARRIVING at the end of that tick goes.
    Flat queue-slot indices are chunk*Q + q; V*Q is the trash slot.
    """
    n_stages: int
    interleave: int
    n_micro: int
    ticks: int
    queue: int                 # Q: queue slots per (device, chunk)
    cmp_chunk: np.ndarray      # local chunk index computed (0 when idle)
    cmp_slot: np.ndarray       # flat input slot (trash when inject/idle)
    cmp_m: np.ndarray          # microbatch computed this tick (-1 idle)
    inj_m: np.ndarray          # microbatch injected at stage 0 (-1 none)
    rcv_slot: np.ndarray       # flat slot for this tick's arrival (trash ok)
    out_m: np.ndarray          # output slot for this tick's arrival (-1)
    busy: np.ndarray           # (S,) busy-tick counts (bubble accounting)

    @property
    def gpipe_chunk_ticks(self) -> int:
        """The GPipe schedule's cost in the same chunk-tick units: it runs
        (m + S - 1) ticks of V chunks each."""
        return self.interleave * (self.n_micro + self.n_stages - 1)


def build_interleaved_schedule(n_stages: int, interleave: int,
                               n_micro: int) -> InterleavedSchedule:
    """Simulate the drain-first greedy schedule and emit its tick tables.

    Model: one chunk-apply per device per tick; each tick every device
    ppermutes the buffer it just produced to the next ring device, where it
    becomes consumable the FOLLOWING tick.  Device 0 injects microbatches
    into logical stage 0 (directly from the microbatch store — no queue
    slot) whenever it has no higher-stage work ready; completed microbatches
    (stage S·V - 1, computed on device S-1) arrive back at device 0 as
    outputs.
    """
    S, V, M = n_stages, interleave, n_micro
    if S < 1 or V < 1 or M < 1:
        raise ValueError(f"bad schedule request S={S} V={V} M={M}")
    J = S * V

    pools: list[list[list[bool]]] = [
        [[] for _ in range(V)] for _ in range(S)]
    ready: list[list[tuple]] = [[] for _ in range(S)]  # (j, m, (v, q))
    rows: list[dict] = []
    next_inject = 0
    done = 0
    t = 0
    max_t = 4 * (V * M + J + S) + 16   # generous watchdog, never binds

    while done < M:
        if t >= max_t:
            raise RuntimeError(
                f"schedule simulation did not converge (S={S} V={V} M={M})")
        row = {
            "cmp_chunk": np.zeros(S, np.int32),
            "cmp_slot": [-1] * S,          # (v, q) tuples where active
            "cmp_m": np.full(S, -1, np.int32),
            "inj_m": np.full(S, -1, np.int32),
            "rcv_slot": [-1] * S,          # (v, q) tuples where active
            "out_m": np.full(S, -1, np.int32),
        }
        sends: list[tuple | None] = [None] * S

        # compute phase: Megatron-shaped policy on device 0 — FILL until
        # S*V microbatches are in flight (the pipeline depth), then
        # drain-first (1F1B steady state); other devices always drain
        # their highest ready stage.  Pure drain-first starves injection
        # (only ~S in flight) and degenerates to the GPipe bubble.
        in_flight = next_inject - done
        for s in range(S):
            best = None
            for entry in ready[s]:
                j, m, _ = entry
                key = (j, -m)
                if best is None or key > best[0]:
                    best = (key, entry)
            if s == 0 and next_inject < M and (
                    best is None or in_flight < J):
                row["inj_m"][0] = next_inject
                row["cmp_chunk"][0] = 0
                row["cmp_m"][0] = next_inject
                sends[0] = (0, next_inject)
                next_inject += 1
                continue
            if best is None:
                continue
            _, (j, m, (v, q)) = best
            ready[s].remove((j, m, (v, q)))
            pools[s][v][q] = False          # slot consumed at body start
            row["cmp_chunk"][s] = j // S
            row["cmp_slot"][s] = (v, q)     # flattened after Q is known
            row["cmp_m"][s] = m
            sends[s] = (j, m)

        # arrival phase: buffers land at end of tick t, consumable at t+1
        for s in range(S):
            if sends[s] is None:
                continue
            j, m = sends[s]
            d = (s + 1) % S
            if j + 1 == J:
                assert d == 0, "final stage must feed device 0"
                row["out_m"][0] = m
                done += 1
                continue
            v2 = (j + 1) // S
            pool = pools[d][v2]
            try:
                q2 = pool.index(False)
                pool[q2] = True
            except ValueError:
                pool.append(True)
                q2 = len(pool) - 1
            row["rcv_slot"][d] = (v2, q2)
            ready[d].append((j + 1, m, (v2, q2)))

        rows.append(row)
        t += 1

    Q = max(1, max(len(p) for dev in pools for p in dev))
    trash = V * Q

    # cmp_slot / rcv_slot rows hold (v, q) tuples where active, -1 where not
    cmp_slot = np.full((t, S), trash, np.int32)
    rcv_slot = np.full((t, S), trash, np.int32)
    for tt, row in enumerate(rows):
        for s in range(S):
            for name, table in (("cmp_slot", cmp_slot),
                                ("rcv_slot", rcv_slot)):
                v = row[name][s]
                if isinstance(v, tuple):
                    table[tt, s] = v[0] * Q + v[1]
    busy = np.zeros(S, np.int64)
    for row in rows:
        for s in range(S):
            active = (row["inj_m"][s] >= 0
                      or isinstance(row["cmp_slot"][s], tuple))
            busy[s] += bool(active)

    return InterleavedSchedule(
        n_stages=S, interleave=V, n_micro=M, ticks=t, queue=Q,
        cmp_chunk=np.stack([r["cmp_chunk"] for r in rows]),
        cmp_slot=cmp_slot,
        cmp_m=np.stack([r["cmp_m"] for r in rows]),
        inj_m=np.stack([r["inj_m"] for r in rows]),
        rcv_slot=rcv_slot,
        out_m=np.stack([r["out_m"] for r in rows]),
        busy=busy,
    )


def gpipe_schedule(n_stages: int, n_micro: int) -> InterleavedSchedule:
    """The GPipe schedule of `parallel/pp.py` in `build_interleaved_schedule`'s
    tables (one chunk a rank, one queue slot): at tick t rank 0 injects
    microbatch t and rank s computes microbatch t − s; a rank's arrival
    is consumed at the next tick.  M + S − 1 ticks."""
    S, M = n_stages, n_micro
    if S < 1 or M < 1:
        raise ValueError(f"bad schedule request S={S} M={M}")
    T = M + S - 1
    t = np.arange(T)[:, None]
    m = t - np.arange(S)[None, :]
    live = (m >= 0) & (m < M)
    cmp_m = np.where(live, m, -1).astype(np.int32)
    inj_m = np.full((T, S), -1, np.int32)
    inj_m[:M, 0] = np.arange(M)
    trash = 1
    cmp_slot = np.where(live & (np.arange(S) > 0), 0, trash).astype(np.int32)
    rcv_slot = np.full((T, S), trash, np.int32)
    rcv_slot[:, 1:] = np.where(live[:, :-1], 0, trash)
    out_m = np.full((T, S), -1, np.int32)
    out_m[:, 0] = cmp_m[:, S - 1]
    return InterleavedSchedule(
        n_stages=S, interleave=1, n_micro=M, ticks=T, queue=1,
        cmp_chunk=np.zeros((T, S), np.int32), cmp_slot=cmp_slot,
        cmp_m=cmp_m, inj_m=inj_m, rcv_slot=rcv_slot, out_m=out_m,
        busy=np.full(S, M, np.int64))


def interleaved_block_order(depth: int, n_stages: int,
                            interleave: int) -> list:
    """The global block indices each rank's chunks hold, [s][v] → the
    blocks of logical stage v·S + s: block (v·S + s)·Lc + c for c < Lc =
    depth/(S·V) (JAX's `stack_trunk_params_interleaved[s, v, c]`)."""
    S, V = n_stages, interleave
    if depth % (S * V):
        raise ValueError(
            f"depth {depth} not divisible by {S} stages x {V} chunks")
    Lc = depth // (S * V)
    return [[[(v * S + s) * Lc + c for c in range(Lc)] for v in range(V)]
            for s in range(S)]


class Tick(NamedTuple):
    """What one rank does at one tick of a schedule."""
    chunk: int      # the local chunk it computes, -1: idle
    m: int          # the microbatch it computes (its extras), -1: idle
    src: int        # the queue slot it reads, -1: microbatch m injected
    final: bool     # it computes microbatch m's last logical stage
    send: bool      # it sends its output to the next rank
    recv: int       # the slot the previous rank's output lands in, -1: none


def rank_plan(sched: InterleavedSchedule, rank: int) -> list:
    """Rank `rank`'s ticks of `sched` (`Tick`s): the compute the tables
    give it, and the shift after it, whose sends and receives pair up
    between neighbours at the same tick.  The last logical stage sends
    nothing: its output is the microbatch's."""
    S, J = sched.n_stages, sched.n_stages * sched.interleave
    prev = (rank - 1) % S

    def stage(t, s):
        m = int(sched.cmp_m[t, s])
        return None if m < 0 else int(sched.cmp_chunk[t, s]) * S + s

    plan = []
    for t in range(sched.ticks):
        j, jp = stage(t, rank), stage(t, prev)
        recv = (int(sched.rcv_slot[t, rank])
                if jp is not None and jp != J - 1 else -1)
        if j is None:
            plan.append(Tick(-1, -1, -1, False, False, recv))
            continue
        src = (-1 if sched.inj_m[t, rank] >= 0
               else int(sched.cmp_slot[t, rank]))
        plan.append(Tick(j // S, int(sched.cmp_m[t, rank]), src,
                         j == J - 1, j != J - 1, recv))
    return plan


def run_ticks(plan: list, chunks: list, micro_carry: torch.Tensor,
              micro_extras: Optional[torch.Tensor], ring: tuple,
              record: Optional[dict] = None):
    """Parts: this rank's ticks of `plan` over the stage ring `ring` =
    (group, rank, size).  `chunks[v](x, extras)` is a parts generator of
    local chunk v; `micro_carry` (M, Bm, ...) is the microbatch store and
    `micro_extras` (M, ...) the per-microbatch constants (or None).  Each
    tick computes its chunk where the plan has one, then yields its
    'shift' where it sends or receives (the receive buffer allocated
    here).  Returns {m: output} of the microbatches whose last logical
    stage ran here.  With `record` ({}), each tick's input and extras are
    detached leaves that require grad, the sent buffers are detached, and
    record[t] = (input, extras, output)."""
    group, rank, size = ring
    queue, outs = {}, {}
    proto = micro_carry[0]
    to, frm = (rank + 1) % size, (rank - 1) % size
    for t, tick in enumerate(plan):
        y = None
        if tick.m >= 0:
            x = micro_carry[tick.m] if tick.src < 0 else queue.pop(tick.src)
            e = None if micro_extras is None else micro_extras[tick.m]
            if record is not None:
                x = x.detach().requires_grad_()
                e = None if e is None else e.detach().requires_grad_()
            y = yield from chunks[tick.chunk](x, e)
            if record is not None:
                record[t] = (x, e, y)
            if tick.final:
                outs[tick.m] = y
        if size == 1:               # the ring is this rank: no shift
            if tick.recv >= 0:
                queue[tick.recv] = y
            continue
        if not tick.send and tick.recv < 0:
            continue
        out = (torch.empty(proto.shape, dtype=proto.dtype,
                           device=proto.device) if tick.recv >= 0 else None)
        send = None
        if tick.send:
            send = y.detach() if record is not None else y
        yield Collective("shift", send, out, group,
                         peers=(to if tick.send else None,
                                frm if tick.recv >= 0 else None))
        if tick.recv >= 0:
            queue[tick.recv] = out
    return outs


def pipeline_interleaved(chunks: list, micro_carry: torch.Tensor,
                         sched: InterleavedSchedule, ring: tuple,
                         micro_extras: Optional[torch.Tensor] = None,
                         record: Optional[dict] = None):
    """Parts: the interleaved ring executor (JAX `pipeline_interleaved`) on
    this rank of `ring` = (group, rank, size): `chunks` its V chunks, the
    microbatches' outputs returned where their last logical stage ran
    (rank S−1), for the caller to broadcast (`run_ticks`)."""
    if micro_carry.shape[0] != sched.n_micro:
        raise ValueError(f"{micro_carry.shape[0]} microbatches for a "
                         f"schedule of {sched.n_micro}")
    return (yield from run_ticks(rank_plan(sched, ring[1]), chunks,
                                 micro_carry, micro_extras, ring, record))
