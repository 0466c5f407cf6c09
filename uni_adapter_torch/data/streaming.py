"""Streaming, sharded ingestion for pretraining corpora (mirror of
`uni_adapter_tpu/data/streaming.py`).

 * **ShardedCorpus**: the corpus as a list of shard files (point clouds
   and aligned text/image embedding shards), each read through
   `native.loader.NativeNpy` (the C++ mmap reader, numpy where it is
   out): opening the corpus touches headers only; bytes move when a
   sample is gathered.
 * **StreamingLoader**: a deterministic, resumable, per-process batch
   iterator.  Epoch `e` is the fixed permutation `PRNG(seed, e)` of the
   global index, cut into fixed-size global batches (the remainder
   dropped); process `p` of `P` owns rows `[p·B_loc, (p+1)·B_loc)` of
   every global batch, so the rank-order concatenation of the per-process
   slices is the single-process batch stream.  A background thread keeps
   `prefetch` assembled batches ahead of the consumer; `state_dict()` /
   `load_state_dict()` resume mid-epoch exactly.
 * **global_batch**: a process's numpy batch as tensors on its device:
   over a world of ranks, its slice of the global batch.

`process_index` / `process_count` default to the torch.distributed rank
and world size (the JAX package reads them from jax): each rank of a
data-parallel launch reads only its own rows.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ShardedCorpus", "StreamingLoader", "global_batch"]


class ShardedCorpus:
    """A pretraining corpus as aligned shard files.

    Args:
      pc_shards: list of `.npy` paths, shard i shaped (n_i, N, C).
      text_shards: optional list aligned with pc_shards, (n_i, D) each.
      image_shards: optional, (n_i, D) each; samples without an image
        embedding get a zero vector and mask 0 (the `mask` convention of
        `models/losses.uni3d_text_image_loss`).
    """

    def __init__(self, pc_shards: Sequence[str],
                 text_shards: Optional[Sequence[str]] = None,
                 image_shards: Optional[Sequence[str]] = None,
                 prefetch_ring: int = 0):
        from uni_adapter_torch.native.loader import NativeNpy

        if not pc_shards:
            raise ValueError("ShardedCorpus: no point-cloud shards given")
        for name, other in (("text", text_shards), ("image", image_shards)):
            if other is not None and len(other) != len(pc_shards):
                raise ValueError(
                    f"ShardedCorpus: {len(other)} {name} shards for "
                    f"{len(pc_shards)} pc shards")
        self.pc = [NativeNpy(p, prefetch=prefetch_ring) for p in pc_shards]
        self.text = ([NativeNpy(p) for p in text_shards]
                     if text_shards is not None else None)
        self.image = ([NativeNpy(p) for p in image_shards]
                      if image_shards is not None else None)
        sizes = [len(r) for r in self.pc]
        for group, name in ((self.text, "text"), (self.image, "image")):
            if group is not None:
                for i, r in enumerate(group):
                    if len(r) != sizes[i]:
                        raise ValueError(
                            f"shard {i}: {name} rows {len(r)} != pc rows "
                            f"{sizes[i]}")
        self._starts = np.concatenate([[0], np.cumsum(sizes)])
        self.sample_shape: Tuple[int, ...] = tuple(self.pc[0].shape[1:])
        self.embed_dim: Optional[int] = (
            int((self.text or self.image)[0].shape[1])
            if (self.text or self.image) else None)
        # per-sample SHAPES must agree across every shard, at construction
        # — the headers are already open, and a mismatch found here is a
        # clear error instead of (a) a crash hours in when the permutation
        # first touches the bad shard, or worse (b) a BROADCASTABLE shard
        # (e.g. (n, 1) embeddings next to (n, D)) silently tiling wrong
        # values into the training data
        for i, r in enumerate(self.pc):
            if tuple(r.shape[1:]) != self.sample_shape:
                raise ValueError(
                    f"pc shard {i}: sample shape {tuple(r.shape[1:])} != "
                    f"{self.sample_shape} (shard 0)")
        for group, name in ((self.text, "text"), (self.image, "image")):
            if group is not None:
                for i, r in enumerate(group):
                    if tuple(r.shape[1:]) != (self.embed_dim,):
                        raise ValueError(
                            f"{name} shard {i}: embedding shape "
                            f"{tuple(r.shape[1:])} != ({self.embed_dim},)")

    def __len__(self) -> int:
        return int(self._starts[-1])

    def _locate(self, g: int) -> Tuple[int, int]:
        s = int(np.searchsorted(self._starts, g, side="right")) - 1
        return s, g - int(self._starts[s])

    def gather(self, global_idx: np.ndarray) -> Dict[str, np.ndarray]:
        """Assemble one local batch for the given global sample indices."""
        n = len(global_idx)
        pc = np.empty((n,) + self.sample_shape, np.float32)
        D = self.embed_dim or 0
        text = np.zeros((n, D), np.float32) if self.text else None
        image = np.zeros((n, D), np.float32) if self.image else None
        mask = np.ones((n,), np.float32)
        for j, g in enumerate(global_idx):
            s, r = self._locate(int(g))
            pc[j] = self.pc[s].read_f32(r)
            if text is not None:
                text[j] = self.text[s].read_f32(r)
            if image is not None:
                image[j] = self.image[s].read_f32(r)
        if image is None:
            image = np.zeros((n, D), np.float32) if D else None
            mask = np.zeros((n,), np.float32)
        else:
            # per-row mask, as the class docstring promises: an all-zero
            # image row means "no render for this sample" and must not
            # train the image leg at full weight against a degenerate
            # embedding (mask convention of losses.uni3d_text_image_loss)
            mask = (np.abs(image).sum(axis=1) > 0).astype(np.float32)
        out = {"pc": pc, "mask": mask}
        if text is not None:
            out["text_embed"] = text
        if image is not None:
            out["image_embed"] = image
        return out

    def close(self):
        for group in (self.pc, self.text or [], self.image or []):
            for r in group:
                r.close()


class StreamingLoader:
    """Deterministic, resumable, per-process streaming batch iterator.

    Args:
      corpus: a ShardedCorpus (or anything with __len__ + gather).
      global_batch_size: batch size summed over ALL processes; must be
        divisible by process_count.  The remainder of each epoch is
        dropped (fixed shapes).
      seed: epoch permutations are PRNG(seed, epoch) — identical on every
        process, so the rank-order concatenation of local slices equals
        the single-host batch stream.
      process_index/process_count: this process's rank and the number of
        processes; by default the torch.distributed rank and world size
        (0 and 1 without a process group).
      prefetch: batches assembled ahead by the background thread
        (0 = fully synchronous).
    """

    def __init__(self, corpus, global_batch_size: int, seed: int = 0,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 prefetch: int = 2):
        if process_index is None or process_count is None:
            from uni_adapter_torch.parallel.mesh import make_mesh

            world = make_mesh()
            process_index, process_count = world.rank, world.size
        if global_batch_size % process_count:
            raise ValueError(
                f"global batch {global_batch_size} not divisible by "
                f"{process_count} processes")
        if len(corpus) < global_batch_size:
            raise ValueError(
                f"corpus has {len(corpus)} samples < one global batch "
                f"({global_batch_size})")
        self.corpus = corpus
        self.global_batch_size = global_batch_size
        self.local_batch_size = global_batch_size // process_count
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.steps_per_epoch = len(corpus) // global_batch_size
        self._epoch = 0
        self._step = 0
        self._consumed_next = (0, 0)
        self._perm_epoch: Optional[int] = None
        self._perm: Optional[np.ndarray] = None
        self._thread: Optional[threading.Thread] = None
        self._q: Optional[queue.Queue] = None
        self._stop = threading.Event()

    # ---- deterministic schedule ----

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        if self._perm_epoch != epoch:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch]))
            self._perm = rng.permutation(len(self.corpus))
            self._perm_epoch = epoch
        return self._perm

    def _local_indices(self, epoch: int, step: int) -> np.ndarray:
        perm = self._epoch_perm(epoch)
        base = step * self.global_batch_size
        lo = base + self.process_index * self.local_batch_size
        return perm[lo:lo + self.local_batch_size]

    def _assemble(self, epoch: int, step: int) -> Dict[str, np.ndarray]:
        batch = self.corpus.gather(self._local_indices(epoch, step))
        batch["epoch"] = epoch
        batch["step"] = epoch * self.steps_per_epoch + step
        return batch

    # ---- resumable state ----

    def state_dict(self) -> Dict[str, int]:
        """Position of the next batch the CONSUMER will receive (batches
        sitting prefetched in the queue have not been consumed — a resume
        from this state re-produces them)."""
        if self._thread is not None:
            epoch, step = self._consumed_next
        else:
            epoch, step = self._epoch, self._step
        return {"epoch": epoch, "step": step, "seed": self.seed}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        if state.get("seed", self.seed) != self.seed:
            raise ValueError(
                f"resume seed {state['seed']} != loader seed {self.seed} — "
                "the schedules would diverge")
        self._drain()
        self._epoch = int(state["epoch"])
        self._step = int(state["step"])
        self._consumed_next = (self._epoch, self._step)

    def _advance(self) -> None:
        """Commit the cursor PAST the current position — called only after
        a successful assemble, so a transient gather failure never skips a
        batch (the retry re-assembles the same position)."""
        self._step += 1
        if self._step >= self.steps_per_epoch:
            self._step = 0
            self._epoch += 1

    # ---- iteration ----

    def __next__(self) -> Dict[str, np.ndarray]:
        if self.prefetch <= 0:
            batch = self._assemble(self._epoch, self._step)
            self._advance()
            return batch
        if self._thread is None:
            self._start_thread()
        item = self._q.get()
        if isinstance(item, BaseException):
            # the producer died on this exception without advancing past
            # the failed batch; reset to the consumer position so a retry
            # restarts a fresh thread at exactly the failed batch
            self._thread.join()
            self._thread = None
            self._q = None
            self._epoch, self._step = self._consumed_next
            raise item
        s = item["step"] + 1
        self._consumed_next = (s // self.steps_per_epoch,
                               s % self.steps_per_epoch)
        return item

    def __iter__(self):
        return self

    def take(self, n: int) -> List[Dict[str, np.ndarray]]:
        return [next(self) for _ in range(n)]

    # ---- prefetch plumbing ----

    def _start_thread(self) -> None:
        self._q = queue.Queue(maxsize=self.prefetch)
        self._stop.clear()
        self._consumed_next = (self._epoch, self._step)

        def work():
            # the shared cursor only moves here while the thread runs;
            # load_state_dict / __next__'s error path drain it first
            while not self._stop.is_set():
                try:
                    batch = self._assemble(self._epoch, self._step)
                except BaseException as e:  # surfaced on the consumer side
                    self._q.put(e)          # cursor NOT advanced: retryable
                    return
                self._advance()
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _drain(self) -> None:
        """Stop the prefetch thread and rewind the shared cursor to the
        consumer position: queued (and producer-held) batches are
        discarded, not lost — a later iteration re-assembles them."""
        if self._thread is None:
            return
        self._stop.set()
        while True:
            try:
                self._q.get(timeout=0.05)   # timed get: no busy spin while
            except queue.Empty:             # the producer finishes a gather
                if not self._thread.is_alive():
                    break
        self._thread.join()
        self._thread = None
        self._epoch, self._step = self._consumed_next
        self._q = None

    def close(self) -> None:
        self._drain()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def global_batch(local: Dict[str, np.ndarray], device) -> dict:
    """A process's local batch as tensors on `device` (its numpy arrays;
    the epoch/step bookkeeping ints pass through).  Over a world of
    processes the global batch is the rank-order concatenation of the
    ranks' rows, and this rank's slice of it is the rows its loader read:
    each rank contributes exactly those, nothing is replicated or re-read.
    So it takes no mesh (the JAX package's sharding of the global array
    is the process group's rank order here)."""
    import torch

    return {k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray)
            else v for k, v in local.items()}
