"""Multi-process bootstrap (a copy of `uni_adapter_tpu/parallel/bootstrap.py`
for `torch.distributed`).

Rank and world discovery from the launcher's environment, in the JAX
package's order of conventions (`LOCAL_RANK`/`RANK`/`WORLD_SIZE` as
`torch.distributed.run` sets them, then SLURM's, then Open MPI's), and
the process group.  A world of one process initialises nothing.

The backend follows from the device, and is logged:

  * `nccl` where every rank has a card of its own: the ranks on a host
    number no more than its cards, and rank `LOCAL_RANK` runs on
    `cuda:{LOCAL_RANK}`;
  * `gloo` for CPU ranks, and for ranks that share a card (more ranks on
    a host than cards: rank `LOCAL_RANK` on `cuda:{LOCAL_RANK % cards}`);
    gloo takes CUDA tensors, copying them through the host.

Nothing falls back: a failed `init_process_group` raises.
"""
from __future__ import annotations

import logging
import os
from typing import Tuple

import torch
import torch.distributed as dist

#: The launchers' (local rank, rank, world size) variables, in the order
#: they are read.
LAUNCHERS = (("LOCAL_RANK", "RANK", "WORLD_SIZE"),
             ("SLURM_LOCALID", "SLURM_PROCID", "SLURM_NTASKS"),
             ("OMPI_COMM_WORLD_LOCAL_RANK", "OMPI_COMM_WORLD_RANK",
              "OMPI_COMM_WORLD_SIZE"))
#: Each launcher's count of processes on this host.
LOCAL_WORLD = {"WORLD_SIZE": "LOCAL_WORLD_SIZE",
               "SLURM_NTASKS": "SLURM_NTASKS_PER_NODE",
               "OMPI_COMM_WORLD_SIZE": "OMPI_COMM_WORLD_LOCAL_SIZE"}


def world_info_from_env() -> Tuple[int, int, int]:
    """(local_rank, global_rank, world_size) from the launcher's
    environment; (0, 0, 1) without one."""
    for lr, r, w in LAUNCHERS:
        if r in os.environ and w in os.environ:
            return (int(os.environ.get(lr, 0)), int(os.environ[r]),
                    int(os.environ[w]))
    return 0, 0, 1


def local_world_size() -> int:
    """The processes the launcher started on this host (its whole world
    where it does not say)."""
    for _, r, w in LAUNCHERS:
        if r in os.environ and w in os.environ:
            return int(os.environ.get(LOCAL_WORLD[w], os.environ[w]))
    return 1


def backend_and_device(device: str, local_rank: int) -> tuple:
    """(backend, this rank's torch.device) for `device` 'cuda' or 'cpu'."""
    if device == "cpu":
        return "gloo", torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"unknown device {device!r}: expected cuda or cpu")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("--device cuda needs a CUDA GPU; pass --device "
                           "cpu to run the ranks on the CPU")
    if local_world_size() <= cards:
        return "nccl", torch.device("cuda", local_rank)
    return "gloo", torch.device("cuda", local_rank % cards)


def init_distributed_device(device: str = "cuda") -> dict:
    """Initialise the process group when launched as several processes
    (`MASTER_ADDR`/`MASTER_PORT`, 127.0.0.1:1234 by default); a world of
    one is a no-op.  Returns local_rank, rank, world_size, distributed and
    device_count (the JAX package's keys: the world's devices, one a
    rank), the backend (None in a world of one) and the rank's device."""
    local_rank, rank, world = world_info_from_env()
    backend, dev = None, None
    if world > 1:
        backend, dev = backend_and_device(device, local_rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if not dist.is_initialized():
            addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
            port = os.environ.get("MASTER_PORT", "1234")
            kw = {"device_id": dev} if backend == "nccl" else {}
            dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                                    world_size=world, rank=rank, **kw)
        logging.info("torch.distributed initialised: process %d/%d, backend "
                     "%s, device %s", rank, world, backend, dev)
    elif device == "cuda" and torch.cuda.is_available():
        dev = torch.device("cuda")
    elif device == "cpu":
        dev = torch.device("cpu")
    distributed = dist.is_initialized()
    return {"local_rank": local_rank,
            "rank": dist.get_rank() if distributed else 0,
            "world_size": dist.get_world_size() if distributed else 1,
            "distributed": distributed,
            "device_count": dist.get_world_size() if distributed else 1,
            "backend": dist.get_backend() if distributed else None,
            "device": dev}
