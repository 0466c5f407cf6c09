"""Trunk (encoder) parallelism for the product entry points (mirror of
`uni_adapter_tpu/parallel/trunk.py`).

Shards the encoder for the configured `--trunk-parallel` mode over the
process group and returns the matching `encode_fn` for
`engine.make_step_fn` / `make_scan_fn` and `serve.TTAServer`.  The
adaptation loop itself stays replicated: only the encoder forward
changes.  Shared by the evaluation CLI (`cli/tta.py`) and the serving CLI
(`cli/serve.py`).  'tp' is tensor parallelism over the whole world
(`parallel/tp.py`); 'pp' and 'sp' raise NotImplementedError by name
until their ROADMAP items land.
"""
from __future__ import annotations

import logging

from uni_adapter_torch.parallel import mesh as pmesh


def prepare_trunk_parallel(cfg, model, group=None):
    """Shard the encoder trunk per `cfg.run.trunk_parallel` over `group`
    (default: the world, the initialised process group or this process
    alone) and return (this rank's module, encode_fn).  A model whose
    shapes do not divide over the group raises the JAX package's
    ValueError."""
    mode = cfg.run.trunk_parallel
    world = pmesh.make_mesh(group)
    if mode in ("pp", "sp"):
        raise NotImplementedError(
            f"--trunk-parallel {mode} is not ported yet (ROADMAP M16)")
    if mode != "tp":
        raise ValueError(mode)
    from uni_adapter_torch.parallel.tp import make_tp_encode_fn

    try:
        prepared = make_tp_encode_fn(model, world.group, cfg.model.vlm3d)
    except ValueError as e:
        raise ValueError(
            f"--trunk-parallel {mode}: the model's shapes don't divide "
            f"over the {world.size}-device mesh ({e}).  Pick "
            "dimensions divisible by the device count — MLP hidden size "
            "and head count for tp, trunk depth (x --pp-interleave) for "
            "pp.") from e
    logging.info("trunk parallelism: tensor (Megatron), %d-way", world.size)
    return prepared
