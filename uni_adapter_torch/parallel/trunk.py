"""Trunk (encoder) parallelism for the product entry points (mirror of
`uni_adapter_tpu/parallel/trunk.py`).

Shards the encoder for the configured `--trunk-parallel` mode over the
process group and returns the matching `encode_fn` for
`engine.make_step_fn` / `make_scan_fn` and `serve.TTAServer`.  The
adaptation loop itself stays replicated: only the encoder forward
changes.  Shared by the evaluation CLI (`cli/tta.py`) and the serving CLI
(`cli/serve.py`).  'tp' is tensor parallelism over the whole world
(`parallel/tp.py`); 'pp' pipeline stages over the first
`--trunk-stages` ranks (default: all), `--pp-interleave` chunks a stage
(`parallel/pp.py`), the ranks beyond them taking the trunk's output
from the last stage's broadcast (JAX's stage mesh of the first S
devices); 'sp' the trunk's tokens over the whole world, attention an
exact ring (`parallel/sp.py`; Uni3D and ULIP-2).
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
    kind = cfg.model.vlm3d
    if mode == "sp":
        from uni_adapter_torch.parallel.sp import make_sp_encode_fn

        # the JAX branch raises outside its wrapper: no shape divides here
        prepared = make_sp_encode_fn(model, kind, world.group)
        logging.info("trunk parallelism: sequence (ring attention), %d-way",
                     world.size)
        return prepared
    if mode == "pp":
        from uni_adapter_torch.parallel.pp import make_pp_encode_fn, \
            make_stages

        stages = make_stages(cfg.run.trunk_stages, world)
        size = stages.n

        def prepare():
            return make_pp_encode_fn(model, stages, kind,
                                     interleave=cfg.run.pp_interleave)
        what = ("pipeline, %d stages x %d chunks/stage", stages.n,
                cfg.run.pp_interleave)
    elif mode == "tp":
        from uni_adapter_torch.parallel.tp import make_tp_encode_fn

        size = world.size

        def prepare():
            return make_tp_encode_fn(model, world.group, kind)
        what = ("tensor (Megatron), %d-way", world.size)
    else:
        raise ValueError(mode)
    try:
        prepared = prepare()
    except ValueError as e:
        raise ValueError(
            f"--trunk-parallel {mode}: the model's shapes don't divide "
            f"over the {size}-device mesh ({e}).  Pick "
            "dimensions divisible by the device count — MLP hidden size "
            "and head count for tp, trunk depth (x --pp-interleave) for "
            "pp.") from e
    logging.info("trunk parallelism: " + what[0], *what[1:])
    return prepared
