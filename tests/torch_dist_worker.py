"""The rank side of the port's two-process tests, and their launcher.

    python tests/torch_dist_worker.py PROGRAM RANK WORLD DIR

joins a gloo process group through a file under DIR (the launcher's
environment variables set as `torch.distributed.run` sets them), reads
DIR/inputs.pt, runs every case of PROGRAM in this process, one after
the other, and writes {case: result} to DIR/rank{RANK}.pt.  A case that
raises stores its traceback instead (`error`), so the other cases still
report; the test that reads it fails.  The worker imports PyTorch and
the port only (no JAX), with one intra-op thread.

`start_world` is the launcher and `collect` reads what the ranks wrote:
a test module runs its world of two once, from a module fixture, and
does its JAX side while the ranks run.
"""
from __future__ import annotations

import functools
import os
import subprocess
import sys
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve()


def start_world(program: str, inputs: dict, tmp: Path,
                world: int = 2) -> list:
    """Write `inputs` and start PROGRAM's `world` ranks; returns their
    processes."""
    import torch

    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, tmp / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, str(WORKER), program, str(r), str(world), str(tmp)],
        env=env, cwd=str(tmp), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def collect(procs: list, tmp: Path, timeout: float = 50.0) -> list:
    """Wait for the ranks and return each one's {case: result}.  Fails
    with the ranks' output if one exits non-zero or the world outlasts
    `timeout` seconds."""
    import torch

    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"a rank exited with {p.returncode}:\n{out}\n"
                               f"{err}")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(len(procs))]


def run_cases(cases: dict) -> dict:
    """Each case's result, or {"error": its traceback}."""
    results = {}
    for name, case in cases.items():
        try:
            results[name] = case()
        except Exception:
            results[name] = {"error": traceback.format_exc()}
    return results


# --------------------------------------------------------------------------
# the programs
# --------------------------------------------------------------------------

def _fed(scan_fn, noises):
    """`scan_fn` with its step's noise taken from `noises` in turn (the
    JAX run's draws), its encoder and process group kept."""
    import torch

    from uni_adapter_torch import engine

    step, it = scan_fn.step, iter(noises)
    scan_fn.step = engine.Step(
        lambda t, s, b, noise=None: step.parts(
            t, s, b, torch.from_numpy(next(it))), step.group)
    return scan_fn


def _fed_scan(cfg, model, noises, group=None):
    """A scan whose step takes its noise from `noises` in turn, keeping
    the step's process group."""
    from uni_adapter_torch import engine

    return _fed(engine.make_scan_fn(cfg, model, axis_name=group), noises)


def _state_arrays(state) -> dict:
    return {name: getattr(state.method_state, name).numpy()
            for name in state.method_state._fields}


def parallel_program(inputs: dict, rank: int) -> dict:
    """The stream modes of `parallel/mesh.py` (tests/test_torch_parallel.py)."""
    import torch

    from uni_adapter_torch import engine
    from uni_adapter_torch.cli import tta
    from uni_adapter_torch.models.uni3d import create_uni3d
    from uni_adapter_torch.parallel import mesh as pmesh

    cfgs = inputs["cfgs"]
    model = create_uni3d(cfgs["dota"].model, "cpu",
                         state_dict=inputs["state_dict"])
    text = torch.from_numpy(inputs["text"])
    pcs, rgbs, targets = inputs["stream"]
    world = pmesh.make_mesh()

    def sharded(method):
        def case():
            scan_fn = (_fed_scan(cfgs[method], model,
                                 inputs["noise_sharded"][rank])
                       if method == "mode" else None)
            state, summary = pmesh.run_stream_sharded(
                cfgs[method], model, text, pcs, rgbs, targets, seed=42,
                scan_fn=scan_fn)
            return {"summary": summary, "state": _state_arrays(state),
                    "world": tuple(world[:2])}
        return case

    def streams():
        spcs, srgbs, stgts = inputs["streams"]
        state, summary = pmesh.run_streams_sharded(
            cfgs["mode"], model, text, spcs, srgbs, stgts, seed=42,
            scan_fn=_fed_scan(cfgs["mode"], model,
                              inputs["noise_streams"][rank]))
        return {"summary": summary, "state": _state_arrays(state)}

    def psum(method):
        def case():
            init = engine.init_state
            if method == "gmm":
                # JAX's GMM init (its PRNG draw) injected on every rank
                def injected(cfg, text_init, seed=42):
                    s = init(cfg, text_init, seed)
                    s.method_state = type(s.method_state)(*(
                        torch.from_numpy(inputs["gmm_init"][f])
                        for f in s.method_state._fields))
                    return s
                engine.init_state = injected
            try:
                scan_fn = (_fed_scan(cfgs[method], model,
                                     inputs["noise_psum"][rank], world.group)
                           if method == "mode" else None)
                state, summary = pmesh.run_stream_psum(
                    cfgs[method], model, text, pcs, rgbs, targets, seed=42,
                    scan_fn=scan_fn)
            finally:
                engine.init_state = init
            return {"summary": summary, "state": _state_arrays(state)}
        return case

    def cli_sharded():
        built = tta.build_backbone
        tta.build_backbone = lambda *a, **k: (model, None, None)
        try:
            return tta.main(inputs["cli_argv"])["acc1"]
        finally:
            tta.build_backbone = built

    return run_cases({
        "sharded_dota": sharded("dota"), "sharded_mode": sharded("mode"),
        "streams_sharded": streams,
        **{f"psum_{m}": psum(m) for m in ("dota", "mode", "gmm",
                                          "adaptive")},
        "cli_sharded": cli_sharded})


def dp_train_program(inputs: dict, rank: int) -> dict:
    """The data-parallel train step, the loader's rows by rank and the
    two-rank pretraining CLI (tests/test_torch_dp_train.py)."""
    import torch

    from uni_adapter_torch import train
    from uni_adapter_torch.cli import pretrain
    from uni_adapter_torch.data.streaming import (ShardedCorpus,
                                                  StreamingLoader)
    from uni_adapter_torch.models.uni3d import Uni3D
    from uni_adapter_torch.parallel.mesh import make_mesh

    def dp_steps():
        model = Uni3D(**inputs["widths"], dtype=torch.float32)
        model.load_state_dict(inputs["state_dict"])
        model.requires_grad_(True)
        tx = train.make_optimizer(**inputs["optimizer"])
        state = train.init_train_state(model, tx)
        step = train.make_dp_train_step(model, tx, make_mesh())
        metrics = []
        for b in inputs["batches"]:
            rows = slice(rank * len(b["pc"]) // 2,
                         (rank + 1) * len(b["pc"]) // 2)
            state, m = step(state, *(torch.from_numpy(b[k][rows])
                                     for k in ("pc", "text", "image",
                                               "mask")))
            metrics.append({k: v.item() for k, v in m.items()})
        return {"metrics": metrics,
                "params": {n: p.detach().numpy().copy()
                           for n, p in state.params.items()},
                "logit_scale": state.logit_scale.item()}

    def loader_rows():
        corpus = ShardedCorpus(*inputs["shards"])
        loader = StreamingLoader(corpus, 8, seed=3, prefetch=0)
        return {"index": (loader.process_index, loader.process_count),
                "batches": [next(loader) for _ in range(3)]}

    def cli():
        out = {}
        for name, argv in inputs["cli_runs"]:
            state = pretrain.main(argv)
            out[name] = {"step": state.step,
                         "params": {n: p.detach().numpy().copy()
                                    for n, p in state.params.items()},
                         "logit_scale": state.logit_scale.item()}
        return out

    return run_cases({"dp_steps": dp_steps, "loader_rows": loader_rows,
                      "cli": cli})


def _ep_fed_scan(cfg, model, shard, noises, shard_encoder=False):
    """The class-sharded scan whose MODE-DOTA step takes its noise from
    `noises` in turn (JAX's draws)."""
    from uni_adapter_torch.parallel import ep

    return _fed(ep.make_ep_scan_fn(cfg, model, shard, shard_encoder), noises)


def _full_state(state) -> dict:
    """A carry's tensors by name ('mu', ..., 'res.residuals'), and its
    step count."""
    out = {name: getattr(state.method_state, name).numpy()
           for name in state.method_state._fields}
    if state.res_state is not None:
        out.update({f"res.{n}": getattr(state.res_state, n).numpy()
                    for n in state.res_state._fields})
    out["step"] = state.step
    return out


def _patched_cli(tta, model, corruptions):
    """`tta.main` on `model`'s weights over `corruptions` only."""
    def run(argv):
        built, corrs = tta.build_backbone, tta.CORRUPTIONS
        tta.build_backbone = lambda *a, **k: (model, None, None)
        tta.CORRUPTIONS = corruptions
        try:
            return tta.main(argv)
        finally:
            tta.build_backbone, tta.CORRUPTIONS = built, corrs
    return run


def ep_program(inputs: dict, rank: int) -> dict:
    """Class-sharded MODE-DOTA, the residual loop's gradient, the CLI and
    DP × EP (tests/test_torch_ep.py)."""
    import torch

    from uni_adapter_torch import engine
    from uni_adapter_torch.adapt import mode_dota, residual
    from uni_adapter_torch.cli import tta
    from uni_adapter_torch.models.uni3d import create_uni3d
    from uni_adapter_torch.parallel import ep
    from uni_adapter_torch.parallel import mesh as pmesh

    model = create_uni3d(inputs["model_cfg"], "cpu",
                         state_dict=inputs["state_dict"])
    world = pmesh.make_mesh()

    def stream_case(name):
        def case():
            c = inputs["cases"][name]
            text = torch.from_numpy(c["text"])
            shard = ep.class_shard(world, text.shape[0])
            out, carry, rcarry = {}, None, None
            for part, (pcs, rgbs, tgts, noise, se) in enumerate(c["runs"]):
                scan_fn = _ep_fed_scan(c["cfg"], model, shard, noise, se)
                carry, summary = ep.run_stream_ep(
                    c["cfg"], model, text, pcs, rgbs, tgts, seed=42,
                    shard_encoder=se, scan_fn=scan_fn, initial_state=carry)
                out[part] = {"state": _full_state(carry), "summary": summary}
                if rank == 0:       # the replicated run, one process
                    rcarry, _ = engine.run_stream_scan(
                        c["cfg"], model, text, pcs, rgbs, tgts, seed=42,
                        initial_state=rcarry,
                        scan_fn=_fed_scan(c["cfg"], model, noise))
                    out[part]["replicated"] = _full_state(rcarry)
            return out
        return case

    def grad_parity():
        g = inputs["grad"]
        K, M = g["K"], g["M"]
        shard = ep.class_shard(world, K)
        rows = slice(shard.offset, shard.offset + shard.k_local)
        t = {k: torch.from_numpy(v[rows]) for k, v in g["padded"].items()}
        mix = mode_dota.ModeDotaState(t["mu"], t["var"], t["pi"], t["c"],
                                      t["cc"], torch.zeros((), dtype=torch.int32))
        z = torch.zeros_like(t["res"])
        rs = residual.ResidualState(t["res"], z, z.clone(),
                                    torch.zeros((), dtype=torch.int32))
        out = engine.drive(ep.optimize_residuals_sharded(
            rs, t["text"], mix, 1e-3, 1e-3, shard, num_steps=1),
            shard.group)
        return out.residuals.numpy()

    def dp_ep():
        d = inputs["dp_ep"]
        grid = ep.make_grid(2)
        shard = ep.ClassShard(grid.cls_group, grid.cls_rank, grid.n_cls,
                              d["text"].shape[0])
        scan_fn = _ep_fed_scan(d["cfg"], model, shard,
                               d["noise"][grid.data_index])
        state, summary = ep.run_streams_ep(
            d["cfg"], model, torch.from_numpy(d["text"]), *d["streams"],
            grid=grid, seed=42, scan_fn=scan_fn)
        return {"summary": summary, "mu": state.method_state.mu.numpy(),
                "grid": tuple(grid[:4])}

    def cli(name):
        def case():
            return _patched_cli(tta, model, inputs["cli_corruptions"])(
                inputs["cli"][name])
        return case

    if world.size == 4:
        return run_cases({"dp_ep": dp_ep})
    return run_cases({
        **{name: stream_case(name) for name in inputs["cases"]},
        "grad_parity": grad_parity,
        **{f"cli_{name}": cli(name) for name in inputs["cli"]}})


def ep_methods_program(inputs: dict, rank: int) -> dict:
    """The other methods class-sharded (tests/test_torch_ep_methods.py):
    each case's stream through `run_stream_ep` from the given full-K
    initial state (JAX's GMM init) or a fresh one."""
    import torch

    from uni_adapter_torch import engine
    from uni_adapter_torch.models.uni3d import create_uni3d
    from uni_adapter_torch.parallel import ep

    model = create_uni3d(inputs["model_cfg"], "cpu",
                         state_dict=inputs["state_dict"])

    def case(c):
        def run():
            text = torch.from_numpy(c["text"])
            init = None
            if c.get("init") is not None:
                fresh = engine.init_state(c["cfg"], text, 42)
                init = engine.EngineState(type(fresh.method_state)(*(
                    torch.from_numpy(c["init"][f])
                    for f in fresh.method_state._fields)), None, 0,
                    fresh.generator)
            out, rcarry = {}, init
            for part, (pcs, rgbs, tgts) in enumerate(c["runs"]):
                state, summary = ep.run_stream_ep(
                    c["cfg"], model, text, pcs, rgbs, tgts, seed=42,
                    initial_state=init)
                init = state
                out[part] = {"state": _full_state(state), "summary": summary}
                if rank == 0:       # the replicated run, one process
                    rcarry, _ = engine.run_stream_scan(
                        c["cfg"], model, text, pcs, rgbs, tgts, seed=42,
                        initial_state=rcarry)
                    out[part]["replicated"] = _full_state(rcarry)
            return out
        return run

    return run_cases({name: case(c) for name, c in inputs["cases"].items()})


def ep_serve_program(inputs: dict, rank: int) -> dict:
    """`TTAServer(dist_mode='ep')` over two ranks, and the serve CLI's
    EP front end over HTTP (tests/test_torch_ep_serve.py).  Rank 0 drives
    each server; rank 1 follows it."""
    import numpy as np
    import torch

    from uni_adapter_torch import serve
    from uni_adapter_torch.cli import serve as serve_cli
    from uni_adapter_torch.client import TTAClient
    from uni_adapter_torch.models.uni3d import create_uni3d
    from uni_adapter_torch.parallel import ep

    model = create_uni3d(inputs["model_cfg"], "cpu",
                         state_dict=inputs["state_dict"])
    text = torch.from_numpy(inputs["text"])
    streams = inputs["streams"]

    def server():
        srv = serve.TTAServer(inputs["cfg"], model, text, dist_mode="ep")
        if not srv.primary:
            serve.follow(srv)
            return {"followed": True}
        out = {"sizes": srv.sizes, "ticks": []}
        for cid in ("a", "b"):
            srv.register(cid)
        for t in range(2):
            out["ticks"].append(srv.submit(
                [(cid, streams[i, t], None)
                 for i, cid in enumerate(("a", "b"))]))
        path = inputs["snapshot"]
        srv.snapshot("a", path)
        srv.restore("c", path)           # a new client from a's snapshot
        t = 2
        out["ticks"].append(srv.submit(
            [("a", streams[0, t], None), ("b", streams[1, t], None),
             ("c", streams[0, t], None)]))
        try:
            srv.submit([("nobody", streams[0, 0], None)])
            out["refused"] = None
        except KeyError as e:
            out["refused"] = str(e)
        for cid, p in inputs["final_snapshots"].items():
            srv.snapshot(cid, p)
        srv.stop()
        return out

    def faults():
        """Restores that fail on every rank (a missing snapshot for a
        known and for a new client, an unreadable one), then a step and a
        snapshot, which need rank 1 still following."""
        srv = serve.TTAServer(inputs["cfg"], model, text, dist_mode="ep")
        if not srv.primary:
            serve.follow(srv)
            return {"followed": True}
        srv.register("a")
        errors = []
        for cid, path in (("a", inputs["missing"]), ("z", inputs["missing"]),
                          ("a", inputs["garbled"])):
            try:
                srv.restore(cid, path)
                errors.append(None)
            except Exception as e:
                errors.append(type(e).__name__)
        logits = srv.submit([("a", streams[0, 0], None)])["a"]
        srv.snapshot("a", inputs["fault_snapshot"])
        srv.stop()
        return {"errors": errors, "logits": logits,
                "clients": sorted(srv.states)}

    def by_stream():
        """Each client's stream through `run_stream_ep` alone."""
        out = {}
        for i in range(2):
            pcs = streams[i, :3]
            st, _ = ep.run_stream_ep(inputs["cfg"], model, text, pcs,
                                     np.ones_like(pcs),
                                     np.zeros(pcs.shape[:2], np.int64),
                                     seed=42 + i)
            out[i] = _full_state(st)
        return out

    def http():
        from uni_adapter_torch.models import loader

        built = loader.build_backbone
        loader.build_backbone = lambda *a, **k: (model, None, None)
        try:
            http_srv = serve_cli.main([*inputs["serve_argv"], "--port", "0"])
        finally:
            loader.build_backbone = built
        if http_srv is None:
            return {"followed": True}
        try:
            c = TTAClient("127.0.0.1", http_srv.port, "x")
            c.register()
            logits = [c.submit(streams[0, t]) for t in range(2)]
            health = c.healthz()
        finally:
            http_srv.close()
            http_srv.server.stop()
        return {"logits": logits, "health": health}

    return run_cases({"server": server, "faults": faults,
                      "by_stream": by_stream, "http": http})


def _counted(forward, *inputs) -> tuple:
    """A parts forward's output and its collectives' kinds, each issued
    over its own group."""
    from uni_adapter_torch.parallel import collectives

    parts, kinds = forward(*inputs), []
    try:
        while True:
            req = next(parts)
            kinds.append(req.kind)
            collectives.issue(req, None)
    except StopIteration as done:
        return done.value, kinds


def tp_program(inputs: dict, rank: int) -> dict:
    """The tensor-parallel trunk (tests/test_torch_tp.py): each backbone's
    forward at worlds 2 and 4, its shards and collectives, the MODE-DOTA
    trajectory (world 2), DP × TP and EP × TP on 2 × 2 grids and the
    indivisible widths' error (world 4)."""
    import torch

    from uni_adapter_torch import engine
    from uni_adapter_torch.models import pointbert, ppta, uni3d
    from uni_adapter_torch.parallel import ep, tp, trunk
    from uni_adapter_torch.parallel import mesh as pmesh

    world = pmesh.make_mesh()
    t = torch.from_numpy

    def build(kind, dims, state_dict):
        if kind.startswith("uni3d"):
            m = uni3d.Uni3D(**dims, dtype=torch.float32)
        elif kind == "ulip":
            m = pointbert.ULIP(**dims, dtype=torch.float32)
        else:
            m = ppta.Projected(ppta.PPTAPreset(**dims["preset"]),
                               dims["out"], dtype=torch.float32,
                               rel_pe=dims["rel_pe"])
        m.load_state_dict(state_dict)
        return m.eval().requires_grad_(False)

    models = {k: build(k, *inputs["models"][k]) for k in inputs["models"]}

    def forward(kind):
        def case():
            rank_model = tp.shard_model_tp(models[kind], world.group)
            with torch.no_grad():
                feat, kinds = _counted(
                    tp.make_tp_forward(rank_model, world.group),
                    *(t(x) for x in inputs["clouds"][kind]))
            return {"feat": feat.numpy(), "collectives": kinds,
                    "shapes": {n: tuple(p.shape) for n, p in
                               rank_model.named_parameters()},
                    "params": {n: p.numpy().copy() for n, p in
                               rank_model.named_parameters()
                               if n.endswith("blocks.0.attn.qkv.weight")}}
        return case

    def trajectory():
        c = inputs["trajectory"]
        model = build("uni3d", inputs["models"]["uni3d"][0],
                      c["state_dict"])
        rank_model, encode = tp.make_tp_encode_fn(model, world.group,
                                                  "uni3d")
        scan_fn = _fed(engine.make_scan_fn(c["cfg"], rank_model,
                                           encode_fn=encode), c["noise"])
        _, outs = engine.run_stream_scan(c["cfg"], rank_model,
                                         t(c["text"]), *c["stream"],
                                         seed=42, scan_fn=scan_fn)
        # the replicated run, one process
        _, rep = engine.run_stream_scan(
            c["cfg"], model, t(c["text"]), *c["stream"], seed=42,
            scan_fn=_fed(engine.make_scan_fn(c["cfg"], model), c["noise"]))
        return {"final_logits": outs.final_logits.numpy(),
                "correct": outs.correct.numpy(),
                "replicated": rep.final_logits.numpy(),
                "replicated_correct": rep.correct.numpy()}

    def dp_tp():
        grid = tp.make_tp_grid(2)
        rank_model = tp.shard_model_tp(models["uni3d"], grid.model_group)
        fwd = tp.make_tp_forward(rank_model, grid.model_group,
                                 data_group=grid.outer_group)
        with torch.no_grad():
            feat, kinds = _counted(fwd, t(inputs["dp_clouds"]))
        return {"feat": feat.numpy(), "collectives": kinds,
                "grid": tuple(grid[:4])}

    def ep_tp(name):
        def case():
            c = inputs["ep_tp"][name]
            grid = tp.make_tp_grid(2)
            rank_model, encode = tp.make_tp_encode_fn(
                models["uni3d"], grid.model_group, "uni3d")
            shard = ep.class_shard(grid.outer_world, c["text"].shape[0])
            scan_fn = ep.make_ep_scan_fn(c["cfg"], rank_model, shard,
                                         encode_fn=encode)
            if c["noise"] is not None:
                scan_fn = _fed(scan_fn, c["noise"])
            state, summary = ep.run_stream_ep(
                c["cfg"], rank_model, t(c["text"]), *c["stream"],
                mesh=grid.outer_world, seed=42, scan_fn=scan_fn)
            return {"state": _full_state(state), "summary": summary}
        return case

    def indivisible():
        try:
            trunk.prepare_trunk_parallel(inputs["tp_cfg"],
                                         models["uni3d_odd"])
        except ValueError as e:
            return str(e)
        return None

    cases = {f"forward_{k}": forward(k) for k in ("uni3d", "ulip",
                                                  "openshape")}
    if world.size == 2:
        cases["trajectory"] = trajectory
    else:
        cases.update({"dp_tp": dp_tp, "ep_tp_mode": ep_tp("mode"),
                      "ep_tp_cache": ep_tp("cache"),
                      "indivisible": indivisible})
    return run_cases(cases)


def tp_cli_program(inputs: dict, rank: int) -> dict:
    """`--trunk-parallel tp` through the CLI, with int8 layers, and
    `TTAServer(encode_fn=...)` at world 2, with the indivisible heads'
    error (tests/test_torch_tp_cli.py).  Rank 0 serves; rank 1 follows."""
    import torch
    import torch.distributed as dist

    from uni_adapter_torch import serve
    from uni_adapter_torch.cli import tta
    from uni_adapter_torch.models.uni3d import create_uni3d
    from uni_adapter_torch.parallel import tp, trunk

    models = {name: create_uni3d(mcfg, "cpu", state_dict=sd)
              for name, (mcfg, sd) in inputs["models"].items()}

    def cli(name):
        def case():
            argv, model = inputs["cli"][name]
            return _patched_cli(tta, models[model],
                                inputs["cli_corruptions"])(argv)
        return case

    def server():
        rank_model, encode = tp.make_tp_encode_fn(
            models["small"], dist.group.WORLD, "uni3d")
        srv = serve.TTAServer(inputs["cfg"], rank_model,
                              torch.from_numpy(inputs["text"]),
                              sizes=(1, 2), encode_fn=encode)
        if not srv.primary:
            serve.follow(srv)
            return {"followed": True}
        streams = inputs["streams"]
        for cid in ("a", "b"):
            srv.register(cid)
        ticks = [srv.submit([(cid, streams[i, s], None)
                             for i, cid in enumerate(("a", "b"))])
                 for s in range(2)]
        ticks.append(srv.submit([("a", streams[0, 2], None)]))
        srv.snapshot("a", inputs["snapshot"])
        srv.restore("c", inputs["snapshot"])
        last = srv.submit([("a", streams[0, 3], None),
                           ("c", streams[0, 3], None)])
        srv.stop()
        return {"ticks": ticks, "last": last}

    def indivisible():
        try:
            trunk.prepare_trunk_parallel(inputs["tp_cfg"], models["odd"])
        except ValueError as e:
            return str(e)
        return None

    return run_cases({**{f"cli_{n}": cli(n) for n in inputs["cli"]},
                      "server": server, "indivisible": indivisible})


def _logged(forward, *inputs) -> tuple:
    """A parts forward's output and its requests as (kind, bytes sent,
    shape sent) — a shift's sent buffer, a sum's or broadcast's buffer —
    each issued over its own group."""
    from uni_adapter_torch.parallel import collectives

    parts, log = forward(*inputs), []
    try:
        while True:
            req = next(parts)
            buf = req.buf
            log.append((req.kind,
                        0 if buf is None else buf.numel() * buf.element_size(),
                        None if buf is None else tuple(buf.shape)))
            collectives.issue(req, None)
    except StopIteration as done:
        return done.value, log


def build_pp_model(kind: str, dims: dict, dtype: str, state_dict):
    """A frozen port backbone of the PP tests on the CPU: `kind` uni3d,
    ulip or openshape at `dims`, its weights `state_dict` (None: random
    from seed 0) stored as `finish_model` stores them in `dtype`."""
    import torch

    from uni_adapter_torch.models import pointbert, ppta, uni3d
    from uni_adapter_torch.models.common import finish_model

    dt = getattr(torch, dtype)
    if kind == "uni3d":
        m = uni3d.Uni3D(**dims, dtype=dt)
    elif kind == "ulip":
        m = pointbert.ULIP(**dims, dtype=dt)
    else:
        m = ppta.Projected(ppta.PPTAPreset(**dims["preset"]), dims["out"],
                           dtype=dt, rel_pe=dims["rel_pe"])
    return finish_model(m, "cpu", dt, 0, state_dict, lambda g: None,
                        keep_fp32=(m.proj,) if kind == "openshape" else ())


def pp_program(inputs: dict, rank: int) -> dict:
    """The pipeline-parallel trunk (tests/test_torch_pp.py and
    tests/test_torch_pp_interleave.py): the cases of `inputs["cases"]`
    whose world is this one, each on a (stage, model, data) grid of the
    world (`pp.make_pp_grid`): forwards with their requests, gradients,
    train steps, MODE-DOTA trajectories, the stages' blocks, errors and
    the toy executors."""
    import torch
    import torch.distributed as dist

    from uni_adapter_torch import engine, train
    from uni_adapter_torch.parallel import pp

    world = dist.get_world_size()
    t = torch.from_numpy

    def build(name):
        return build_pp_model(*inputs["models"][name])

    def grid_of(c):
        return pp.make_pp_grid(c["S"], c.get("tp", 1), c.get("dp", 1))

    def forward_of(c, model, grid):
        return pp.make_pp_forward(
            model, grid.stages, c.get("n_micro"), data_group=grid.data_group,
            tp_group=grid.model_group, interleave=c.get("V", 1))

    def forward(c):
        grid = grid_of(c)
        model = build(c["model"])
        _, fwd = forward_of(c, model, grid)
        with torch.no_grad():
            feat, log = _logged(fwd, *(t(x) for x in c["inputs"]))
            plain = model(*(t(x) for x in c["inputs"])) if c.get(
                "plain") else None
        return {"feat": feat.float().numpy(), "log": log,
                "plain": None if plain is None else plain.float().numpy()}

    def grad(c):
        grid = grid_of(c)
        model = build(c["model"]).requires_grad_(True)
        rank_model, fwd = forward_of(c, model, grid)
        with torch.enable_grad():
            out = engine.drive(fwd(*(t(x) for x in c["inputs"])), None)
            names = [n for n, _ in rank_model.named_parameters()]
            gs = torch.autograd.grad((out * t(c["ct"])).sum(),
                                     list(rank_model.parameters()),
                                     allow_unused=True)
        return {"grads": {n: None if g is None else g.numpy()
                          for n, g in zip(names, gs)}}

    def train_steps(c):
        grid = grid_of(c)
        model = build(c["model"]).requires_grad_(True)
        tx = train.make_optimizer(**c["optimizer"])
        rank_model, step = pp.make_pp_train_step(
            model, tx, grid.stages, c.get("n_micro"),
            tp_group=grid.model_group, data_group=grid.data_group,
            interleave=c.get("V", 1))
        state = train.init_train_state(rank_model, tx)
        metrics = []
        for b in c["batches"]:
            state, m = step(state, *(t(x) for x in b))
            metrics.append({k: v.item() for k, v in m.items()})
        full = pp.gather_train_state(state, rank_model, grid.model_group)
        return {"metrics": metrics,
                "params": {n: p.detach().numpy().copy()
                           for n, p in state.params.items()},
                "full": None if full is None else {
                    n: p.numpy() for n, p in full.params.items()},
                "logit_scale": state.logit_scale.item()}

    def trajectory(c):
        stages = pp.make_stages(c["S"])
        model = build(c["model"])
        rank_model, encode = pp.make_pp_encode_fn(
            model, stages, c["kind"], interleave=c.get("V", 1))
        scan_fn = _fed(engine.make_scan_fn(c["cfg"], rank_model,
                                           encode_fn=encode), c["noise"])
        _, outs = engine.run_stream_scan(c["cfg"], rank_model, t(c["text"]),
                                         *c["stream"], seed=42,
                                         scan_fn=scan_fn)
        out = {"final_logits": outs.final_logits.numpy(),
               "correct": outs.correct.numpy()}
        if c.get("replicated"):         # the same run in this one process
            _, rep = engine.run_stream_scan(
                c["cfg"], model, t(c["text"]), *c["stream"], seed=42,
                scan_fn=_fed(engine.make_scan_fn(c["cfg"], model),
                             c["noise"]))
            out.update(replicated=rep.final_logits.numpy(),
                       replicated_correct=rep.correct.numpy())
        return out

    def blocks(c):
        grid = grid_of(c)
        rank_model = pp.shard_model_pp(build(c["model"]), grid.stages,
                                       c.get("V", 1))
        return {"params": {n: p.numpy().copy() for n, p in
                           rank_model.named_parameters()},
                "decay": train.decay_mask(rank_model),
                "stage": grid.stages.index}

    def error(c):
        try:
            grid = grid_of(c)
            _, fwd = forward_of(c, build(c["model"]), grid)
            with torch.no_grad():
                engine.drive(fwd(*(t(x) for x in c["inputs"])), None)
        except ValueError as e:
            return str(e)
        return None

    def toy(c):
        S, V, M, Lc = c["S"], c["V"], c["M"], c["Lc"]
        W = t(c["W"])
        stages = pp.make_stages(S)
        chunks = []
        for blocks_ in pp.stage_blocks(S * V * Lc, S, stages.index, V):
            def chunk(x, e, ws=[W[i] for i in blocks_]):
                for w in ws:
                    x = x @ w + e
                return x
                yield
            chunks.append(chunk)
        xs, ex = t(c["xs"]), t(c["ex"])
        if V > 1:
            from uni_adapter_torch.parallel.pp_interleave import (
                build_interleaved_schedule, pipeline_interleaved)
            gen = pipeline_interleaved(
                chunks, xs, build_interleaved_schedule(S, V, M),
                stages.ring, ex)
        else:
            gen = pp._pipeline(chunks, xs, stages.ring, ex)
        outs, log = _logged(lambda: gen)
        out = pp._stacked(outs, xs)
        if stages.group is not None:
            dist.broadcast(out, src=S - 1, group=stages.group)
        return {"out": out.numpy(), "n_shifts": sum(k == "shift"
                                                    for k, *_ in log)}

    def ring(c):
        """`ring_shift` and `broadcast_from` on this rank's tensor r·1, with
        the cotangent (r + 1)·1: their values and gradients."""
        from uni_adapter_torch.parallel import collectives

        r = dist.get_rank()
        x = torch.full((2, 3), float(r), requires_grad=True)
        out = {}
        for name, y in (("shift", collectives.ring_shift(x, dist.group.WORLD)),
                        ("broadcast", collectives.broadcast_from(
                            x, c["src"], dist.group.WORLD))):
            g, = torch.autograd.grad((y * (r + 1)).sum(), x)
            out[name] = (y.detach().numpy(), g.numpy())
        return out

    kinds = {"forward": forward, "grad": grad, "train": train_steps,
             "trajectory": trajectory, "blocks": blocks, "error": error,
             "toy": toy, "ring": ring}
    return run_cases({c["name"]: functools.partial(kinds[c["type"]], c)
                      for c in inputs["cases"] if c["world"] == world})


def trunk_cli_program(inputs: dict, rank: int) -> dict:
    """`--trunk-parallel pp` or `sp` (`inputs["trunk"]`, default pp)
    through the TTA CLI, `TTAServer(encode_fn=...)` with the trunk's
    encoder, the trunk's errors, and `--parallel pp` or `sp` through the
    pretraining CLI, uninterrupted and resumed (tests/test_torch_pp_cli.py,
    tests/test_torch_sp_cli.py).  Rank 0 serves; rank 1 follows."""
    import dataclasses

    import torch

    from uni_adapter_torch import serve
    from uni_adapter_torch.cli import pretrain, tta
    from uni_adapter_torch.models.uni3d import create_uni3d
    from uni_adapter_torch.parallel import trunk

    models = {name: create_uni3d(mcfg, "cpu", state_dict=sd)
              for name, (mcfg, sd) in inputs["models"].items()}

    def cli(name):
        def case():
            argv, model = inputs["cli"][name]
            return _patched_cli(tta, models[model],
                                inputs["cli_corruptions"])(argv)
        return case

    def server():
        cfg = inputs["cfg"]
        rank_model, encode = trunk.prepare_trunk_parallel(
            dataclasses.replace(cfg, run=dataclasses.replace(
                cfg.run, trunk_parallel=inputs.get("trunk", "pp"))),
            models["small"])
        srv = serve.TTAServer(cfg, rank_model,
                              torch.from_numpy(inputs["text"]),
                              sizes=(1, 2), encode_fn=encode)
        if not srv.primary:
            serve.follow(srv)
            return {"followed": True}
        streams = inputs["streams"]
        for cid in ("a", "b"):
            srv.register(cid)
        ticks = [srv.submit([(cid, streams[i, s], None)
                             for i, cid in enumerate(("a", "b"))])
                 for s in range(2)]
        ticks.append(srv.submit([("a", streams[0, 2], None)]))
        srv.stop()
        return {"ticks": ticks}

    def errors():
        out = {}
        for name, (cfg, model) in inputs["errors"].items():
            try:
                trunk.prepare_trunk_parallel(cfg, models[model])
                out[name] = None
            except ValueError as e:
                out[name] = str(e)
        return out

    def pretrain_runs():
        out = {}
        for name, argv in inputs["pretrain"]:
            state = pretrain.main(argv)
            out[name] = {"step": state.step,
                         "params": {n: p.detach().numpy().copy()
                                    for n, p in state.params.items()},
                         "mu": {n: m.numpy().copy() for n, m in
                                state.opt_state.mu.items()},
                         "logit_scale": state.logit_scale.item()}
        return out

    return run_cases({**{f"cli_{n}": cli(n) for n in inputs["cli"]},
                      "server": server, "errors": errors,
                      "pretrain": pretrain_runs})


def sp_program(inputs: dict, rank: int) -> dict:
    """The sequence-parallel trunk (tests/test_torch_sp.py): the cases of
    `inputs["cases"]` whose world is this one, each on a (data, seq) grid
    of the world (`sp.make_sp_grid`): ring attention on this rank's token
    shard (the parts form with its requests, and the autograd form's
    gradients), forwards with their requests, train steps and MODE-DOTA
    trajectories."""
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from uni_adapter_torch import engine, train
    from uni_adapter_torch.parallel import sp

    world = dist.get_world_size()
    t = torch.from_numpy

    def build(name):
        return build_pp_model(*inputs["models"][name])

    def grid_of(c):
        return sp.make_sp_grid(c["S"], c.get("dp", 1))

    def ring(c):
        """This rank's rows of ring attention over the padded tokens, its
        requests, and under autograd the gradients of sum(out·ct) with
        respect to its shard of q, k and v."""
        q, k, v, ct = (t(c[n]) for n in ("q", "k", "v", "ct"))
        n_tok = q.shape[2]
        pad = -n_tok % world
        n_loc = (n_tok + pad) // world
        rows = slice(rank * n_loc, (rank + 1) * n_loc)
        shard = [F.pad(a, (0, 0, 0, pad))[:, :, rows] for a in (q, k, v, ct)]
        valid = (torch.arange(n_tok + pad) < n_tok).float()[rows]
        group = dist.group.WORLD
        out, log = _logged(lambda: sp.ring_attention(
            *shard[:3], c["scale"], group, valid))
        leaves = [a.clone().requires_grad_(True) for a in shard[:3]]
        y = engine.drive(sp.ring_attention(
            *leaves, c["scale"], group, valid, sp.autograd_hop(group)), None)
        grads = torch.autograd.grad((y * shard[3]).sum(), leaves)
        return {"out": out.numpy(), "log": log, "rows": (rows.start,
                                                         rows.stop),
                "autograd_out": y.detach().numpy(),
                "grads": [g.numpy() for g in grads]}

    def forward(c):
        grid = grid_of(c)
        model = build(c["model"])
        fwd = sp.make_sp_forward(model, grid.seq_group, grid.data_group)
        with torch.no_grad():
            feat, log = _logged(fwd, *(t(x) for x in c["inputs"]))
            plain = model(*(t(x) for x in c["inputs"])) if c.get(
                "plain") else None
        return {"feat": feat.float().numpy(), "log": log,
                "grid": tuple(grid[:4]),
                "plain": None if plain is None else plain.float().numpy()}

    def train_steps(c):
        grid = grid_of(c)
        model = build(c["model"]).requires_grad_(True)
        tx = train.make_optimizer(**c["optimizer"])
        step = sp.make_sp_train_step(model, tx, grid.seq_group,
                                     grid.data_group)
        state = train.init_train_state(model, tx)
        metrics = []
        for b in c["batches"]:
            state, m = step(state, *(t(x) for x in b))
            metrics.append({k: v.item() for k, v in m.items()})
        return {"metrics": metrics,
                "params": {n: p.detach().numpy().copy()
                           for n, p in state.params.items()},
                "logit_scale": state.logit_scale.item()}

    def trajectory(c):
        model = build(c["model"])
        model, encode = sp.make_sp_encode_fn(model, c["kind"],
                                             dist.group.WORLD)
        out = {}
        for name, kw in (("sp", dict(encode_fn=encode)), ("replicated", {})):
            scan_fn = _fed(engine.make_scan_fn(c["cfg"], model, **kw),
                           c["noise"])
            _, outs = engine.run_stream_scan(c["cfg"], model, t(c["text"]),
                                             *c["stream"], seed=42,
                                             scan_fn=scan_fn)
            out[name] = (outs.final_logits.numpy(), outs.correct.numpy())
        return out

    kinds = {"ring": ring, "forward": forward, "train": train_steps,
             "trajectory": trajectory}
    return run_cases({c["name"]: functools.partial(kinds[c["type"]], c)
                      for c in inputs["cases"] if c["world"] == world})


PROGRAMS = {"parallel": parallel_program, "dp_train": dp_train_program,
            "ep": ep_program, "ep_methods": ep_methods_program,
            "ep_serve": ep_serve_program, "tp": tp_program,
            "tp_cli": tp_cli_program, "pp": pp_program,
            "pp_cli": trunk_cli_program, "sp": sp_program,
            "sp_cli": trunk_cli_program}


def main() -> None:
    program, rank, world, tmp = (sys.argv[1], int(sys.argv[2]),
                                 int(sys.argv[3]), Path(sys.argv[4]))
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    try:
        inputs = torch.load(tmp / "inputs.pt", weights_only=False)
        results = PROGRAMS[program](inputs, rank)
        torch.save(results, tmp / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main()
