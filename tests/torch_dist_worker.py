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

def _fed_scan(cfg, model, noises, group=None):
    """A scan whose step takes its noise from `noises` in turn (the JAX
    run's draws), keeping the step's process group."""
    import torch

    from uni_adapter_torch import engine

    scan_fn = engine.make_scan_fn(cfg, model, axis_name=group)
    step, it = scan_fn.step, iter(noises)
    scan_fn.step = engine.Step(
        lambda t, s, b, noise=None: step.parts(
            t, s, b, torch.from_numpy(next(it))), step.group)
    return scan_fn


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


PROGRAMS = {"parallel": parallel_program, "dp_train": dp_train_program}


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
