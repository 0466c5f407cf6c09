"""Device time of the two kNN kernels at each candidate configuration.

    python3 scripts/knn_configs.py [--rounds R]

On one CUDA card (its name and power limit printed first): builds
`uni_adapter_torch/csrc/knn.cu` once per row of KNN_WARPS (warps a block,
one query a warp, UAT_KNN_WARPS) and `csrc/knn_gather.cu` once per row of
GATHER_TILES (warps a block, points a tile, UAT_KNN_GATHER_TILE), all
builds started together into `build/uni_adapter_torch/knn_configs/`.
Each build's outputs must equal the
plain version's on chip_smoke's kNN cases (`knn_cases`: the contract's
shapes and the hard clouds) in each of REPEATS launches; then the device
ms of one call (torch.profiler) at TIMED, in turns over `--rounds`
rounds.  Row 0 of each table is the source's default.  knn_gather is
also timed at knn.cu's shapes with no values (C = 0), where `knn.knn`
could route it.  Prints one line per kernel, configuration and shape
with the median over rounds, and a JSON object of all of them last.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as smoke  # noqa: E402
from uni_adapter_torch.ops import build, knn, knn_gather  # noqa: E402

#: knn.cu: warps a block.
KNN_WARPS = ("8", "4", "16")
#: knn_gather.cu: (warps a block, points a tile).
GATHER_TILES = ("4, 2048", "2, 2048", "8, 2048", "4, 1024", "8, 1024")
#: Launches of each check.
REPEATS = 3
#: Shapes timed, (B, N, S, k, C), FPS centres as the queries: the LVIS and
#: ScanObjectNN-8192 paths' (row 6), Uni3D's and ULIP-2's 1024 points
#: (row 2: knn.cu, and knn_gather with C = 0), and knn_gather's worst case,
#: the decreasing-distance cloud at 10,000 points with 1024 queries.
TIMED = {"lvis10k": (2, 10000, 512, 64, 6),
         "scanobjectnn8192": (2, 8192, 512, 32, 3),
         "uni3d1024": (2, 1024, 512, 64, 0),
         "ulip1024": (2, 1024, 512, 32, 0),
         "decreasing": (1, 10000, 1024, 64, 6)}


def build_variants() -> dict:
    """{(kernel, configuration): bound library}, every build at once."""
    rows = {("knn", w): ("knn", f"#define UAT_KNN_WARPS {w}\n")
            for w in KNN_WARPS}
    rows.update({("knn_gather", c): (
        "knn_gather", f"#define UAT_KNN_GATHER_TILE {c}\n")
        for c in GATHER_TILES})
    libs = {}
    for (name, config), (lib, log) in build.build_variants(
            rows, "knn_configs").items():
        print(f"{name} ({config}):")
        smoke.ptxas_report(name, log)
        bind = knn._bind if name == "knn" else knn_gather._bind
        libs[(name, config)] = bind(lib)
    return libs


def use(name: str, lib):
    """Point the wrapper at `lib`; returns (k, xyz, q, values) -> (indices,
    values or None) through it."""
    if name == "knn":
        knn._lib = lambda: lib
        return lambda k, xyz, q, vals: (knn.knn_cuda(k, xyz, q), None)
    knn_gather._lib = lambda: lib
    return knn_gather.knn_gather_cuda


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("knn_configs: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = smoke.knn_cases(torch, gen)
    wants = [knn_gather.knn_gather_plain(k, xyz, q, vals)
             for _, xyz, q, k, vals in cases]
    for (name, config), lib in libs.items():
        run = use(name, lib)
        for (what, xyz, q, k, vals), (want_idx, want_vals) in zip(cases,
                                                                  wants):
            if (name == "knn" and xyz.shape[1] > knn.MAX_POINTS) or (
                    name == "knn_gather" and k > knn_gather.MAX_K):
                continue
            for _ in range(REPEATS):
                idx, got = run(k, xyz, q, vals)
                torch.cuda.synchronize()
                if not torch.equal(idx, want_idx) or (
                        got is not None and not torch.equal(got, want_vals)):
                    sys.exit(f"knn_configs: {name} ({config}) {what}: "
                             f"differs from the plain version")
        print(f"{name} ({config}): equal to the plain version at every "
              f"check, {REPEATS} launches each")
    timed = {}
    for label, (B, N, S, k, C) in TIMED.items():
        if label == "decreasing":
            xyz, q = smoke.knn_hard_clouds(torch, gen, N,
                                           S)["decreasing distance"]
            vals = torch.cat([xyz, xyz], -1).contiguous()
        else:
            pc = smoke.cloud(torch, gen, B, N)
            xyz = pc[..., :3].contiguous()
            vals = pc[..., :C].contiguous()
            q = smoke.fps_queries(torch, xyz, S)
        timed[label] = (xyz, q, k, vals)
    times = {}              # (kernel, config, label) -> [device ms a round]
    for _ in range(args.rounds):
        for (name, config), lib in libs.items():
            run = use(name, lib)
            for label, (xyz, q, k, vals) in timed.items():
                if name == "knn" and xyz.shape[1] > knn.MAX_POINTS:
                    continue
                times.setdefault((name, config, label), []).append(
                    smoke.device_ms(lambda: run(k, xyz, q, vals)))
    result = {}
    for (name, config, label), ms in times.items():
        med = statistics.median(ms)
        result.setdefault(name, {}).setdefault(config, {})[label] = med
        print(f"{name} ({config}) {label} {TIMED[label]}: device "
              f"{med:.4f} ms (rounds {', '.join(f'{t:.4f}' for t in ms)})")
    print(json.dumps({"card": card, "rounds": args.rounds,
                      "device_ms": result}))


if __name__ == "__main__":
    main()
