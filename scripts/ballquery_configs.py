"""Device time of the ball-query kernel at each candidate configuration.

    python3 scripts/ballquery_configs.py [--rounds R] [--parent DIR]

On one CUDA card (its name and power limit printed first): builds
`uni_adapter_torch/csrc/ballquery.cu` once per row of CONFIGS (queries a
block, warps a query, 32-point chunks a warp a round, points a tile:
UAT_BALLQUERY_CONFIG), and with `--parent` also the ballquery.cu of the
checkout at DIR as it stands, all builds started together into
`build/uni_adapter_torch/ballquery_configs/`.  Each build's indices must
equal the plain version's on chip_smoke's ball-query cases
(`ballquery_cases`: the contract's shapes and the hard clouds) in each of
REPEATS launches; then the device ms of one call (torch.profiler) at
chip_smoke's BALLQUERY_SHAPES (OpenShape-G's set abstraction on 1024 and
on 10,000 points), in turns over `--rounds` rounds.  Row 0 is the
source's default.  Prints one line per build and shape with the median
over rounds, and a JSON object of all of them last.
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
from uni_adapter_torch.ops import ballquery, build  # noqa: E402

#: (queries a block, warps a query, chunks a warp a round, tile).
CONFIGS = ("2, 4, 8, 1024", "2, 4, 8, 2048", "2, 4, 4, 512",
           "2, 4, 4, 1024", "3, 4, 8, 1024", "4, 4, 8, 1024",
           "1, 4, 8, 1024", "2, 8, 4, 1024", "4, 1, 8, 1024")
#: Launches of each check.
REPEATS = 3


def build_variants(parent: Path | None) -> dict:
    """{configuration: bound library}, every build at once; "parent" for
    the other checkout's source."""
    rows = {c: ("ballquery", f"#define UAT_BALLQUERY_CONFIG {c}\n")
            for c in CONFIGS}
    if parent is not None:
        rows["parent"] = (parent / "uni_adapter_torch" / "csrc"
                          / "ballquery.cu", "")
    libs = {}
    for config, (lib, log) in build.build_variants(
            rows, "ballquery_configs").items():
        print(f"ballquery ({config}):")
        smoke.ptxas_report("ballquery", log)
        libs[config] = ballquery._bind(lib)
    return libs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another checkout whose ballquery.cu is "
                         "timed beside these")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ballquery_configs: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    libs = build_variants(args.parent)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = smoke.ballquery_cases(torch, gen)
    wants = [ballquery.query_ball_plain(r, ns, xyz, q)
             for _, xyz, q, r, ns in cases]
    for config, lib in libs.items():
        ballquery._lib = lambda: lib
        for (what, xyz, q, r, ns), want in zip(cases, wants):
            for _ in range(REPEATS):
                got = ballquery.query_ball_cuda(r, ns, xyz, q)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    sys.exit(f"ballquery_configs: ({config}) {what}: "
                             f"{(got != want).sum().item()} indices differ "
                             f"from the plain version's")
        print(f"ballquery ({config}): equal to the plain version at every "
              f"check, {REPEATS} launches each")
    timed = {}
    for label, (B, N, S, ns) in smoke.BALLQUERY_SHAPES.items():
        xyz = smoke.sphere_cloud(torch, gen, B, N)
        timed[label] = (xyz, smoke.fps_queries(torch, xyz, S), ns)
    times = {}                      # (config, label) -> [device ms a round]
    for _ in range(args.rounds):
        for config, lib in libs.items():
            ballquery._lib = lambda: lib
            for label, (xyz, q, ns) in timed.items():
                times.setdefault((config, label), []).append(smoke.device_ms(
                    lambda: ballquery.query_ball_cuda(0.2, ns, xyz, q)))
    result = {}
    for (config, label), ms in times.items():
        med = statistics.median(ms)
        result.setdefault(config, {})[label] = med
        print(f"ballquery ({config}) {label} "
              f"{smoke.BALLQUERY_SHAPES[label]}: device {med:.4f} ms "
              f"(rounds {', '.join(f'{t:.4f}' for t in ms)})")
    print(json.dumps({"card": card, "rounds": args.rounds,
                      "device_ms": result}))


if __name__ == "__main__":
    main()
