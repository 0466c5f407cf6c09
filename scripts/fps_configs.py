"""Device time of the two FPS kernels at each candidate configuration.

    python3 scripts/fps_configs.py [--rounds R]

On one CUDA card (its name and power limit printed first): builds
`uni_adapter_torch/csrc/fps.cu` once per row of FPS_CLASSES (its size
classes and the warps a block of each, UAT_FPS_CLASSES) and
`csrc/fps_grid.cu` once per row of GRID_TILES (warps a block and target
points a thread, which set the cluster size, UAT_FPS_GRID_TILE), all
builds started together into `build/uni_adapter_torch/fps_configs/`.
Each build's indices must equal the plain version's at CHECKS and on
chip_smoke's tie clouds (fps.cu's up to its largest class), in each of
REPEATS launches; then the device ms of one call (torch.profiler) at
TIMED, in turns over `--rounds` rounds, with ns a round (device ms /
npoint).  Row 0 of each table is the source's default; fps.cu's rows
past 4096 points show where fps_grid.cu overtakes it (MAX_POINTS).
Prints one line per kernel, configuration and shape with the median over
rounds, and a JSON object of all of them last.
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
from uni_adapter_torch.ops import build, fps  # noqa: E402

#: fps.cu: (largest N, warps a block) of each size class (points a thread
#: = N / (32 × warps)).
FPS_CLASSES = ("256,1, 512,2, 1024,4, 2048,4, 4096,8",
               "256,2, 512,4, 1024,2, 2048,8, 4096,16",
               "256,1, 512,2, 1024,8, 2048,8, 4096,4",
               "256,1, 512,2, 1024,4, 2048,4, 4096,8, 6144,8, 8192,8",
               "256,1, 512,2, 1024,4, 2048,4, 4096,8, 8192,16")
#: fps_grid.cu: (warps a block, target points a thread).
GRID_TILES = ("4,8", "4,16", "8,8")
#: Shapes (B, N, npoint) checked against the plain version on every build
#: (fps.cu only up to its largest class).
CHECKS = ((1, 1, 1), (2, 33, 33), (2, 257, 128), (2, 1024, 512),
          (2, 1025, 512), (2, 4096, 512), (2, 4097, 512), (2, 6145, 512),
          (2, 8192, 512), (2, 10000, 512), (30, 10000, 512), (1, 20000, 512))
#: Launches of each check (the cluster's exchange has no barrier: a race
#: would show as a launch that differs).
REPEATS = 10
#: Shapes timed: the 1024-point paths, 2048, both sides of 4096, 6144,
#: ULIP-2's 8192, the LVIS path's 10,000 (also as ROADMAP M6a's 30-cloud
#: batch), and 20,000.
TIMED = ((2, 1024, 512), (2, 2048, 512), (2, 4096, 512), (2, 4097, 512),
         (2, 6144, 512), (2, 8192, 512), (2, 10000, 512), (30, 10000, 512),
         (1, 20000, 512))


def largest_class(config: str) -> int:
    """The largest N an fps.cu build of FPS_CLASSES row `config` takes."""
    return int(config.split(",")[-2])


def build_variants() -> dict:
    """{(kernel, configuration): library}, every build started at once."""
    rows = {("fps", c): ("fps", f"#define UAT_FPS_CLASSES {c}\n")
            for c in FPS_CLASSES}
    rows.update({("fps_grid", tile):
                 ("fps_grid", f"#define UAT_FPS_GRID_TILE {tile}\n")
                 for tile in GRID_TILES})
    libs = {}
    for (name, config), (lib, log) in build.build_variants(
            rows, "fps_configs").items():
        print(f"{name} ({config}):")
        smoke.ptxas_report(name, log)
        bind = fps._bind if name == "fps" else fps._bind_grid
        libs[(name, config)] = bind(lib)
    return libs


def use(name: str, config: str, lib) -> object:
    """Point the wrapper at `lib`; returns the launcher of `name`."""
    if name == "fps":
        fps._lib = lambda: lib
        fps.MAX_POINTS = largest_class(config)
        return fps.fps_cuda
    fps._grid_lib = lambda: lib
    return fps.fps_grid_cuda


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    rounds = ap.parse_args().rounds
    if not torch.cuda.is_available():
        sys.exit("fps_configs: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(f"{(B, N, G)}", smoke.sphere_cloud(torch, gen, B, N), G)
             for B, N, G in CHECKS]
    for N in smoke.FPS_TIE_POINTS:
        cases += [(f"{tie}, (1, {N}, 512)", xyz, 512)
                  for tie, xyz in smoke.tie_clouds(torch, gen, N).items()]
    wants = [fps.fps_plain(xyz, G) for _, xyz, G in cases]
    for (name, config), lib in libs.items():
        run = use(name, config, lib)
        for (what, xyz, G), want in zip(cases, wants):
            if name == "fps" and xyz.shape[1] > fps.MAX_POINTS:
                continue
            for _ in range(REPEATS):
                got = run(xyz, G)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    sys.exit(f"fps_configs: {name} ({config}) {what}: "
                             f"{(got != want).sum().item()} indices differ")
        plans = ("" if name == "fps" else "; " + ", ".join(
            f"N {N}: {smoke.fps_plan_text(fps, N)}"
            for _, N, _ in TIMED))
        print(f"{name} ({config}): indices equal at every check{plans}")
    timed = [(shape, smoke.sphere_cloud(torch, gen, *shape[:2]))
             for shape in TIMED]
    times = {}            # (kernel, config, shape) -> [device ms per round]
    for _ in range(rounds):
        for (name, config), lib in libs.items():
            run = use(name, config, lib)
            for (B, N, G), xyz in timed:
                if name == "fps" and N > fps.MAX_POINTS:
                    continue
                times.setdefault((name, config, (B, N, G)), []).append(
                    smoke.device_ms(lambda: run(xyz, G)))
    result = {}
    for (name, config, shape), ms in times.items():
        med = statistics.median(ms)
        result.setdefault(name, {}).setdefault(config, {})[str(shape)] = med
        print(f"{name} ({config}) {shape}: device {med:.4f} ms, "
              f"{med * 1e6 / shape[2]:.0f} ns a round (rounds "
              f"{', '.join(f'{t:.4f}' for t in ms)})")
    print(json.dumps({"card": card, "rounds": rounds, "device_ms": result}))


if __name__ == "__main__":
    main()
