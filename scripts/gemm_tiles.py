"""Device time of the EVA block's four GEMMs at each candidate tile.

    python3 scripts/gemm_tiles.py [--rounds R]

On one CUDA card (its name and power limit printed first): builds
`uni_adapter_torch/csrc/eva_attn_block.cu` once per row of CANDIDATES,
with the row's tiles in place of the defaults (a source that defines
UAT_*_TILE and includes it; all builds started together, into
`build/uni_adapter_torch/tiles/`),
then runs both entries of the block on each build at Uni3D-L's (2, 513,
1024, 16) on the same seeded inputs: the output against the plain
version within chip_smoke's tolerance, and the device ms of each GEMM
launch (torch.profiler, the first and third kernels of a call), in turns
over `--rounds` rounds.  Prints one line per GEMM and tile with the
median over rounds, and a JSON object of all of them last.
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
from uni_adapter_torch.cli.tta import set_numerics  # noqa: E402
from uni_adapter_torch.ops import attention, build  # noqa: E402

#: One build per row: the tile of each GEMM, bf16 (warpgroups, columns,
#: ring stages) and fp32 (rows, columns, rows a thread, K step, K split
#: groups).  Row 0 is the source's default.
CANDIDATES = (
    {"bf16 qkv": "2,128,3", "bf16 out": "1,64,4",
     "fp32 qkv": "96,128,8,32,1", "fp32 out": "64,128,4,32,2"},
    {"bf16 qkv": "2,128,4", "bf16 out": "1,128,4",
     "fp32 qkv": "64,128,4,32,1", "fp32 out": "64,128,4,32,1"},
    {"bf16 qkv": "2,256,4", "bf16 out": "2,64,4",
     "fp32 qkv": "96,128,8,32,2", "fp32 out": "128,64,4,32,2"},
    {"bf16 qkv": "1,128,4", "bf16 out": "1,64,6",
     "fp32 qkv": "128,128,8,16,1", "fp32 out": "64,64,4,32,2"},
)
MACROS = {"bf16 qkv": "UAT_BF16_QKV_TILE", "bf16 out": "UAT_BF16_OUT_TILE",
          "fp32 qkv": "UAT_F32_QKV_TILE", "fp32 out": "UAT_F32_OUT_TILE"}
SHAPE = (2, 513, 1024, 16)


def build_variants() -> list:
    """One library a row of CANDIDATES, argument types declared."""
    libs = build.build_variants(
        {i: ("eva_attn_block",
             "".join(f"#define {MACROS[k]} {v}\n" for k, v in row.items()))
         for i, row in enumerate(CANDIDATES)}, "tiles")
    return [attention._bind(lib) for lib, _ in libs.values()]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    rounds = ap.parse_args().rounds
    if not torch.cuda.is_available():
        sys.exit("gemm_tiles: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    libs = build_variants()
    set_numerics()
    gen = torch.Generator(device="cuda").manual_seed(0)
    H = SHAPE[3]
    entries = {
        "bf16": (attention.eva_attn_block_cuda,
                 smoke.block_inputs(torch, gen, SHAPE[:3], torch.bfloat16),
                 (smoke.BLOCK_RTOL, smoke.BLOCK_ATOL_RMS)),
        "fp32": (attention.eva_attn_block_fp32_cuda,
                 smoke.block_inputs(torch, gen, SHAPE[:3], torch.float32),
                 (smoke.F32_RTOL, smoke.F32_ATOL_RMS))}
    wants = {dt: attention.eva_attn_block_plain(*args, num_heads=H).float()
             for dt, (_, args, _) in entries.items()}
    times = {}                      # (gemm, tile) -> [ms per round]
    for _ in range(rounds):
        for lib, row in zip(libs, CANDIDATES):
            attention._lib = lambda lib=lib: lib
            for dt, (kernel, args, tol) in entries.items():
                got = kernel(*args, num_heads=H).float()
                r = smoke.block_err(got, wants[dt], *tol)
                if r > 1 or not torch.isfinite(got).all():
                    sys.exit(f"gemm_tiles: {dt} with tiles {row} is outside "
                             f"the tolerance ({r:.3f})")
                per = smoke.device_ms_by_launch(
                    lambda: kernel(*args, num_heads=H), 3)
                for gemm, (_, ms) in ((f"{dt} qkv", per[0]),
                                      (f"{dt} out", per[2])):
                    times.setdefault((gemm, row[gemm]), []).append(ms)
    result = {}
    for (gemm, tile), ms in sorted(times.items()):
        med = statistics.median(ms)
        result.setdefault(gemm, {})[tile] = med
        print(f"{gemm} GEMM, tile ({tile}): device {med:.4f} ms a launch "
              f"(rounds {', '.join(f'{t:.4f}' for t in ms)})")
    print(json.dumps({"card": card, "shape": SHAPE, "rounds": rounds,
                      "device_ms": result}))


if __name__ == "__main__":
    main()
