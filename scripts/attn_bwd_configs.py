"""Device time of the fp32 block's backward (`csrc/eva_attn_block_bwd.cu`)
at chip_smoke.py's backward shapes, for each candidate configuration: the
rows of a chunk and the blocks an SM that kernels (1) and (2) cap their
registers for.

    python3 scripts/attn_bwd_configs.py [--rounds R]

On one CUDA card (its name and power limit printed first): builds the
source once per row of CANDIDATES (a source that defines UAT_BWD_CONFIG
and includes it; all builds started together, into
`build/uni_adapter_torch/attn_bwd/`) and prints each build's registers and
spills.  Then, on the seeded inputs of chip_smoke.py's check
(`block_bwd_case`: the fp32 block's forward workspaces, peaked
attention), holds each build's dq | dk | dv and dγ/dβ to the plain step
within chip_smoke's fp32 tolerance and takes the device ms of a call
(torch.profiler) in turns over `--rounds` rounds.  Prints one line per
shape and row with the median over rounds, and a JSON object of all of
them last.
"""
from __future__ import annotations

import argparse
import json
import re
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

#: One build per row: its defines.  The first is the source's default.
CANDIDATES = {
    "32 rows, 3 | 3 blocks": "#define UAT_BWD_CONFIG 32, 3, 3\n",
    "32 rows, 3 | 2 blocks": "#define UAT_BWD_CONFIG 32, 3, 2\n",
    "64 rows, 2 | 2 blocks": "#define UAT_BWD_CONFIG 64, 2, 2\n",
}


def registers(log: str) -> dict:
    """{kernel: 'N registers, S bytes spilled'} of the backward's kernels
    from nvcc's -Xptxas -v output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?(eva_bwd_\w+?_kernel)",
                      line)
        if m:
            name = m.group(1)
        elif name and "spill stores" in line:
            out[name] = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif name and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out[name] = f"{regs} registers, {out[name]} bytes spilled"
            name = None
    return out


def errs(got, want) -> float:
    """The worst err/tolerance of dq, dk, dv and dγq, dβq, dγk, dβk: rtol
    F32_RTOL + F32_ATOL_RMS of each part's RMS (dβk's: dγk's, as
    chip_smoke.grad_errs takes it)."""
    (dqkv, dln), (wqkv, wln) = got, want
    D = dqkv.shape[1] // 3
    parts = [(dqkv[:, i * D:(i + 1) * D], wqkv[:, i * D:(i + 1) * D], None)
             for i in range(3)]
    parts += [(dln[i], wln[i], wln[2] if i == 3 else None) for i in range(4)]
    worst = 0.0
    for g, w, scale in parts:
        ref = w if scale is None else scale
        atol = smoke.F32_ATOL_RMS * ref.pow(2).mean().sqrt()
        worst = max(worst, ((g - w).abs() / (atol + smoke.F32_RTOL * w.abs()))
                    .max().item())
    return worst


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    rounds = ap.parse_args().rounds
    if not torch.cuda.is_available():
        sys.exit("attn_bwd_configs: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    built = build.build_variants(
        {row: ("eva_attn_block_bwd", defines)
         for row, defines in CANDIDATES.items()}, "attn_bwd")
    libs = {}
    for row, (lib, log) in built.items():
        libs[row] = attention._bind_bwd(lib)
        print(f"{row}: {registers(log)}")
    set_numerics()
    gen = torch.Generator(device="cuda").manual_seed(0)
    steps = {label: smoke.block_bwd_case(torch, gen, shape)["step_args"]
             for label, shape in smoke.BLOCK_BWD_SHAPES.items()}
    wants = {label: attention.eva_attn_block_bwd_plain(*a)
             for label, a in steps.items()}
    times = {}                      # (shape, row) -> [ms per round]
    for _ in range(rounds):
        for row, lib in libs.items():
            attention._lib_bwd = lambda lib=lib: lib
            for label, args in steps.items():
                kernel = lambda args=args: attention.eva_attn_block_bwd_cuda(
                    *args)
                r = errs(kernel(), wants[label])
                if not r <= 1:
                    sys.exit(f"attn_bwd_configs: {label} on {row} is "
                             f"outside the fp32 tolerance ({r:.3f})")
                times.setdefault((label, row), []).append(
                    smoke.device_ms(kernel))
    result = {}
    for label in steps:
        for row in CANDIDATES:
            ms = times[label, row]
            result.setdefault(label, {})[row] = statistics.median(ms)
            print(f"{label}, {row}: device {statistics.median(ms):.4f} ms a "
                  f"call (rounds {', '.join(f'{t:.4f}' for t in ms)})")
    print(json.dumps({"card": card, "rounds": rounds, "device_ms": result}))


if __name__ == "__main__":
    main()
