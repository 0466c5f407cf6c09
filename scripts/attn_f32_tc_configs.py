"""Device time of the fp32 attention at the main paths' six shapes, for
each candidate table of block shapes of the split-TF32 kernel.

    python3 scripts/attn_f32_tc_configs.py [--rounds R]

On one CUDA card (its name and power limit printed first): builds
`uni_adapter_torch/csrc/eva_attention.cu` and `csrc/attention_fp32.cu`
once per row of CANDIDATES (a source that defines UAT_F32_TC_SHAPES and
includes it; all builds started together, into
`build/uni_adapter_torch/attn_f32_tc/`), then runs each build on the same
seeded inputs, peaked attention as in chip_smoke.py: the fp32 block's
attention step, (B, N, D, H) = (2, 513, 1024, 16) on the q/k/v column
slices of one (B, N, 3D) tensor as the block hands them over, through the
natural layout's fp32 entry; row 9 at the three extraction shapes through
the (B, H, N, hd) entry; row 4f at OpenShape-G's and ULIP-2's shapes.
Each output is held to its plain version within chip_smoke's fp32
tolerance, and the device ms of a call (torch.profiler) is taken in turns
over `--rounds` rounds.  Prints one line per shape and row with the median
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
from uni_adapter_torch.cli.tta import set_numerics  # noqa: E402
from uni_adapter_torch.ops import (attention_fp32, build,  # noqa: E402
                                   eva_attention)

#: One build per row: its defines.  The first is the source's default.
CANDIDATES = {
    "64x4 | 80x3 | 64x2": "#define UAT_F32_TC_SHAPES 4, 4, 5, 3, 4, 2\n",
    "64x4 | 80x3 | 64x1": "#define UAT_F32_TC_SHAPES 4, 4, 5, 3, 4, 1\n",
    "64x4 | 64x2 | 64x2": "#define UAT_F32_TC_SHAPES 4, 4, 4, 2, 4, 2\n",
    "64x4 | 80x3 | 48x1": "#define UAT_F32_TC_SHAPES 4, 4, 5, 3, 3, 1\n",
}
SOURCES = {"eva_attention": eva_attention, "attention_fp32": attention_fp32}
#: (entry, shape): "natural" (B, N, D, H) column slices, "heads" (B, H, N,
#: hd) contiguous.
SHAPES = {"block step": ("natural", (2, 513, 1024, 16)),
          "row 9 uni3d": ("heads", (1, 16, 513, 64)),
          "row 9 openshape": ("heads", (1, 8, 385, 64)),
          "row 9 ulip": ("heads", (1, 6, 513, 64)),
          "row 4f openshape": ("natural", (2, 385, 512, 8)),
          "row 4f ulip": ("natural", (2, 513, 384, 6))}


def build_variants() -> dict:
    """{row: {source: bound library}}, every build started together."""
    libs = {}
    variants = {(row, name): (name, defines)
                for row, defines in CANDIDATES.items() for name in SOURCES}
    for (row, name), (lib, _) in build.build_variants(
            variants, "attn_f32_tc").items():
        libs.setdefault(row, {})[name] = SOURCES[name]._bind(lib)
    return libs


def inputs(gen, entry, shape):
    """(kernel call, plain call) on seeded peaked inputs of `shape`."""
    if entry == "heads":
        qkv = torch.randn(3, *shape, generator=gen, device="cuda")
        qkv[:2] *= smoke.BLOCK_LN_GAMMA
        q, k, v = qkv.unbind(0)
        return (lambda: attention_fp32.attention_fp32_cuda(q, k, v),
                lambda: attention_fp32.attention_fp32_plain(q, k, v))
    B, N, D, H = shape
    qkv = torch.randn(B, N, 3 * D, generator=gen, device="cuda")
    qkv[..., :2 * D] *= smoke.BLOCK_LN_GAMMA
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
    return (lambda: eva_attention.eva_attention_fp32_cuda(q, k, v,
                                                          num_heads=H),
            lambda: eva_attention.eva_attention_plain(q, k, v, num_heads=H))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=3)
    rounds = ap.parse_args().rounds
    if not torch.cuda.is_available():
        sys.exit("attn_f32_tc_configs: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    libs = build_variants()
    set_numerics()
    gen = torch.Generator(device="cuda").manual_seed(0)
    calls = {what: inputs(gen, *spec) for what, spec in SHAPES.items()}
    wants = {what: plain() for what, (_, plain) in calls.items()}
    times = {}                      # (shape, row) -> [ms per round]
    for _ in range(rounds):
        for row, lib in libs.items():
            eva_attention._lib = lambda lib=lib: lib["eva_attention"]
            attention_fp32._lib = lambda lib=lib: lib["attention_fp32"]
            for what, (kernel, _) in calls.items():
                got = kernel()
                r = smoke.block_err(got, wants[what], smoke.F32_RTOL,
                                    smoke.F32_ATOL_RMS)
                if r > 1 or not torch.isfinite(got).all():
                    sys.exit(f"attn_f32_tc_configs: {what} on {row} is "
                             f"outside the fp32 tolerance ({r:.3f})")
                times.setdefault((what, row), []).append(
                    smoke.device_ms(kernel))
    result = {}
    for what in SHAPES:
        for row in CANDIDATES:
            ms = times[what, row]
            result.setdefault(what, {})[row] = statistics.median(ms)
            print(f"{what} {SHAPES[what][1]}, {row}: device "
                  f"{statistics.median(ms):.4f} ms a call (rounds "
                  f"{', '.join(f'{t:.4f}' for t in ms)})")
    print(json.dumps({"card": card, "rounds": rounds, "device_ms": result}))


if __name__ == "__main__":
    main()
