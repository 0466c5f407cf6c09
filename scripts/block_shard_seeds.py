"""The bf16 block's head-sharded entry (row 3h, `csrc/eva_attn_block.cu`)
against its plain version over many seeded draws: how far the smoke
check's err/tolerance spreads, and whether a draw near or past 1 comes
from a fault of the kernel or from the two sides rounding differently.

    python3 scripts/block_shard_seeds.py [--seeds S]

On one CUDA card (its name and power limit printed first), for each of
chip_smoke.py's BLOCK_HEAD_SHARDS and seeds 0 .. S-1, draws the shard's
arguments as chip_smoke.py does (`head_shard_inputs`, bf16, peaked
attention) from a generator of that seed and prints:

- `r`: the smoke check's err/tolerance of the kernel against the plain
  version (`block_err`: rtol BLOCK_RTOL, atol BLOCK_ATOL_RMS of the RMS),
  and `r_shard` the same at the head shard's atol, BLOCK_SHARD_ATOL_RMS;
- `r_plain_cpu`: the same measure of the plain version run on the CPU
  against the plain version on the card: the same rounding points, only
  the fp32 sums in another order, so the spread that a correct
  implementation shows against the plain version;
- `r_kernel_exact`, `r_plain_exact`: the same measure of the kernel and
  of the plain version against the exact function, the plain version on
  the same (bf16-valued) arguments in fp32 with no bf16 rounding in
  between.  A kernel as accurate as its plain version scores alike;
- where the worst element lies (batch, row, column), |want| there over
  the output's RMS, and the share of that element's error that the head
  concat explains: the kernel's own concat, read back through an out
  projection that is the identity on its first Dh columns, against the
  plain version's, carried through the real out projection.  Beside it
  the concat's differences in bf16 ulps (how many elements differ, the
  largest) and the heads and rows they lie in.

Prints one JSON object last with every record and, per shape, the
spread of each measure.
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
from uni_adapter_torch.ops import attention  # noqa: E402


def ulps_bf16(a, b):
    """|a − b| in units of the bf16 ulp at max(|a|, |b|) (2⁻⁷ of the
    power of two below it; subnormals at the smallest normal's)."""
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    return (a - b).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)


def one_draw(shape, seed: int) -> dict:
    B, N, D, H = shape
    Dh = 64 * H
    gen = torch.Generator(device="cuda").manual_seed(seed)
    args = smoke.head_shard_inputs(torch, gen, shape, torch.bfloat16)
    got = attention.eva_attn_block_cuda(*args, num_heads=H)
    want, _, _, _, cat = attention._plain_parts(*args, num_heads=H,
                                                scale=None, eps=1e-5)
    exact = attention.eva_attn_block_plain(
        *(a if a is None else a.float() for a in args), num_heads=H)
    want_cpu = attention.eva_attn_block_plain(
        *(a if a is None else a.cpu() for a in args), num_heads=H)
    ratio = (got - want).abs() / (smoke.block_atol(want)
                                  + smoke.BLOCK_RTOL * want.abs())
    flat = int(ratio.argmax())
    b, n, col = flat // (N * D), flat // D % N, flat % D
    wo = args[10]
    eye = torch.zeros(D, Dh, device="cuda", dtype=torch.bfloat16)
    eye[:Dh] = torch.eye(Dh, device="cuda", dtype=torch.bfloat16)
    got_cat = attention.eva_attn_block_cuda(*args[:10], eye, None,
                                            num_heads=H)[..., :Dh]
    plain_cat = cat.float()
    explained = ((got_cat[b, n] - plain_cat[b, n]) @ wo[col].float()).item()
    u = ulps_bf16(got_cat, plain_cat)
    diff = u > 0
    where = diff.nonzero()
    rms = want.pow(2).mean().sqrt().item()
    return {
        "seed": seed, "r": ratio.max().item(),
        "r_shard": smoke.block_err(got, want,
                                   atol_rms=smoke.BLOCK_SHARD_ATOL_RMS),
        "r_plain_cpu": smoke.block_err(want_cpu.to(want.device), want),
        "r_kernel_exact": smoke.block_err(got, exact),
        "r_plain_exact": smoke.block_err(want, exact),
        "worst": [b, n, col],
        "want_over_rms": abs(want[b, n, col].item()) / rms,
        "err": (got[b, n, col] - want[b, n, col]).item(),
        "err_from_concat": explained,
        "concat_differ": int(diff.sum()),
        "concat_elements": diff.numel(),
        "concat_max_ulps": u.max().item(),
        "concat_differ_worst_row": int(diff[b, n].sum()),
        "concat_max_ulps_worst_row": u[b, n].max().item(),
        "concat_differ_heads": sorted({int(c) // 64 for c in where[:, 2]}),
        "concat_differ_rows_mod64": sorted({int(r) % 64
                                            for r in where[:, 1]})[:16],
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=24)
    seeds = ap.parse_args().seeds
    if not torch.cuda.is_available():
        sys.exit("block_shard_seeds: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    set_numerics()
    records, spread = {}, {}
    for shape in smoke.BLOCK_HEAD_SHARDS:
        label = str(shape)
        records[label] = []
        for seed in range(seeds):
            rec = one_draw(shape, seed)
            records[label].append(rec)
            print(f"{label} seed {seed}: r {rec['r']:.4f} (at the shard's "
                  f"atol {rec['r_shard']:.4f}), plain on the "
                  f"CPU {rec['r_plain_cpu']:.4f} (kernel/exact "
                  f"{rec['r_kernel_exact']:.4f}, plain/exact "
                  f"{rec['r_plain_exact']:.4f}); worst {rec['worst']} "
                  f"|want|/RMS {rec['want_over_rms']:.3f}, err "
                  f"{rec['err']:.4g}, from the concat "
                  f"{rec['err_from_concat']:.4g}; concat differs at "
                  f"{rec['concat_differ']} of {rec['concat_elements']} "
                  f"(max {rec['concat_max_ulps']:.2f} ulps; worst row "
                  f"{rec['concat_differ_worst_row']}, max "
                  f"{rec['concat_max_ulps_worst_row']:.2f}); heads "
                  f"{rec['concat_differ_heads']}", flush=True)
        spread[label] = {
            key: {"min": min(r[key] for r in records[label]),
                  "median": statistics.median(r[key]
                                              for r in records[label]),
                  "max": max(r[key] for r in records[label])}
            for key in ("r", "r_shard", "r_plain_cpu", "r_kernel_exact",
                        "r_plain_exact", "concat_max_ulps")}
        print(f"{label}: " + "; ".join(
            f"{k} {v['min']:.4f} / {v['median']:.4f} / {v['max']:.4f}"
            for k, v in spread[label].items()) + " (min / median / max)")
    print(json.dumps({"card": card, "seeds": seeds, "spread": spread,
                      "records": records}))


if __name__ == "__main__":
    main()
