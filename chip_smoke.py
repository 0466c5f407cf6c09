"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card, `nvcc` and
PyTorch built for CUDA.  Phases, each printed as it ends; any failure
exits non-zero before the result line:

  1. the card's name and power limit (nvidia-smi);
  2. building the CUDA kernels of `uni_adapter_torch/csrc/` with one
     `nvcc` per source, all started together;
  3. each kernel at its main-path shape against its plain PyTorch version
     on the card (FPS and kNN indices exactly, the attention block within
     a bf16 tolerance that must reject planted faults), with kernel and
     plain times (median of 20 runs, CUDA events) and the least time the
     card could take (bound);
  4. Uni3D features at depth 2 and full width on the card (kernels) against
     the CPU (plain versions), the same weights in bf16;
  5. the main path through `uni_adapter_torch.cli.tta.main`: Uni3D-L
     (24 blocks, width 1024, 16 heads) in bf16 with random weights from a
     seed, MODE-DOTA defaults with residual learning, over a synthetic
     16-cloud corruption stream; the kernels' launch counters are zeroed
     just before and read just after, and every kernel must have run.

The line before the last is a JSON object of per-kernel numbers; the last
is `{"ok": true, "device": {...}}`.  Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 outside
# the tensor cores, HBM3 bandwidth.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# bf16 tolerance of the block kernel against its plain version:
# |got − want| ≤ atol + rtol·|want|, with atol a fraction of the output's
# RMS.  The two sum in different orders, so a bf16 rounding of q, k, v or
# p can flip upstream of the out projection; with peaked attention such a
# flip moves a few outputs near zero by more than 4e-3 (on an H100, 14 of
# 1 M outputs, max abs err 0.0234), so atol is 2% of the RMS, ≈0.012 at
# the inputs below.  The planted faults of `check_block_tolerance` move
# outputs by ~1.
BLOCK_RTOL, BLOCK_ATOL_RMS = 2e-2, 2e-2
# γ of the per-head q/k LayerNorms in the block check: softmax logits of
# std ≈ γ² ≈ 5 over 513 keys, so attention is peaked (as in a trained
# model) and a key the kernel drops or miscounts moves the output by O(1).
BLOCK_LN_GAMMA = 2.2


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, runs: int = 20, per_run: int = 10, warmup: int = 3) -> float:
    """Device ms per call of fn(): the median over `runs` of CUDA-event
    time around `per_run` back-to-back calls, divided by `per_run`.  Back
    to back, the host's launch work overlaps the device's, so a kernel
    whose wrapper takes longer on the host than it runs shows the host's
    time, as it would on the main path."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_run):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_run)
    return statistics.median(times)


def bound(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def block_atol(want) -> float:
    return BLOCK_ATOL_RMS * want.pow(2).mean().sqrt().item()


def block_err(got, want) -> float:
    """Largest |got − want| / (atol + rtol·|want|): at most 1 passes."""
    return ((got - want).abs()
            / (block_atol(want) + BLOCK_RTOL * want.abs())).max().item()


def check_block_tolerance(torch, attention, args, want, H) -> None:
    """The block tolerance must reject planted faults of the size a broken
    kernel would make: the tail key (key 512, alone in the last 64-key
    chunk) dropped, and the k LayerNorm's γ/β ignored."""
    xn, T = args[0], args[0].shape[1]
    dropped = attention.eva_attn_block_plain(
        xn[:, :T - 1].contiguous(), *args[1:], num_heads=H).float()
    ones, zeros = torch.ones_like(args[8]), torch.zeros_like(args[9])
    no_k_affine = attention.eva_attn_block_plain(
        *args[:8], ones, zeros, *args[10:], num_heads=H).float()
    for fault, got, ref in (("tail key dropped", dropped, want[:, :T - 1]),
                            ("k LayerNorm γ/β ignored", no_k_affine, want)):
        r = block_err(got, ref)
        print(f"  planted fault '{fault}': err/tolerance {r:.1f}")
        if r <= 1:
            fail(f"eva_attn_block: the tolerance passes the planted fault "
                 f"'{fault}'")


def check_kernels(torch, gen) -> list[dict]:
    from uni_adapter_torch.ops import attention, fps, knn
    from uni_adapter_torch.ops.geometry import index_points

    out = []
    # main-path shapes: the clean + noise-augmented clouds of one step
    B, N, G, M = 2, 1024, 512, 64
    xyz = torch.randn(B, N, 3, generator=gen, device="cuda")

    got = fps.fps_cuda(xyz, G)
    want = fps.fps_plain(xyz, G)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"fps: {(got != want).sum().item()} indices differ")
    # bounds count indices as int32, as the TPU kernels return them
    b_ms, b_by = bound(B * N * 3 * 4 + B * G * 4, B * G * N * 9, PEAK_FP32)
    out.append({"name": "fps", "route": "cuda",
                "source": "uni_adapter_torch/csrc/fps.cu",
                "replaces": "uni_adapter_tpu/ops/fps_pallas.py:105",
                "max_abs_err": 0,
                "ms": time_ms(lambda: fps.fps_cuda(xyz, G)),
                "plain_ms": time_ms(lambda: fps.fps_plain(xyz, G), per_run=1),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

    center = index_points(xyz, got)
    got = knn.knn_cuda(M, xyz, center)
    want = knn.knn_plain(M, xyz, center)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"knn: {(got != want).sum().item()} indices differ")
    b_ms, b_by = bound((B * N * 3 + B * G * 3) * 4 + B * G * M * 4,
                       B * G * N * 8, PEAK_FP32)
    out.append({"name": "knn", "route": "cuda",
                "source": "uni_adapter_torch/csrc/knn.cu",
                "replaces": "uni_adapter_tpu/ops/knn_pallas.py:201",
                "max_abs_err": 0,
                "ms": time_ms(lambda: knn.knn_cuda(M, xyz, center)),
                "plain_ms": time_ms(lambda: knn.knn_plain(M, xyz, center)),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

    Bt, T, D, H = 2, 513, 1024, 16
    hd = D // H
    bf16 = torch.bfloat16

    def rnd(*shape, std=1.0, dtype=bf16):
        return (torch.randn(*shape, generator=gen, device="cuda") * std
                ).to(dtype)

    xn = rnd(Bt, T, D)
    w = [rnd(D, D, std=D ** -0.5) for _ in range(4)]
    b = [rnd(D, std=0.02) for _ in range(3)]
    ln = [BLOCK_LN_GAMMA + rnd(hd, std=0.1, dtype=torch.float32),
          rnd(hd, std=0.1, dtype=torch.float32),
          BLOCK_LN_GAMMA + rnd(hd, std=0.1, dtype=torch.float32),
          rnd(hd, std=0.1, dtype=torch.float32)]
    args = (xn, w[0], b[0], w[1], w[2], b[1], *ln, w[3], b[2])
    got = attention.eva_attn_block_cuda(*args, num_heads=H).float()
    want = attention.eva_attn_block_plain(*args, num_heads=H).float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    if not torch.isfinite(got).all():
        fail("eva_attn_block: non-finite output")
    r, atol = block_err(got, want), block_atol(want)
    print(f"eva_attn_block: max abs err {err}, err/tolerance {r:.3f} "
          f"(rtol {BLOCK_RTOL}, atol {atol:.5f} = {BLOCK_ATOL_RMS} × "
          f"output RMS)")
    if r > 1:
        bad = ~torch.isclose(got, want, rtol=BLOCK_RTOL, atol=atol)
        fail(f"eva_attn_block: {bad.sum().item()} of {got.numel()} outside "
             f"the tolerance; first want/got "
             f"{want[bad][:4].tolist()} / {got[bad][:4].tolist()}")
    check_block_tolerance(torch, attention, args, want, H)
    Mt = Bt * T
    flops = 2 * Mt * D * 4 * D + 4 * Bt * H * T * T * hd
    n_bytes = 2 * Mt * D * 2 + 4 * D * D * 2 + 3 * D * 2 + 4 * hd * 4
    b_ms, b_by = bound(n_bytes, flops, PEAK_BF16)
    out.append({"name": "eva_attn_block", "route": "cuda",
                "source": "uni_adapter_torch/csrc/eva_attn_block.cu",
                "replaces": "uni_adapter_tpu/ops/attention_pallas.py:308",
                "max_abs_err": err,
                "ms": time_ms(lambda: attention.eva_attn_block_cuda(
                    *args, num_heads=H)),
                "plain_ms": time_ms(lambda: attention.eva_attn_block_plain(
                    *args, num_heads=H)),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    for k in out:
        print(f"kernel {k['name']}: max_abs_err {k['max_abs_err']} | "
              f"{k['ms']:.4f} ms (plain {k['plain_ms']:.4f} ms, bound "
              f"{k['bound_ms']:.5f} ms by {k['bound_by']})")
    return out


def check_features(torch, gen) -> None:
    """Depth-2 Uni3D at full width: the card's kernels against the CPU's
    plain versions on the same bf16 weights and input."""
    from uni_adapter_torch.config import ModelConfig
    from uni_adapter_torch.models.uni3d import create_uni3d

    cfg = ModelConfig(eva_depth=2)
    gpu = create_uni3d(cfg, "cuda", seed=0)
    cpu = create_uni3d(cfg, "cpu", state_dict={
        k: v.float().cpu() for k, v in gpu.state_dict().items()})
    pc = torch.cat([torch.randn(2, 1024, 3, generator=gen, device="cuda"),
                    torch.ones(2, 1024, 3, device="cuda")], dim=-1)
    with torch.no_grad():
        f_gpu = gpu(pc).cpu()
        f_cpu = cpu(pc.cpu())
    cos = torch.nn.functional.cosine_similarity(f_gpu, f_cpu, dim=-1)
    print(f"features (depth 2, width 1024, bf16): cosine card vs cpu "
          f"{cos.tolist()}, max abs diff "
          f"{(f_gpu - f_cpu).abs().max().item():.4g}")
    if not (torch.isfinite(f_gpu).all() and cos.min() > 0.99):
        fail("features on the card disagree with the CPU's plain path")


def run_main_path(torch, tmp: Path) -> dict:
    import numpy as np

    from uni_adapter_torch.cli import tta
    from uni_adapter_torch.data.datasets import MODELNET40_CLASSES
    from uni_adapter_torch.ops import attention, fps, knn

    n_clouds, n_points = 16, 1024
    rng = np.random.default_rng(0)
    labels = rng.integers(0, len(MODELNET40_CLASSES), n_clouds)
    pts = rng.standard_normal((n_clouds, n_points, 3)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    pts *= (0.5 + 0.1 * (labels % 5))[:, None, None].astype(np.float32)
    np.save(tmp / "data_uniform_5.npy", pts)
    np.save(tmp / "label.npy", labels.astype(np.int64))

    fps.farthest_point_sample.launches = 0
    knn.knn.launches = 0
    attention.eva_attn_block.launches = 0
    summary = tta.main(["--root", str(tmp), "--corruption", "uniform",
                        "--precomputed-text-features", "large",
                        "--device", "cuda", "--output-dir", str(tmp / "out"),
                        "--name", "smoke"])
    launches = {"fps": fps.farthest_point_sample.launches,
                "knn": knn.knn.launches,
                "eva_attn_block": attention.eva_attn_block.launches}

    step_ms = summary["step_ms"]["uniform"]
    steady = statistics.median(step_ms[1:])
    print(f"main path: {len(step_ms)} steps, first {step_ms[0]:.1f} ms, "
          f"then median {steady:.2f} ms/step ({1e3 / steady:.2f} pc/s), "
          f"mean {statistics.mean(step_ms[1:]):.2f}, "
          f"max {max(step_ms[1:]):.2f}")
    print(f"launches: {launches}")
    print(f"final logits finite: {summary['finite']['uniform']}")
    # three block kernels (q/k/v GEMM, attention, out GEMM) per layer
    want = {"fps": n_clouds, "knn": n_clouds,
            "eva_attn_block": n_clouds * 24 * 3}
    for name, n in want.items():
        if launches[name] < n:
            fail(f"{name} launched {launches[name]} times on the main path, "
                 f"expected at least {n}")
    if not summary["finite"]["uniform"]:
        fail("non-finite final logits")
    for f in ("results.json", "results_zs.json"):
        res = json.loads((Path(summary["log_dir"]) / f).read_text())
        if set(res) != {"uniform"}:
            fail(f"{f}: unexpected content {res}")
    return launches


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    try:
        from uni_adapter_torch.ops import build
    except ImportError as e:
        fail(f"the uni_adapter_torch package is not beside this script ({e})")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s ({len(logs)} sources "
          f"compiled)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    from uni_adapter_torch.cli.tta import set_numerics

    set_numerics()
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = check_kernels(torch, gen)
    check_features(torch, gen)
    with tempfile.TemporaryDirectory() as tmp:
        launches = run_main_path(torch, Path(tmp))
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
