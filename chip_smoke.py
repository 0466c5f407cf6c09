"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card, `nvcc` and
PyTorch built for CUDA.  Phases, each printed as it ends; any failure
exits non-zero before the result line:

  1. the card's name and power limit (nvidia-smi);
  2. building the CUDA kernels of `uni_adapter_torch/csrc/` with one
     `nvcc` per source, all started together (registers and spills of
     each kernel printed), and reading the EVA block's SASS: its bf16 GEMM
     must hold HGMMA (wgmma) instructions, its fp32 GEMM no tensor-core
     instruction, its fp32 attention step (attn_f32_tc_kernel) HMMA;
  3. each kernel at its main-path shapes against its plain PyTorch version
     on the card: FPS, kNN and ball-query indices exactly (ball query also
     on over-full and on empty balls); both kNN kernels (knn.cu, and the
     large-cloud kNN + gather, values bitwise) exactly, ten launches each,
     with FPS centres as queries from 1 to 10,000 points (k = 1, k = N,
     k = 128, N = 33, both sides of knn.cu's 2048-point limit and of a
     second tile edge) and on four hard clouds at 1024, 3000 and 10,000
     points (every point twice, every point with a near copy, all points
     equal, points ever nearer the queries), timed beside the
     reference's own route (a dense distance matrix and `torch.topk`) as
     a yardstick; FPS
     exactly through `farthest_point_sample` (the cloud's size picks the
     kernel) from 1 to 20,000 points (both sides of a warp, of fps.cu's
     1024-point class and of its 4096-point limit, 8192 and 8193, npoint
     = N, 30-cloud batches of 1024 and 10,000 points), every case launched
     several times, on three tie clouds (every point twice, every point equal, a
     lattice) at 1024 and 10,000 points and on both sides of the largest
     cloud a cluster holds in registers, from both FPS kernels wherever
     both take N, each fps_grid launch's cluster printed; the attention
     block and the natural-layout attention within a bf16 tolerance that
     planted faults must fail, the bf16 attention core also at its edges
     (one key, one whole 64-key chunk, one key past it, 2049 keys, a grid
     of several waves); with kernel and plain times (median of 20 runs, CUDA events,
     back to back), the least time the card could take (bound) and, for
     the attention, PyTorch's `scaled_dot_product_attention` on the same
     inputs as a yardstick (the port never calls it), the attention
     kernels and the yardstick also in device time (torch.profiler, the
     sum of the kernels' durations per call), FPS, kNN, ball query and
     the large-cloud kernels too; the block's two GEMMs each in device
     time per launch beside their bounds and cuBLAS's time for the same
     products (`F.linear`, a yardstick); then the fp32
     kernels (the (B, H, N, hd) attention, the natural layout with and
     without its LayerNorm, the block) within an fp32 tolerance that
     three planted faults (operands rounded to bf16, to TF32, the last
     key dropped) must each fail by 5×; both entries of the block at one
     token, 65 tokens at width 384, the main path's shape and a 30-batch
     grid of several waves, and the projections' last K tile skipped as a
     planted fault of each; the block's attention step in device time
     beside its bounds and SDPA's; the split-TF32 fp32 attention kernel
     (attn_f32_tc_kernel, every fp32 main path's) at its edges (1 to 2049
     keys, each of its block shapes, B·H up to 480) and at the block's
     step, with the same tolerance and faults, and which fp32 kernel each
     entry runs read from the profiler's trace; float16 raising in every
     attention wrapper; then kNN (k 64 and 32), the ball query and the
     natural-layout attention at the 15-corruption sweep's batch of 30
     clouds (indices exactly in ten launches each, the attention within
     the bf16 tolerance that its two planted faults must fail), timed;
  4. features (and attention maps) of Uni3D, OpenShape-G and ULIP-2 at
     depth 2 and full width on the card (kernels) against the CPU (plain
     versions), the same weights in bf16; Uni3D and OpenShape-G also on
     10,000-point clouds; then all three in fp32 within 1 − cosine 1e-4
     (maps within 1e-5), each forward on its fp32 kernels alone; then
     OpenShape-G with `rel_pe` (the biased attention, no attention
     kernel) and the `local` / `hierarchical` cache types (k-means
     centres) against the CPU, fp32 and bf16, and `ops/pointnet.py`'s
     multi-scale set abstraction on 1024- and 10,000-point clouds (FPS
     on fps.cu / fps_grid.cu, the ball query on its kernel) and its
     feature propagation;
  5. the three main paths through `uni_adapter_torch.cli.tta.main`, each at
     its published widths and depth in bf16 with random weights from a
     seed, MODE-DOTA defaults with residual learning, over a synthetic
     16-cloud corruption stream: Uni3D-L (24 EVA blocks, width 1024) on
     the bundled anchors, OpenShape PPTA-G (12 blocks, width 512) on a
     seeded (40, 1280) bank and ULIP-2 Point-BERT (12 blocks, width 384)
     on a seeded (40, 512) bank, both written as .npy files.  The kernels'
     launch counters are zeroed just before each path and read just after,
     and the path runs under a torch.profiler trace of the device: its
     launches are the port's kernels in the trace (a wrapper counts a
     launch that a CUDA graph's capture records, and no replay), every
     kernel of the path must have run and no kernel or wrapper of
     another; then two paths on clouds
     above the register kernels' limits: Uni3D-L on an Objaverse-LVIS
     stream of 10,000-point clouds with a seeded (1156, 1024) bank
     (`fps_grid` and `knn_gather`, never `fps` or `knn`), and ULIP-2 on a
     ScanObjectNN stream at `--npoints 8192` with a seeded (15, 512) bank
     (the same two kernels, never `fps` or `knn`); then the three
     1024-point paths with `--compute-dtype float32` (the fp32 kernels,
     no bf16 attention kernel); then Uni3D-L on the prototype cache
     path (`--dota-use-mode-dota false`: one forward of the batch-1
     cloud a step) on ModelNet40 (the dense graph, the CG) and on
     ShapeNetCore-C (55 classes, the explicit solve), the CG's
     iterations printed; then Uni3D-L's MODE-DOTA and cache paths again
     with `--use-scan false` (the eager step loop: every path above runs
     the CLI's default, the stream's scan, whose step is captured as a
     CUDA graph and replayed; here the trace's launches must equal the
     wrappers' counts); plain DOTA, GMM-DOTA and adaptive-modes DOTA on
     Uni3D-L (`uni3d_dota`, `uni3d_gmm`, `uni3d_adaptive`, captured, and
     `uni3d_dota_eager`), each launching exactly one batch-1 forward's
     kernels a step; `--compute-dtype float16` raising; `--use-scan false
     --batch-size 3` over the 16 clouds (6 steps, 16 clouds counted: the
     short last batch kept); and one `--profile-dir` run, its trace read;
  6. bench.py's eight configurations as 15-corruption sweeps (Uni3D-L,
     ULIP-2, OpenShape-G at published widths and depth, bf16) through
     `cli.tta.main --corruption all --vmap-corruptions true` on 15
     synthetic 16-cloud streams, one a corruption: the three MODE-DOTA
     headline sweeps (the 15 streams' 2·15 clouds through the encoder in
     one forward a step), the Uni3D-L cache sweep (15 clouds a step),
     and at Objaverse-LVIS's 1156 classes (a seeded bank, 1024 points)
     the cache at shot capacity 8 (the prototype graph) and MODE-DOTA at
     each residual precision tier, each traced as in phase 5; every
     kernel of the path launched at least as often as 16 batch-1 steps
     launch it, none of the others;
     15 keys in the result files; finite logits; ms a step and pc/s
     printed (beside the batch-1 path's of phase 5 where the stream is
     the same), and the cache's CG iterations.  Then `engine.run_streams`
     against the same 3 streams run one by one (`engine.run_stream`),
     Uni3D at width 1024 and depth 2 in fp32: MODE-DOTA (the same noise
     to both) with residual learning off (4 steps) and on (2 steps), and
     the cache (8 steps, each stream's CG iterations equal to its own
     run's); the cache's functions on the card against the CPU on a
     seeded feature sequence at K 40 / C 2 (dense) and K 1156 / C 8
     (prototype), with three planted faults that must fail the
     tolerance; the 'default' tier's product checked and the three
     tiers' products timed; the captured step against the eager loop
     (`engine.run_stream_scan`, `run_streams_scan`; ms a step of each):
     two generators' draws in four replays equal to their eager draws,
     `fps_grid`'s cluster launch captured at 10,000 and 24,576 points
     equal to an eager launch, Uni3D width 1024 depth 2 fp32 with
     residuals off (8 steps, logits within 1e-4) and on at 'highest' and
     'high' (2 steps: logits within 1e-3, residuals in the streams
     check's envelope, the Adam count 10), Uni3D-L bf16 MODE-DOTA
     with residuals at batch 1 (16 steps), on the cache (ModelNet40's CG,
     ShapeNetCore's explicit solve; 8 steps: CG iterations identical, the
     final caches' refined labels equal) and ULIP-2's 15-stream sweep (4
     steps), each full-size path's replays traced with torch.profiler:
     two replayed steps must launch each port kernel exactly as often as
     two eager steps; and `--continual true` (Uni3D-L, traced) through
     15 streams of 4 clouds, each corruption's step counter starting
     where the one before ended.  The other DOTA variants as sweeps
     (captured; plain DOTA also eager), with `--continual` (2 clouds a
     stream), their stream runs against their streams one by one, each
     captured against its eager loop at full width (adaptive DOTA over
     60 steps, a split inside the captured graph at σ 1e-6), and their
     functions on the card against the CPU at K 40 and 1156 with planted
     faults (`VARIANT_TOL`), DOTA's update (the Λ inverse) timed;
  7. the attention-map extraction path of each backbone at full width and
     depth through `uni_adapter_torch.cli.extract_attention` on the
     synthetic sphere (the whole `main` where matplotlib imports, its
     device half `extract` otherwise): 24 / 12 / 12 maps in
     `attention_maps.npz`, one (B, H, N, hd) attention launch per layer,
     none of the block or natural-layout kernels; then each in fp32
     (`build_backbone` with `compute_dtype="float32"` through
     `AttentionExtractor`): one fp32 (B, H, N, hd) launch per layer and no
     other attention kernel;
  8. the text side and checkpoint loading: the CLIP text tower (plain
     PyTorch, no kernel) at the `uni3d` preset's full width and depth 2,
     card against CPU in fp32 and bf16, its fp32 projection with TF32
     allowed (a TF32 product as the planted fault), and ModelNet40's bank
     (2560 prompts) built by the full `uni3d` and `ulip` towers, drawn on
     the card, in bf16 and fp32, timed; Uni3D-L, ULIP-2, OpenShape-G and
     the `uni3d` tower written as reference-layout checkpoints
     (`scripts/reference_layouts.py`) and loaded by `models/loader.py`
     into models from another seed: reports CLEAN, parameters and
     features bitwise equal to the source's; then Uni3D-L through
     `cli.tta.main --checkpoint-path` with no bank (anchors (40, 1024)
     from the text tower, no random-weights warning, the `uni3d` path's
     kernels, traced), `extract_attention --checkpoint` on the same file,
     and `build_anchors --clip-checkpoint` against `clip_classifier`
     in-process (max |Δ| 0);
  9. serving and the int8 trunk: `serve.TTAServer` against each client's
     own `engine.run_stream` (Uni3D width 1024, depth 2, fp32, 4 clients
     on ragged ticks that stack clients at step 0 with older ones:
     MODE-DOTA with and without residual learning, the cache) and its
     blocking and non-blocking snapshots restored into a fresh server
     (the next tick bitwise equal); the serving path at full width
     (`serve_uni3d`: `cli.serve.main` in-process, Uni3D-L bf16, --warmup,
     6 `TTAClient`s posting from threads for 8 rounds, a 404 and a 400
     among them, one tick traced; ms a chunk, a tick and a request); then
     `QuantDense`'s int8 operands and int32 products card against CPU
     bitwise at Uni3D-L's shapes (`torch._int_mm`'s limits printed), a
     quantised Uni3D-L at depth 2 card against CPU (fp32) and against the
     bf16 trunk, and the int8 TTA path `uni3d_int8` (`--quantize-int8
     true`, captured: 24 launches of the (B, H, N, hd) attention kernel a
     forward, none of the block kernel).
 10. training: each wrapper whose kernel returns values and has no
     backward raising under grad on inputs that require grad (the bf16
     block, the natural layout, kNN + gather, the (B, H, N, hd)
     attention); Uni3D-L pretraining through `cli.pretrain` (full width
     and depth, fp32, 10,000-point clouds, a global batch of 16 from a
     seeded two-shard corpus written as .npy files, read by the native
     loader): a run of PRETRAIN_STEPS steps traced (each backward kernel
     once a block a step, the plain backward never, the loss finite and
     falling), `python -m uni_adapter_torch.cli.pretrain` stopped at half
     way with a checkpoint and `--resume`d to the end, bitwise equal to
     the uninterrupted run; ms a step, samples a second and peak memory;
     then the dVAE at Point-BERT's widths: one step's loss and gradients
     card against CPU on the same weights and Gumbel draw, three train
     steps traced (FPS and kNN).
 11. data parallelism over torch.distributed and the cross-class
     analysis (`run_dist_streams`, `run_dp_pretraining`,
     `run_cross_class`): Uni3D-L bf16 MODE-DOTA with residuals on a
     16-cloud stream, captured, at world 1 over NCCL (this process):
     `--dist-mode sharded` and `psum` (the step captured in segments, the
     all-reduces between their replays, traced) bitwise equal to the
     plain scan; at world 2, two spawned processes sharing the card over
     gloo (`parallel/bootstrap.py` picks it): sharded bitwise equal to
     the two shards run here one by one (seeds 42, 43), psum (noise 0,
     residuals off) in fp32 within tests/test_parallel.py's tolerances of
     one process at batch 2 with acc@1 equal (targets that the reference
     meets on half the clouds) and both ranks bitwise equal, the 16-stream
     sweep's ranks bitwise equal to their 8 streams run here and its
     per-stream acc@1 equal to the 16 run together; with two cards or
     more the same again over NCCL; ms a step of each mode beside the
     plain step, the all-reduces' share of the psum run from a trace, the
     launches of FPS, kNN and the block a rank.  The data-parallel train
     step: at world 1 over NCCL bitwise equal to `train_step` (Uni3D-L
     fp32, full depth, batch 16, 2 steps, traced); at world 2 over gloo
     (depth 2, global batch 16) the loss and gradient norm within 1e-5
     and 99% of the parameters within 1e-2·lr of one process's;
     `python -m torch.distributed.run --nproc-per-node 2 -m
     uni_adapter_torch.cli.pretrain` stopped with rank 0's checkpoint and
     resumed on both ranks.  The cross-class CLI on its synthetic class
     set (Uni3D-L bf16, full depth, traced: FPS, kNN, the (B, H, N, hd)
     attention), its centroids and distances card against CPU, its exact
     t-SNE card against CPU from the same init.
 12. class-sharded adaptation (`run_ep`, `parallel/ep.py`): at world 1
     over NCCL in this process, Uni3D-L bf16 on 16 10,000-point clouds
     with a seeded (1156, 1024) bank, MODE-DOTA captured in segments:
     residuals off bitwise equal to the plain scan, residuals on within
     the residual envelope, traced (fps_grid, knn_gather, the block); at
     world 2 (two processes sharing the card over gloo) the same runs
     held to the plain scan (residuals on: acc@1 equal, the distance
     printed beside the plain scan's with the classes permuted), one
     gradient of the sharded residual loop within 1e-5 of the
     replicated one's largest entry (a planted fault, the dx sum
     skipped, must fail it), every method at K 15 (1024-point clouds, full
     depth; MODE-DOTA with `shard_encoder` in fp32, plain DOTA, GMM-DOTA,
     adaptive, the cache dense and prototype) at tests/test_ep_*.py's
     tolerances, plain DOTA at K 1156 with each
     rank's peak memory beside one process's, and
     `TTAServer(dist_mode='ep')` against its clients' streams; at world 4
     `run_streams_ep` on a 2 × 2 grid against `run_streams_scan`; the CLI
     (`torch.distributed.run ... --dist-mode ep` with `--continual` and
     with `--vmap-corruptions`) and `cli.serve --dist-mode ep` over HTTP
     on two ranks.  ms a step, peak memory, segments a step and the
     launches of FPS, kNN and the block a rank are printed.
 13. the tensor-parallel trunk (`run_tp`, `parallel/tp.py`): at world 1
     over NCCL in this process, Uni3D-L bf16 at full width and depth,
     MODE-DOTA with residuals, 16 clouds captured through
     `prepare_trunk_parallel`'s encoder, bitwise equal to the plain scan
     and traced (FPS, kNN, the block); at world 2 (two processes sharing
     the card over gloo) Uni3D-L's features in bf16 and fp32 (the
     block's fp32 entry) against one process's, its captured bf16 stream
     traced (every block launch the head-sharded entry; segments a step,
     the all-reduces' share of host time, ms a step), the fp32 MODE-DOTA
     trajectory's logits within 1e-4 with acc@1 equal, two planted
     faults (`bo` added on every rank, one `fc2` sum skipped) failing
     the fp32 tolerance, OpenShape-G's and ULIP-2's features (the natural
     layout on the rank's heads); at world 4 EP × TP on a (classes,
     model) = (2, 2) grid against the plain scan and Uni3D-L refusing 4
     ranks (SwiGLU width 2730); the CLI (`torch.distributed.run ...
     --trunk-parallel tp`) and `cli.serve --trunk-parallel tp` over
     HTTP on two ranks.
 14. the pipeline-parallel trunk (`run_pp`, `parallel/pp.py`): at world 1
     over NCCL in this process the same captured Uni3D-L stream through
     `prepare_trunk_parallel`'s PP encoder, bitwise equal to the plain
     scan and traced; at world 2 (two processes sharing the card over
     gloo) Uni3D-L's features in bf16 and fp32, GPipe and interleaved
     (V = 2), at one microbatch bitwise one process's, its captured bf16
     stream bitwise the plain scan's and traced (ms a step, segments a
     step, bytes shifted and broadcast a step, peak GB a rank beside one
     process's, launches a rank), the fp32 trajectory's logits within
     1e-4 with acc@1 equal, the planted fault 'one stage's shift skipped'
     failing, OpenShape-G's and ULIP-2's features bitwise; pretraining at
     full width (Uni3D-L fp32, depth 24, batch 16 of 10,000 points, two
     stages of two microbatches) against one process (the loss within
     rtol 1e-5, 99% of the parameters within DP_PARAM_ATOL), and at depth
     2 a run resumed from the gathered checkpoint bitwise the
     uninterrupted one; at world 4 PP × TP (two stages of two model
     ranks, depth 2, fp32) against one process; the CLI
     (`torch.distributed.run ... --trunk-parallel pp`) and `cli.serve
     --trunk-parallel pp` over HTTP on two ranks.
 15. the sequence-parallel trunk (`run_sp`, `parallel/sp.py`, exact ring
     attention in plain PyTorch, no row 3): at world 1 over NCCL in this
     process the same captured Uni3D-L stream through
     `prepare_trunk_parallel`'s SP encoder, its features within cosine
     0.99 (bf16) and 1 − 1e-4 (fp32) of the plain forward's, traced (FPS
     and kNN only), ms a step beside the plain scan's; at world 2 (two
     processes sharing the card over gloo) Uni3D-L's bf16 and fp32
     features against world 1's (fp32 within SP_F32_ATOL: only the fold
     order differs), the planted fault 'the last arriving block's fold
     skipped' failing it, ULIP-2's features, the fp32 MODE-DOTA
     trajectory's logits within 1e-4 of one process's with `correct`
     equal, the captured bf16 stream traced (ms a step, segments a step,
     24·(S − 1) shifts a forward and the bytes they send, peak GB a
     rank); pretraining at full width (Uni3D-L fp32, depth 24, batch 16
     of 10,000 points) against one process, and a depth-2 checkpoint
     saved at world 2 resumed here at world 1; at world 4 SP × DP on a
     (data, seq) = (2, 2) grid (fp32, depth 2) against one process; the
     CLI (`torch.distributed.run ... --trunk-parallel sp`) and
     `cli.serve --trunk-parallel sp` over HTTP on two ranks.

The launches of phases 11 to 15 (the pretraining CLI's two, the EP and
trunk CLIs and their servers) start together after phase 15
(`run_clis`): none is timed beyond its own wall seconds.  Every process
the script starts (`spawn`) is ended with all it started when the
script exits, failing or not.

Phase 3 also holds the block's head-sharded entry (a tensor-parallel
rank's heads: q/k/v (64H, D), out projection (D, 64H), no `bo`: the fp32
partial sum) at (2, 513, 1024) with 8 and 4 heads, bf16 and fp32,
against the plain version with the planted fault 'last K tile skipped',
timed per call and per launch beside cuBLAS's GEMMs.

Phase 3 also holds the backward of the fp32 block's attention side
(`csrc/eva_attn_block_bwd.cu` through `EvaAttnBlockFunction`) at Uni3D-L's
shape: its twelve gradients against the plain backward within the fp32
tolerance, two planted faults (TF32-rounded operands, a key tile's dk and
dv dropped), its four kernels in device time beside SDPA's fp32 backward.

Phase 3 also holds the (B, H, N, hd) attention at the three extraction
shapes and three general head dims, and phase 4 runs each backbone with
`return_attn` too: features against the CPU and against the card's own
plain forward, and the maps against the CPU's.

The line before the last is a JSON object of per-kernel numbers; the last
is `{"ok": true, "device": {...}}`.

    python3 chip_smoke.py --dist-only
    python3 chip_smoke.py --ep-only
    python3 chip_smoke.py --tp-only
    python3 chip_smoke.py --pp-only
    python3 chip_smoke.py --sp-only

builds the kernels and runs phase 11's distributed part and phases 12
to 15 alone (`run_dist_streams`, `run_dp_pretraining`, `run_ep`,
`run_tp`, `run_pp`, `run_sp`): on a machine with two cards or more that
is where the worlds of two run over NCCL, a card a rank, besides gloo
(with four, phase 13's to 15's worlds of four too).  `--ep-only` builds
the kernels and runs phase 12 alone, `--tp-only` phase 13, `--pp-only`
phase 14, `--sp-only` phase 15.  Each prints its phases' summary and the
same last line.  Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import atexit
import collections
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and TF32 tensor cores,
# fp32 outside the tensor cores, HBM3 bandwidth.
PEAK_BF16 = 989e12
PEAK_TF32 = 494.7e12
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
# fp32 tolerance of the fp32 kernels (the block, the natural layout and
# the (B, H, N, hd) attention) against their plain versions: the same
# form, rtol 1e-4 and atol 1e-4 of the output's RMS.  Both sides compute
# in fp32 (TF32 off for the plain version's products), so they differ only
# in summation order, in the kernels' online softmax, in when exp() takes
# its max, and, in the split-TF32 attention (attn_f32_tc_kernel), in the
# ~2⁻²¹ of each product that its three TF32 products leave out: a few fp32
# ulps in each score and in q and k after the block's K = 1024 products,
# which peaked logits (std ≈ 5) carry into the output as ~1e-6 of its
# RMS (FFMA) and, on an H100, 2e-5 to 7e-5 of it (split TF32, more with
# more keys; its numerics are modelled on the CPU by
# tests/test_torch_fp32.py).  What the tolerance is for, a kernel that
# does not keep fp32, fails it by far more than
# F32_FAULT_MARGIN: operands rounded to TF32 (2⁻¹¹ relative) move logits
# by ~2e-3 and outputs by ~1e-3 of their RMS, to bf16 eight times that
# (`check_f32`'s planted faults; on the CPU's plain versions 45× and 335×
# at the least), and a dropped key moves them by O(1).
F32_RTOL, F32_ATOL_RMS = 1e-4, 1e-4
F32_FAULT_MARGIN = 5
# γ of the per-head q/k LayerNorms in the block check: softmax logits of
# std ≈ γ² ≈ 5 over 513 keys, so attention is peaked (as in a trained
# model) and a key the kernel drops or miscounts moves the output by O(1).
BLOCK_LN_GAMMA = 2.2


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


#: Every process this script started through `spawn`; when the script
#: exits, `stop_spawned` ends those still running and all they started.
SPAWNED: list = []


def spawn(cmd: list, **kw) -> subprocess.Popen:
    """subprocess.Popen(cmd, **kw), remembered in SPAWNED."""
    proc = subprocess.Popen(cmd, **kw)
    SPAWNED.append(proc)
    return proc


def process_tree(pid: int) -> list:
    """`pid` and every process under it, read from /proc.  The children
    of a `torch.distributed.run` launch run in sessions of their own, so
    only the parent links reach them."""
    children = collections.defaultdict(list)
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            text = stat.read_text()
        except OSError:
            continue
        ppid = int(text[text.rindex(")") + 2:].split()[1])
        children[ppid].append(int(stat.parent.name))
    tree, todo = [], [pid]
    while todo:
        tree.append(todo.pop())
        todo.extend(children[tree[-1]])
    return tree


def stop_process(proc: subprocess.Popen) -> None:
    """SIGKILL `proc` and every process under it (taken all at once, so
    that none is orphaned first), then reap `proc`."""
    if proc.poll() is None:
        for pid in process_tree(proc.pid):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    proc.wait()


@atexit.register
def stop_spawned() -> None:
    for proc in SPAWNED:
        stop_process(proc)


def run_cmd(cmd: list, timeout: float, **kw) -> subprocess.CompletedProcess:
    """subprocess.run(cmd, capture_output=True, text=True) through
    `spawn`: at the timeout the command and every process under it are
    ended, and TimeoutExpired raised."""
    proc = spawn(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                 text=True, **kw)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        stop_process(proc)
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


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


def trace_kernels(fn, calls: int, warmup: int = 3) -> list:
    """The CUDA kernels that torch.profiler records over `calls`
    back-to-back calls of fn() (after `warmup` untraced ones), in launch
    order."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sorted((ev for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda ev: ev.time_range.start)


def device_ms(fn, calls: int = 20, attempts: int = 3) -> float:
    """Device ms per call of fn(): the sum of the durations of the CUDA
    kernels that torch.profiler records over `calls` back-to-back calls,
    divided by `calls`.  What the card spends on the call, without the
    host's share that `time_ms` may show.  A trace that records no kernel
    at all (seen after some dozens of traces in one process) is taken
    again, up to `attempts` times."""
    for _ in range(attempts):
        total = sum(ev.device_time_total for ev in trace_kernels(fn, calls))
        if total > 0:
            return total / 1e3 / calls
    fail(f"torch.profiler recorded no device time in {attempts} traces")


def device_ms_by_launch(fn, n_launch: int, calls: int = 20,
                        attempts: int = 10) -> list:
    """(name, device ms) of each of the `n_launch` kernels that one call of
    fn() launches, in launch order: every n_launch-th kernel of a trace of
    `calls` calls, averaged.  A trace that does not hold n_launch kernels a
    call is taken again, up to `attempts` times (on an H100, three traces
    in a row once held 19 to 50 of 60 kernels)."""
    for _ in range(attempts):
        kern = trace_kernels(fn, calls)
        if len(kern) == n_launch * calls:
            return [(kern[i].name, sum(k.device_time_total
                                       for k in kern[i::n_launch])
                     / 1e3 / calls) for i in range(n_launch)]
        print(f"  (a trace held {len(kern)} kernels for {calls} calls of "
              f"{n_launch}: {sorted({k.name[:60] for k in kern})})")
    fail(f"torch.profiler did not record {n_launch} kernels a call in "
         f"{attempts} traces")


def bound(n_bytes: float, n_ops: float, peak_ops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def tc_bounds(n_bytes: float, n_ops: float) -> dict:
    """The bounds of an fp32 attention that runs attn_f32_tc_kernel:
    `bound_ms` by its own route, three TF32 products per fp32 product at
    PEAK_TF32 (the bound its share is taken against: the kernel may beat
    the other), and `bound_ffma_ms`, the fp32 products at PEAK_FP32."""
    b_ms, b_by = bound(n_bytes, 3 * n_ops, PEAK_TF32)
    return {"bound_ms": b_ms, "bound_by": b_by,
            "bound_ffma_ms": bound(n_bytes, n_ops, PEAK_FP32)[0]}


def block_atol(want, atol_rms: float = BLOCK_ATOL_RMS) -> float:
    return atol_rms * want.pow(2).mean().sqrt().item()


def block_err(got, want, rtol: float = BLOCK_RTOL,
              atol_rms: float = BLOCK_ATOL_RMS) -> float:
    """Largest |got − want| / (atol + rtol·|want|): at most 1 passes."""
    return ((got - want).abs()
            / (block_atol(want, atol_rms) + rtol * want.abs())).max().item()


def round_bf16(t):
    import torch

    return t.to(torch.bfloat16).float()


def round_tf32(t):
    """fp32 rounded to nearest even at TF32's 10 mantissa bits."""
    import torch

    b = t.contiguous().view(torch.int32)
    return ((b + 0xFFF + ((b >> 13) & 1)) & -8192).view(torch.float32)


def check_f32(what: str, got, want, faults: dict) -> float:
    """An fp32 kernel's output within the fp32 tolerance of its plain
    version's, and each planted fault ({name: (output, its reference)})
    at least F32_FAULT_MARGIN times outside it.  Returns the max abs err."""
    import torch

    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite output")
    err = (got - want).abs().max().item()
    r = block_err(got, want, F32_RTOL, F32_ATOL_RMS)
    print(f"{what}: max abs err {err:.3g}, err/tolerance {r:.4f} (rtol "
          f"{F32_RTOL}, atol {block_atol(want, F32_ATOL_RMS):.3g} = "
          f"{F32_ATOL_RMS} × output RMS)")
    if r > 1:
        fail(f"{what}: outside the fp32 tolerance")
    for fault, (bad, ref) in faults.items():
        rf = block_err(bad, ref, F32_RTOL, F32_ATOL_RMS)
        print(f"  planted fault '{fault}': err/tolerance {rf:.1f}")
        if rf < F32_FAULT_MARGIN:
            fail(f"{what}: the planted fault '{fault}' is not "
                 f"{F32_FAULT_MARGIN}× outside the fp32 tolerance")
    return err


def skip_last_k_tile(xn):
    """xn with its last 64 input features zeroed: what a projection GEMM
    that skips its last K tile computes."""
    bad = xn.clone()
    bad[..., -64:] = 0
    return bad


def check_block_tolerance(torch, attention, args, want, H) -> None:
    """The block tolerance must reject planted faults of the size a broken
    kernel would make: the tail key (key 512, alone in the last 64-key
    chunk) dropped, the k LayerNorm's γ/β ignored, and the projections'
    last K tile skipped."""
    xn, T = args[0], args[0].shape[1]
    dropped = attention.eva_attn_block_plain(
        xn[:, :T - 1].contiguous(), *args[1:], num_heads=H).float()
    ones, zeros = torch.ones_like(args[8]), torch.zeros_like(args[9])
    no_k_affine = attention.eva_attn_block_plain(
        *args[:8], ones, zeros, *args[10:], num_heads=H).float()
    short_k = attention.eva_attn_block_plain(
        skip_last_k_tile(xn), *args[1:], num_heads=H).float()
    for fault, got, ref in (("tail key dropped", dropped, want[:, :T - 1]),
                            ("k LayerNorm γ/β ignored", no_k_affine, want),
                            ("last K tile skipped", short_k, want)):
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
    times = fps_times(torch, fps.fps_cuda, xyz, G)
    out.append({"name": "fps", "route": "cuda",
                "source": "uni_adapter_torch/csrc/fps.cu",
                "replaces": "uni_adapter_tpu/ops/fps_pallas.py:105",
                "max_abs_err": 0,
                **{key: times[key] for key in ("ms", "device_ms", "ns_round",
                                               "plain_ms", "bound_ms",
                                               "bound_by")},
                "library_ms": None})

    center = index_points(xyz, got)
    got = knn.knn_cuda(M, xyz, center)
    want = knn.knn_plain(M, xyz, center)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"knn: {(got != want).sum().item()} indices differ")
    b_ms, b_by = bound((B * N * 3 + B * G * 3) * 4 + B * G * M * 4,
                       B * G * N * 8, PEAK_FP32)
    # knn.cu has no carried set: its work does not depend on the order
    knn_t = knn_times(torch, lambda: knn.knn_cuda(M, xyz, center),
                      lambda: knn.knn_plain(M, xyz, center), xyz, center, M)
    print(f"knn {(B, N, G, M)}: {knn_t}")
    out.append({"name": "knn", "route": "cuda",
                "source": "uni_adapter_torch/csrc/knn.cu",
                "replaces": "uni_adapter_tpu/ops/knn_pallas.py:201",
                "max_abs_err": 0, **knn_t,
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
                "device_ms": device_ms(lambda: attention.eva_attn_block_cuda(
                    *args, num_heads=H)),
                "plain_ms": time_ms(lambda: attention.eva_attn_block_plain(
                    *args, num_heads=H)),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "library_device_ms": None,
                "per_launch": block_launch_times(
                    torch, gen, attention.eva_attn_block_cuda, args, H,
                    PEAK_BF16)})
    out[0]["shapes"] = {"1024": times,
                        str(fps.MAX_POINTS): check_fps_at_its_limit(torch)}
    return out


def check_fps_at_its_limit(torch) -> dict:
    """fps.cu at the largest cloud it takes, (2, MAX_POINTS) → 512:
    indices equal to the plain version's, and its times (own generator,
    so the other checks' inputs do not move)."""
    from uni_adapter_torch.ops import fps

    B, N, G = 2, fps.MAX_POINTS, 512
    gen = torch.Generator(device="cuda").manual_seed(N)
    xyz = sphere_cloud(torch, gen, B, N)
    got = fps.fps_cuda(xyz, G)
    want = fps.fps_plain(xyz, G)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"fps at {N} points: {(got != want).sum().item()} indices differ")
    print(f"fps {(B, N, G)}: indices equal")
    return fps_times(torch, fps.fps_cuda, xyz, G)


def sphere_cloud(torch, gen, B, N):
    """(B, N, 3) points on a sphere of radius 0.5, as the streams hold."""
    xyz = torch.randn(B, N, 3, generator=gen, device="cuda")
    return 0.5 * xyz / xyz.norm(dim=-1, keepdim=True)


#: knn_gather's timed shapes, (B, N, S, k, C) with FPS centres as the
#: queries: the two main paths' (the first gives the entry's numbers).
KNN_GATHER_SHAPES = {"uni3d_lvis10k": (2, 10000, 512, 64, 6),
                     "ulip_scanobjectnn8192": (2, 8192, 512, 32, 3)}
#: The kNN contract's shapes, (B, N, S, k, C), FPS centres as the queries,
#: each through both kNN kernels where they take it (knn.cu: N ≤ 2048;
#: knn_gather.cu: k ≤ 128): the main paths', knn.cu's (Uni3D's and
#: ULIP-2's 1024 points), one point, N = 33 (not a multiple of 32) with
#: k = N and k = 1, k = N at 64 and 128 (knn_gather's most) and at 1024
#: (knn.cu alone), knn.cu's limit and one past it (a second tile), both
#: sides of a third tile, k = 128 on three tiles, and the cache paths'
#: batches (one cloud; 15 streams' one each).
KNN_CONTRACT_SHAPES = ((2, 10000, 512, 64, 6), (2, 8192, 512, 32, 3),
                       (2, 1024, 512, 64, 6), (2, 1024, 512, 32, 3),
                       (1, 1, 1, 1, 3), (2, 33, 33, 33, 2),
                       (2, 33, 16, 1, 1), (2, 64, 32, 64, 1),
                       (1, 128, 128, 128, 8), (1, 1024, 64, 1024, 0),
                       (2, 2048, 512, 64, 6), (2, 2049, 512, 64, 0),
                       (2, 4096, 512, 64, 3), (2, 4097, 512, 64, 3),
                       (1, 4097, 256, 128, 8), (1, 1024, 512, 64, 6),
                       (15, 1024, 512, 64, 6))
#: Sizes of the hard clouds (`knn_hard_clouds`): one tile; two tiles
#: (every point's copy 1500 indices later); the LVIS path's five.
KNN_HARD_POINTS = (1024, 3000, 10000)
#: Launches of each kernel on each case, every one equal to the plain
#: version's output.
KNN_REPEATS = 10


def fps_queries(torch, xyz, S):
    """The main paths' queries: the cloud's S FPS centres (cloud points:
    a query's own distance is +0 exactly, its nearest neighbour's
    tiny)."""
    from uni_adapter_torch.ops import fps
    from uni_adapter_torch.ops.geometry import index_points

    return index_points(xyz, fps.farthest_point_sample(xyz, S)).contiguous()


def knn_hard_clouds(torch, gen, N: int, S: int = 64) -> dict:
    """(1, N, 3) clouds that test the selection's edges, each with S
    queries: every point twice (copies N/2 apart, across tile edges; the
    first S points as queries), every point with a near copy N/2 apart
    (moved by ~1e-5, so the fp32 expansion gives many distances a hair
    below 0; the first S points as queries), every point equal (queries
    the first S), and points whose distance from the origin falls with
    their index (radius 1 down to 0.001) with the FPS centres of the
    innermost N/8 as queries: each tile lies nearer the queries than the
    tiles before, so every tile improves the carried set (knn_gather's
    worst case)."""
    half = sphere_cloud(torch, gen, 1, N // 2)
    twice = torch.cat([half, half], 1).contiguous()
    near = torch.cat([half, half + 1e-5 * torch.randn(
        half.shape, generator=gen, device="cuda")], 1).contiguous()
    equal = sphere_cloud(torch, gen, 1, 1).expand(1, N, 3).contiguous()
    radius = torch.linspace(1.0, 0.001, N, device="cuda")
    falling = (2 * sphere_cloud(torch, gen, 1, N)
               * radius[None, :, None]).contiguous()
    return {"every point twice": (twice, twice[:, :S].contiguous()),
            "near copies": (near, near[:, :S].contiguous()),
            "every point equal": (equal, equal[:, :S].contiguous()),
            "decreasing distance": (falling, fps_queries(
                torch, falling[:, -(N // 8):].contiguous(), S))}


def knn_cases(torch, gen) -> list:
    """(what, xyz, queries, k, values) of every kNN check: the
    KNN_CONTRACT_SHAPES on clouds of the streams' kind (xyz on a sphere,
    values its xyz and a colour) and the hard clouds at KNN_HARD_POINTS
    with k 64 and C 1 (values = the index)."""
    cases = []
    for B, N, S, k, C in KNN_CONTRACT_SHAPES:
        pc = cloud(torch, gen, B, N)
        xyz = pc[..., :3].contiguous()
        cases.append((f"{(B, N, S, k, C)}", xyz, fps_queries(torch, xyz, S),
                      k, pc[..., :C].contiguous()))
    for N in KNN_HARD_POINTS:
        index = torch.arange(N, dtype=torch.float32, device="cuda")
        for name, (xyz, q) in knn_hard_clouds(torch, gen, N).items():
            cases.append((f"{name}, (1, {N}, 64, 64, 1)", xyz, q, 64,
                          index[None, :, None].contiguous()))
    return cases


def check_knn_contract(torch, gen) -> None:
    """Both kNN kernels on every case of `knn_cases` where they take it,
    and `knn.knn` (the cloud's size picks the kernel): indices, and
    knn_gather's gathered values, bitwise equal to the plain version's in
    each of KNN_REPEATS launches.  On the hard clouds also: a query's own
    point and its copy are its first two neighbours, lower index first,
    and on the all-equal cloud the neighbours are 0..k-1."""
    from uni_adapter_torch.ops import knn
    from uni_adapter_torch.ops.knn_gather import (MAX_K, knn_gather_cuda,
                                                  knn_gather_plain)

    for what, xyz, q, k, vals in knn_cases(torch, gen):
        N = xyz.shape[1]
        want_idx, want_vals = knn_gather_plain(k, xyz, q, vals)
        runs = {"knn.knn": lambda: (knn.knn(k, xyz, q), None)}
        if N <= knn.MAX_POINTS:
            runs["knn.cu"] = lambda: (knn.knn_cuda(k, xyz, q), None)
        if k <= MAX_K:
            runs["knn_gather.cu"] = lambda: knn_gather_cuda(k, xyz, q, vals)
        for name, run in runs.items():
            for _ in range(KNN_REPEATS):
                idx, got = run()
                torch.cuda.synchronize()
                if not torch.equal(idx, want_idx):
                    fail(f"knn {what}: {(idx != want_idx).sum().item()} "
                         f"indices from {name} differ from the plain "
                         f"version's")
                if got is not None and not torch.equal(got, want_vals):
                    fail(f"knn {what}: {(got != want_vals).sum().item()} "
                         f"values from {name} differ from the plain "
                         f"version's")
        if what.startswith("every point twice"):
            pair = torch.stack([torch.arange(64, device="cuda")] * 2, 1)
            if not torch.equal(want_idx[0, :, :2], pair + torch.tensor(
                    [0, N // 2], device="cuda")):
                fail(f"knn {what}: a query's own point and its copy are not "
                     f"its first two neighbours, lower index first")
        if what.startswith("near copies") and not (
                knn.sqdist(xyz, q) < 0).any():
            fail(f"knn {what}: no distance below 0")
        if what.startswith("every point equal") and not torch.equal(
                want_idx[0], torch.arange(k, device="cuda").expand(64, k)):
            fail(f"knn {what}: the neighbours are not 0..k-1")
        print(f"knn {what}: indices and values equal from "
              f"{', '.join(runs)}, {KNN_REPEATS} launches each")


def knn_times(torch, run, plain, xyz, q, k) -> dict:
    """Times of one kNN call: back to back, device, plain, and as a
    yardstick (the port never calls it) the reference's own route, the
    dense (B, S, N) distance matrix and `torch.topk`, in device time."""
    from uni_adapter_torch.ops import knn

    return {"ms": time_ms(run), "device_ms": device_ms(run),
            "plain_ms": time_ms(plain),
            "dense_topk_device_ms": device_ms(lambda: torch.topk(
                knn.sqdist(xyz, q), k, dim=-1, largest=False))}


def check_knn_gather(torch, gen) -> dict:
    """knn_gather at KNN_GATHER_SHAPES and on the decreasing-distance cloud
    at 10,000 points with 1024 queries, as many as the LVIS path's (its
    worst case): indices and values equal to the plain version's, and its
    times."""
    from uni_adapter_torch.ops.knn_gather import (knn_gather_cuda,
                                                  knn_gather_plain)

    shapes = {}
    worst = knn_hard_clouds(torch, gen, 10000, 1024)["decreasing distance"]
    for name, (B, N, S, k, C) in {**KNN_GATHER_SHAPES,
                                  "decreasing distance":
                                      (1, 10000, 1024, 64, 6)}.items():
        if name == "decreasing distance":
            xyz, q = worst
            vals = torch.cat([xyz, xyz], -1).contiguous()
        else:
            pc = cloud(torch, gen, B, N)
            xyz = pc[..., :3].contiguous()
            vals = pc[..., :C].contiguous()
            q = fps_queries(torch, xyz, S)
        got = knn_gather_cuda(k, xyz, q, vals)
        want = knn_gather_plain(k, xyz, q, vals)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"knn_gather {name} {(B, N, S, k, C)}: differs from the "
                 f"plain version")
        b_ms, b_by = bound(
            (B * N * 3 + B * S * 3 + B * N * C) * 4
            + B * S * k * (4 + 4 * C), B * S * N * 8, PEAK_FP32)
        shapes[name] = {"shape": [B, N, S, k, C], **knn_times(
            torch, lambda: knn_gather_cuda(k, xyz, q, vals),
            lambda: knn_gather_plain(k, xyz, q, vals), xyz, q, k),
            "bound_ms": b_ms, "bound_by": b_by}
        print(f"knn_gather {name}: {shapes[name]}")
    first = shapes["uni3d_lvis10k"]
    return {"name": "knn_gather", "route": "cuda",
            "source": "uni_adapter_torch/csrc/knn_gather.cu",
            "replaces": "uni_adapter_tpu/ops/knn_pallas.py:130",
            "max_abs_err": 0,
            **{key: first[key] for key in ("ms", "device_ms", "plain_ms",
                                           "bound_ms", "bound_by")},
            "library_ms": None, "shapes": shapes}


#: fps_grid's timed shapes, (B, N, npoint): the 10,000-point path's (the
#: entry's numbers), the 8192-point path's and a 20,000-point cloud, all
#: in a cluster's registers.  `check_fps_grid` adds the device-memory
#: branch.
FPS_GRID_SHAPES = {"uni3d_lvis10k": (2, 10000, 512),
                   "ulip_scanobjectnn8192": (2, 8192, 512),
                   "20,000 points": (1, 20000, 512)}

#: The FPS contract's shapes, (B, N, npoint), through
#: `farthest_point_sample` (the cloud's size picks the kernel): one point,
#: both sides of a warp, of fps.cu's 1024-point class and of its limit
#: (4096), the large-cloud paths and 8193, npoint = N, and the fused
#: 15-stream × 2 batch of ROADMAP M6a at 1024 and 10,000 points (240
#: blocks: many clusters at once); and where static and dynamic shared
#: memory together first pass 48 KB (fps.cu from 3065 points, fps_grid
#: at 24 points a thread: 23,553 to 24,576), which needs the opt-in; and
#: the cache paths' batches, one cloud and 15 streams' one each.
FPS_CONTRACT_SHAPES = ((1, 1, 1), (2, 31, 31), (2, 32, 16), (2, 33, 33),
                       (2, 1024, 512), (2, 1025, 512), (2, 4096, 512),
                       (2, 4097, 512), (2, 8192, 512), (2, 8193, 512),
                       (2, 10000, 512), (1, 20000, 512), (30, 1024, 512),
                       (30, 10000, 512), (2, 3064, 512), (2, 3065, 512),
                       (2, 3072, 512), (1, 23552, 512), (1, 23553, 512),
                       (1, 24576, 512), (1, 1024, 512), (15, 1024, 512))
#: Launches of each kernel on each contract case: fps_grid's exchange has
#: no barrier, so a race would show as one launch that differs.
FPS_REPEATS = 5
#: Sizes of the tie clouds.
FPS_TIE_POINTS = (1024, 10000)


def tie_clouds(torch, gen, N: int) -> dict:
    """(1, N, 3) clouds on which FPS meets exact ties every round: every
    point twice (the copies N/2 apart), every point equal, and a lattice
    of integer coordinates scaled by 1/16 (exact in fp32, so equal
    distances are equal bits)."""
    half = sphere_cloud(torch, gen, 1, N // 2)
    a = round(N ** (1 / 3))
    while a ** 3 < N:
        a += 1
    i = torch.arange(N, device="cuda")
    lattice = torch.stack([i % a, i // a % a, i // (a * a)], -1) / 16
    return {"every point twice": torch.cat([half, half], 1),
            "every point equal": sphere_cloud(torch, gen, 1, 1).expand(
                1, N, 3).contiguous(),
            "lattice": lattice[None].float().contiguous()}


def fps_plan_text(fps, N: int) -> str:
    C, T, P = fps.fps_grid_plan(N)
    held = f"{P} points a thread" if P else "running minimum in device memory"
    return f"cluster of {C} blocks × {T} threads, {held}"


def check_fps_contract(torch, gen) -> None:
    """FPS indices equal to the plain version's at FPS_CONTRACT_SHAPES, on
    the tie clouds at FPS_TIE_POINTS, and at both sides of the largest
    cloud a cluster holds in registers: through `farthest_point_sample`
    (the cloud's size picks the kernel), and from both kernels wherever
    both take N, FPS_REPEATS launches each.  Prints each fps_grid launch's
    cluster; fails unless the 10,000-point cloud runs on more than one
    block."""
    from uni_adapter_torch.ops import fps

    limit = fps.fps_grid_register_points()
    print(f"fps_grid: a cluster holds up to {limit} points in registers, "
          f"device memory above")
    cases = [(f"{(B, N, G)}", sphere_cloud(torch, gen, B, N), G)
             for B, N, G in FPS_CONTRACT_SHAPES]
    for N in FPS_TIE_POINTS:
        cases += [(f"{name}, (1, {N}, 512)", xyz, 512)
                  for name, xyz in tie_clouds(torch, gen, N).items()]
    cases += [(f"(1, {N}, 512)", sphere_cloud(torch, gen, 1, N), 512)
              for N in (limit, limit + 1)]
    for what, xyz, G in cases:
        N = xyz.shape[1]
        want = fps.fps_plain(xyz, G)
        kernels = {"farthest_point_sample": fps.farthest_point_sample,
                   "fps_grid": fps.fps_grid_cuda}
        if N <= fps.MAX_POINTS:
            kernels["fps.cu"] = fps.fps_cuda
        for name, run in kernels.items():
            for _ in range(FPS_REPEATS):
                got = run(xyz, G)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    fail(f"fps {what}: {(got != want).sum().item()} indices "
                         f"from {name} differ from the plain version's")
        route = "fps.cu" if N <= fps.MAX_POINTS else "fps_grid"
        print(f"fps {what}: indices equal from {', '.join(kernels)}, "
              f"{FPS_REPEATS} launches each (picks {route}); fps_grid: "
              f"{fps_plan_text(fps, N)}")
    if fps.fps_grid_plan(10000)[0] < 2:
        fail("fps_grid: the 10,000-point cloud does not run on a cluster of "
             "more than one block")
    if fps.fps_grid_plan(limit)[2] == 0 or \
            fps.fps_grid_plan(limit + 1)[2] != 0:
        fail(f"fps_grid: the checks do not cover both branches (limit "
             f"{limit})")


def fps_times(torch, fn, xyz, G) -> dict:
    """Times of one FPS call: back to back, device, plain, bound and device
    ns a round (device ms / npoint; FPS is bound by its dependent rounds)."""
    from uni_adapter_torch.ops import fps

    B, N, _ = xyz.shape
    # bounds count indices as int32, as the TPU kernels return them
    b_ms, b_by = bound(B * N * 3 * 4 + B * G * 4, B * G * N * 9, PEAK_FP32)
    dev_ms = device_ms(lambda: fn(xyz, G))
    return {"shape": [B, N, G], "ms": time_ms(lambda: fn(xyz, G)),
            "device_ms": dev_ms, "ns_round": dev_ms * 1e6 / G,
            "plain_ms": time_ms(lambda: fps.fps_plain(xyz, G), runs=5,
                                per_run=1),
            "bound_ms": b_ms, "bound_by": b_by}


def check_fps_grid(torch, gen) -> dict:
    """fps_grid at FPS_GRID_SHAPES and on the device-memory branch: indices
    equal to the plain version's, and its times."""
    from uni_adapter_torch.ops import fps

    N_mem = fps.fps_grid_register_points() + 1
    shapes = {}
    for name, (B, N, G) in {**FPS_GRID_SHAPES,
                            "device memory": (1, N_mem, 512)}.items():
        xyz = sphere_cloud(torch, gen, B, N)
        got = fps.fps_grid_cuda(xyz, G)
        want = fps.fps_plain(xyz, G)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"fps_grid {(B, N, G)}: {(got != want).sum().item()} "
                 f"indices differ")
        shapes[name] = {**fps_times(torch, fps.fps_grid_cuda, xyz, G),
                        "plan": fps_plan_text(fps, N)}
        print(f"fps_grid {(B, N, G)}: indices equal; {shapes[name]}")
    first = shapes["uni3d_lvis10k"]
    return {"name": "fps_grid", "route": "cuda",
            "source": "uni_adapter_torch/csrc/fps_grid.cu",
            "replaces": "uni_adapter_tpu/ops/fps_pallas.py:133",
            "max_abs_err": 0,
            **{key: first[key] for key in ("ms", "device_ms", "ns_round",
                                           "plain_ms", "bound_ms",
                                           "bound_by")},
            "library_ms": None, "shapes": shapes}


def in_ball(xyz, new_xyz, r):
    """(B, S, N) membership, decided as the ball query decides it."""
    from uni_adapter_torch.ops import ballquery, knn

    return knn.sqdist(xyz, new_xyz) <= ballquery.squared_radius(r)


def query_ball_distances(torch, xyz, new_xyz, r, ns) -> int:
    """The distances this data needs: for each query, the points up to its
    ns-th in-ball point (all N when its ball holds fewer)."""
    hits = in_ball(xyz, new_xyz, r).to(torch.int32).cumsum(dim=-1)
    full = hits[..., -1] >= ns
    need = torch.where(full, (hits < ns).sum(dim=-1) + 1, hits.shape[-1])
    return int(need.sum().item())


#: The ball query's timed shapes, (B, N, S, nsample) at r 0.2 with the
#: FPS centres of sphere clouds as the queries: OpenShape-G's set
#: abstraction on the main paths' 1024 points (the entry's numbers), where
#: no ball is full, and on OpenShape's own 10,000-point clouds (Objaverse;
#: LARGE_CLOUD_KERNELS), where every ball is.
BALLQUERY_SHAPES = {"openshape1024": (2, 1024, 384, 64),
                    "openshape10k": (2, 10000, 384, 64)}
#: The contract's shapes, (B, N, S, nsample) at r 0.2 with FPS centres: the
#: two above, one point, both sides of a warp with nsample = N, N = 1023
#: (a batch's rows not 16-byte aligned), both sides of each tile size that
#: scripts/ballquery_configs.py tries, and 20,000 points (past every tile).
BALLQUERY_CONTRACT_SHAPES = (
    (2, 1024, 384, 64), (2, 10000, 384, 64), (1, 1, 1, 1), (2, 31, 31, 31),
    (2, 33, 33, 33), (2, 511, 384, 64), (2, 512, 384, 64),
    (2, 513, 384, 64), (2, 1023, 384, 64), (2, 1025, 384, 64),
    (2, 2047, 384, 64), (2, 2048, 384, 64), (2, 2049, 384, 64),
    (1, 20000, 384, 64))
#: Launches of the kernel on each case, every one equal to the plain
#: version's output.
BALLQUERY_REPEATS = 10


def ballquery_hard_clouds(torch, gen) -> dict:
    """(xyz, queries, r, nsample) clouds that test the selection's edges:
    every point in every ball (nsample = N at 300 points, 64 at 10,000);
    points at exactly d = r² from the origin (on the axes at ±0.25, half
    of them one ulp further out; the origin first among the queries);
    every point twice, N/2 apart; in every four queries a full ball, a
    partial one, an empty one and a full one centred on a cloud point
    (r 0.3); every ball over-full (a cloud shrunk 20×); and mostly empty
    balls (random queries, r 0.02)."""
    def sphere(B, N):
        return sphere_cloud(torch, gen, B, N)

    x = torch.tensor(0.25, device="cuda")
    out = torch.rand(1, 3000, generator=gen, device="cuda") < 0.5
    mag = torch.where(out, torch.nextafter(x, torch.ones_like(x)), x)
    sign = torch.where(torch.rand(1, 3000, generator=gen, device="cuda")
                       < 0.5, -1.0, 1.0)
    axis = torch.randint(0, 3, (1, 3000), generator=gen, device="cuda")
    axes = torch.nn.functional.one_hot(axis, 3).float()
    boundary = (axes * (sign * mag)[..., None]).contiguous()
    half = sphere(1, 5000)
    twice = torch.cat([half, half], 1).contiguous()
    dense, sparse = 0.05 * sphere(1, 1500), sphere(1, 1500) + 1.0
    mixed = torch.cat([sparse[:, :750], dense, sparse[:, 750:]],
                      1).contiguous()
    per_block = torch.tensor([[0.0, 0.0, 0.0], [1.75, 1.0, 1.0],
                              [9.0, 9.0, 9.0], [0.0, 0.0, 0.0]],
                             device="cuda").repeat(96, 1)[None]
    per_block[0, 3::4] = mixed[0, 750]
    main = sphere(2, 1024)
    small, large = sphere(2, 300), sphere(2, 10000)
    return {
        "every point in the ball, nsample = N": (
            small, sphere(2, 64).contiguous(), 2.0, 300),
        "every point in the ball": (large, fps_queries(torch, large, 384),
                                    2.0, 64),
        "d = r² exactly": (boundary, torch.cat(
            [torch.zeros(1, 1, 3, device="cuda"), sphere(1, 63)],
            1).contiguous(), 0.25, 1024),
        "every point twice": (twice, fps_queries(torch, twice, 384), 0.2,
                              64),
        "full, partial and empty in a block": (mixed, per_block.contiguous(),
                                               0.3, 64),
        "over-full": ((0.05 * main).contiguous(),
                      (0.05 * fps_queries(torch, main, 384)).contiguous(),
                      0.2, 64),
        "empty": (main, (2 * torch.rand(2, 384, 3, generator=gen,
                                        device="cuda") - 1), 0.02, 64)}


def ballquery_cases(torch, gen) -> list:
    """(what, xyz, queries, r, nsample) of every ball-query check: the
    BALLQUERY_CONTRACT_SHAPES on sphere clouds with FPS centres, r 0.2,
    then the hard clouds."""
    cases = []
    for B, N, S, ns in BALLQUERY_CONTRACT_SHAPES:
        xyz = sphere_cloud(torch, gen, B, N)
        cases.append((f"{(B, N, S, ns)}", xyz, fps_queries(torch, xyz, S),
                      0.2, ns))
    for what, (xyz, q, r, ns) in ballquery_hard_clouds(torch, gen).items():
        cases.append((f"{what}, {tuple(xyz.shape[:2])} {q.shape[1]} "
                      f"{ns}", xyz, q, r, ns))
    return cases


def ball_counts(xyz, q, r, ns) -> tuple:
    """(full, partial, empty) balls of a case."""
    hits = in_ball(xyz, q, r).sum(dim=-1)
    return (int((hits >= ns).sum()), int(((hits > 0) & (hits < ns)).sum()),
            int((hits == 0).sum()))


def check_ballquery_contract(torch, gen) -> None:
    """The ball query on every case of `ballquery_cases`: indices bitwise
    equal to the plain version's in each of BALLQUERY_REPEATS launches.
    The hard clouds must hold what they are for: balls full at every
    point, points at exactly d = r², a full, a partial and an empty ball
    in every four queries, an empty ball."""
    from uni_adapter_torch.ops import ballquery, knn

    for what, xyz, q, r, ns in ballquery_cases(torch, gen):
        want = ballquery.query_ball_plain(r, ns, xyz, q)
        for _ in range(BALLQUERY_REPEATS):
            got = ballquery.query_ball_cuda(r, ns, xyz, q)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"ballquery {what}: {(got != want).sum().item()} "
                     f"indices differ from the plain version's")
        full, partial, empty = ball_counts(xyz, q, r, ns)
        hits = in_ball(xyz, q, r).sum(dim=-1)
        if what.startswith("every point in") and not bool(
                (hits == xyz.shape[1]).all()):
            fail(f"ballquery {what}: a point lies outside a ball")
        if what.startswith("d = r") and not bool(
                (knn.sqdist(xyz, q)[0, 0]
                 == ballquery.squared_radius(r)).sum() > 1000):
            fail(f"ballquery {what}: too few points at exactly r²")
        if what.startswith("full, partial") and not (
                bool((hits[0, 0::4] >= ns).all())
                and bool(((hits[0, 1::4] > 0) & (hits[0, 1::4] < ns)).all())
                and bool((hits[0, 2::4] == 0).all())):
            fail(f"ballquery {what}: the balls are not full, partial and "
                 f"empty in turn")
        if what.startswith("empty") and not empty:
            fail("ballquery: the empty-ball case has no empty ball")
        print(f"ballquery {what}: indices equal, {BALLQUERY_REPEATS} "
              f"launches; balls full {full}, partial {partial}, empty "
              f"{empty}")


def check_ballquery(torch, gen) -> dict:
    """The ball query at BALLQUERY_SHAPES: indices equal to the plain
    version's, and its times: back to back, device, the plain version's
    back to back and, as a yardstick, in device time (the reference's own
    route: the dense (B, S, N) distances and a sort)."""
    from uni_adapter_torch.ops import ballquery

    shapes = {}
    for name, (B, N, S, ns) in BALLQUERY_SHAPES.items():
        r = 0.2
        xyz = sphere_cloud(torch, gen, B, N)
        center = fps_queries(torch, xyz, S)
        run = functools.partial(ballquery.query_ball_cuda, r, ns, xyz,
                                center)
        plain = functools.partial(ballquery.query_ball_plain, r, ns, xyz,
                                  center)
        got, want = run(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"ballquery {name}: {(got != want).sum().item()} indices "
                 f"differ")
        n_dist = query_ball_distances(torch, xyz, center, r, ns)
        b_ms, b_by = bound((B * N * 3 + B * S * 3) * 4 + B * S * ns * 4,
                           n_dist * 8, PEAK_FP32)
        shapes[name] = {"shape": [B, N, S, ns], "r": r,
                        "balls_full_partial_empty": ball_counts(
                            xyz, center, r, ns),
                        "distances": n_dist, "ms": time_ms(run),
                        "device_ms": device_ms(run),
                        "plain_ms": time_ms(plain),
                        "plain_device_ms": device_ms(plain),
                        "bound_ms": b_ms, "bound_by": b_by}
        print(f"ballquery {name}: {shapes[name]}")
    first = shapes["openshape1024"]
    return {"name": "ballquery", "route": "cuda",
            "source": "uni_adapter_torch/csrc/ballquery.cu",
            "replaces": "uni_adapter_tpu/ops/ballquery_pallas.py:60",
            "max_abs_err": 0,
            **{key: first[key] for key in ("ms", "device_ms", "plain_ms",
                                           "bound_ms", "bound_by")},
            "library_ms": None, "shapes": shapes}


def check_eva_attention(torch, gen) -> dict:
    """The natural-layout attention at OpenShape-G's and ULIP-2's shapes, on
    the three column slices of one (B, N, 3D) tensor as `ViTAttention`
    hands them over, bf16, no LayerNorm, q and k scaled by BLOCK_LN_GAMMA
    so that logits have std ≈ 5 (peaked attention).  Within the block's
    tolerance, which two planted faults must fail; the LayerNorm variant
    once, at the OpenShape shape; then the core's edges
    (`check_eva_attention_edges`)."""
    import torch.nn.functional as F

    from uni_adapter_torch.ops.eva_attention import (eva_attention_cuda,
                                                     eva_attention_plain)

    entry, shapes = None, {}
    for path, (B, N, D, H) in (("openshape", (2, 385, 512, 8)),
                               ("ulip", (2, 513, 384, 6))):
        qkv = torch.randn(B, N, 3 * D, generator=gen, device="cuda")
        qkv[..., :2 * D] *= BLOCK_LN_GAMMA
        qkv = qkv.to(torch.bfloat16)
        q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
        got = eva_attention_cuda(q, k, v, num_heads=H).float()
        want = eva_attention_plain(q, k, v, num_heads=H).float()
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"eva_attention ({path}): non-finite output")
        err, r = (got - want).abs().max().item(), block_err(got, want)
        print(f"eva_attention {path} {(B, N, D, H)}: max abs err {err}, "
              f"err/tolerance {r:.3f} (rtol {BLOCK_RTOL}, atol "
              f"{block_atol(want):.5f})")
        if r > 1:
            fail(f"eva_attention ({path}): outside the tolerance")
        neighbour = want.clone()
        neighbour[..., :64] = want[..., 64:128]
        faults = (
            (f"tail key {N - 1} dropped", eva_attention_plain(
                q, k[:, :N - 1], v[:, :N - 1], num_heads=H).float()),
            ("head 0 from head 1", neighbour))
        for fault, bad in faults:
            rf = block_err(bad, want)
            print(f"  planted fault '{fault}': err/tolerance {rf:.1f}")
            if rf <= 1:
                fail(f"eva_attention ({path}): the tolerance passes the "
                     f"planted fault '{fault}'")
        if path == "openshape":
            ln = [BLOCK_LN_GAMMA + 0.1 * torch.randn(
                      64, generator=gen, device="cuda"),
                  0.1 * torch.randn(64, generator=gen, device="cuda"),
                  BLOCK_LN_GAMMA + 0.1 * torch.randn(
                      64, generator=gen, device="cuda"),
                  0.1 * torch.randn(64, generator=gen, device="cuda")]
            qn, kn = q / BLOCK_LN_GAMMA, k / BLOCK_LN_GAMMA
            got_ln = eva_attention_cuda(qn, kn, v, *ln, num_heads=H).float()
            want_ln = eva_attention_plain(qn, kn, v, *ln, num_heads=H).float()
            torch.cuda.synchronize()
            r_ln = block_err(got_ln, want_ln)
            print(f"eva_attention {path} with q/k LayerNorm: max abs err "
                  f"{(got_ln - want_ln).abs().max().item()}, err/tolerance "
                  f"{r_ln:.3f}")
            if r_ln > 1 or not torch.isfinite(got_ln).all():
                fail("eva_attention with q/k LayerNorm: outside the "
                     "tolerance")
            err = max(err, (got_ln - want_ln).abs().max().item())
        heads = [t.unflatten(-1, (H, 64)).transpose(1, 2) for t in (q, k, v)]
        b_ms, b_by = bound(4 * B * N * D * 2, 4 * B * H * N * N * 64,
                           PEAK_BF16)
        shapes[path] = {
            "shape": [B, N, D, H], "max_abs_err": err,
            "ms": time_ms(lambda: eva_attention_cuda(q, k, v, num_heads=H)),
            "device_ms": device_ms(lambda: eva_attention_cuda(
                q, k, v, num_heads=H)),
            "plain_ms": time_ms(lambda: eva_attention_plain(q, k, v,
                                                            num_heads=H)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                *heads)),
            "library_device_ms": device_ms(
                lambda: F.scaled_dot_product_attention(*heads))}
        print_times(f"eva_attention {path}", shapes[path])
        if entry is None:              # the entry's numbers: OpenShape's
            entry = {"name": "eva_attention", "route": "cuda",
                     "source": "uni_adapter_torch/csrc/eva_attention.cu",
                     "replaces": "uni_adapter_tpu/ops/attention_pallas.py:368",
                     **{key: val for key, val in shapes[path].items()
                        if key != "shape"}}
    edge_err = check_eva_attention_edges(torch, gen)
    entry["max_abs_err"] = max([edge_err]
                               + [s["max_abs_err"] for s in shapes.values()])
    entry["shapes"] = shapes
    return entry


#: The sweep's batch: the 15 corruption streams' clean and noisy clouds
#: of one step go through the encoder together (phase 6).
SWEEP_BATCH = 30
#: The grouping and attention kernels at the sweep's batch: kNN (B, N, S,
#: k) for Uni3D and ULIP-2, the ball query (B, N, S, nsample) at r 0.2
#: for OpenShape-G, the natural-layout attention (B, N, D, H) for
#: OpenShape-G and ULIP-2.  (FPS and the block at this batch: phase 3's
#: other checks.)
SWEEP_KNN_SHAPES = {"uni3d": (SWEEP_BATCH, 1024, 512, 64),
                    "ulip": (SWEEP_BATCH, 1024, 512, 32)}
SWEEP_BALLQUERY_SHAPE = (SWEEP_BATCH, 1024, 384, 64)
SWEEP_ATTENTION_SHAPES = {"openshape": (SWEEP_BATCH, 385, 512, 8),
                          "ulip": (SWEEP_BATCH, 513, 384, 6)}


def check_sweep_batch(torch, gen, kernels: list) -> None:
    """kNN, the ball query and the natural-layout attention at the sweep's
    batch: indices bitwise equal to the plain version's in each of
    KNN_REPEATS launches, the attention within the block's bf16 tolerance,
    which its two planted faults must fail; each kernel's times at the
    shape added to its entry's `shapes`."""
    from uni_adapter_torch.ops import ballquery, knn
    from uni_adapter_torch.ops.eva_attention import (eva_attention_cuda,
                                                     eva_attention_plain)

    entry = {k["name"]: k for k in kernels}
    for path, (B, N, S, k) in SWEEP_KNN_SHAPES.items():
        xyz = sphere_cloud(torch, gen, B, N)
        q = fps_queries(torch, xyz, S)
        want = knn.knn_plain(k, xyz, q)
        for _ in range(KNN_REPEATS):
            got = knn.knn_cuda(k, xyz, q)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"knn {path} sweep {(B, N, S, k)}: "
                     f"{(got != want).sum().item()} indices differ")
        b_ms, b_by = bound((B * N * 3 + B * S * 3) * 4 + B * S * k * 4,
                           B * S * N * 8, PEAK_FP32)
        t = {"shape": [B, N, S, k], **knn_times(
            torch, lambda: knn.knn_cuda(k, xyz, q),
            lambda: knn.knn_plain(k, xyz, q), xyz, q, k),
            "bound_ms": b_ms, "bound_by": b_by}
        entry["knn"].setdefault("shapes", {})[f"sweep_{path}"] = t
        print(f"knn {path} sweep {(B, N, S, k)}: indices equal, "
              f"{KNN_REPEATS} launches; {t}")

    B, N, S, ns = SWEEP_BALLQUERY_SHAPE
    r = 0.2
    xyz = sphere_cloud(torch, gen, B, N)
    q = fps_queries(torch, xyz, S)
    run = functools.partial(ballquery.query_ball_cuda, r, ns, xyz, q)
    plain = functools.partial(ballquery.query_ball_plain, r, ns, xyz, q)
    want = plain()
    for _ in range(KNN_REPEATS):
        got = run()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"ballquery sweep {(B, N, S, ns)}: "
                 f"{(got != want).sum().item()} indices differ")
    b_ms, b_by = bound((B * N * 3 + B * S * 3) * 4 + B * S * ns * 4,
                       query_ball_distances(torch, xyz, q, r, ns) * 8,
                       PEAK_FP32)
    t = {"shape": [B, N, S, ns], "r": r,
         "balls_full_partial_empty": ball_counts(xyz, q, r, ns),
         "ms": time_ms(run), "device_ms": device_ms(run),
         "plain_ms": time_ms(plain), "bound_ms": b_ms, "bound_by": b_by}
    entry["ballquery"]["shapes"]["sweep_openshape"] = t
    print(f"ballquery sweep {(B, N, S, ns)}: indices equal, {KNN_REPEATS} "
          f"launches; {t}")

    for path, (B, N, D, H) in SWEEP_ATTENTION_SHAPES.items():
        qkv = torch.randn(B, N, 3 * D, generator=gen, device="cuda")
        qkv[..., :2 * D] *= BLOCK_LN_GAMMA
        qkv = qkv.to(torch.bfloat16)
        q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
        got = eva_attention_cuda(q, k, v, num_heads=H).float()
        want = eva_attention_plain(q, k, v, num_heads=H).float()
        torch.cuda.synchronize()
        err, r_tol = (got - want).abs().max().item(), block_err(got, want)
        if not torch.isfinite(got).all() or r_tol > 1:
            fail(f"eva_attention {path} sweep {(B, N, D, H)}: err/tolerance "
                 f"{r_tol:.3f}, or not finite")
        neighbour = want.clone()
        neighbour[..., :64] = want[..., 64:128]
        faults = {f"tail key {N - 1} dropped": eva_attention_plain(
                      q, k[:, :N - 1], v[:, :N - 1], num_heads=H).float(),
                  "head 0 from head 1": neighbour}
        rf = {f: block_err(bad, want) for f, bad in faults.items()}
        if min(rf.values()) <= 1:
            fail(f"eva_attention {path} sweep: the tolerance passes a "
                 f"planted fault ({rf})")
        b_ms, b_by = bound(4 * B * N * D * 2, 4 * B * H * N * N * 64,
                           PEAK_BF16)
        t = {"shape": [B, N, D, H], "max_abs_err": err,
             "ms": time_ms(lambda: eva_attention_cuda(q, k, v, num_heads=H)),
             "device_ms": device_ms(lambda: eva_attention_cuda(
                 q, k, v, num_heads=H)),
             "plain_ms": time_ms(lambda: eva_attention_plain(
                 q, k, v, num_heads=H)),
             "bound_ms": b_ms, "bound_by": b_by}
        entry["eva_attention"]["shapes"][f"sweep_{path}"] = t
        entry["eva_attention"]["max_abs_err"] = max(
            entry["eva_attention"]["max_abs_err"], err)
        print(f"eva_attention {path} sweep {(B, N, D, H)}: err/tolerance "
              f"{r_tol:.3f}, planted faults "
              f"{ {f: round(x, 1) for f, x in rf.items()} }")
        print_times(f"eva_attention {path} sweep", {**t, "library_ms": None})


#: The attention core's edges in the natural layout, (B, N, D, H) with
#: head dim 64: one key, one whole 64-key chunk, one key past it, a last
#: chunk of one key after 32 full ones, and a grid of several waves (8
#: batches x 16 heads x 9 query tiles, 1152 blocks on 132 SMs).
EVA_EDGE_SHAPES = ((2, 1, 128, 2), (2, 64, 128, 2), (2, 65, 128, 2),
                   (2, 2049, 128, 2), (8, 513, 1024, 16))


def check_eva_attention_edges(torch, gen) -> float:
    """The natural-layout attention at EVA_EDGE_SHAPES, without and with
    the q/k LayerNorm, peaked as in `check_eva_attention`, within the
    block's tolerance.  Returns the largest max abs err."""
    from uni_adapter_torch.ops.eva_attention import (eva_attention_cuda,
                                                     eva_attention_plain)

    worst = 0.0
    for B, N, D, H in EVA_EDGE_SHAPES:
        qkv = torch.randn(B, N, 3 * D, generator=gen, device="cuda")
        qkv[..., :2 * D] *= BLOCK_LN_GAMMA
        qkv = qkv.to(torch.bfloat16)
        q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
        ln = [BLOCK_LN_GAMMA + 0.1 * torch.randn(64, generator=gen,
                                                 device="cuda"),
              0.1 * torch.randn(64, generator=gen, device="cuda"),
              BLOCK_LN_GAMMA + 0.1 * torch.randn(64, generator=gen,
                                                 device="cuda"),
              0.1 * torch.randn(64, generator=gen, device="cuda")]
        for variant, qq, kk, norm in (
                ("", q, k, []),
                (" with q/k LayerNorm", q / BLOCK_LN_GAMMA,
                 k / BLOCK_LN_GAMMA, ln)):
            got = eva_attention_cuda(qq, kk, v, *norm, num_heads=H).float()
            want = eva_attention_plain(qq, kk, v, *norm, num_heads=H).float()
            torch.cuda.synchronize()
            err, r = (got - want).abs().max().item(), block_err(got, want)
            print(f"eva_attention edge {(B, N, D, H)}{variant}: max abs err "
                  f"{err}, err/tolerance {r:.3f}")
            if r > 1 or not torch.isfinite(got).all():
                fail(f"eva_attention edge {(B, N, D, H)}{variant}: outside "
                     f"the tolerance")
            worst = max(worst, err)
    return worst


def print_times(what: str, t: dict) -> None:
    """One kernel's times at one shape: back to back and on the device,
    beside its bound, its plain version and its library yardstick."""
    lib = ("none" if t.get("library_ms") is None else
           f"{t['library_ms']:.4f} ms, device {t['library_device_ms']:.4f} ms")
    ffma = ("" if t.get("bound_ffma_ms") is None else
            f", FFMA bound {t['bound_ffma_ms']:.5f} ms")
    print(f"  {what}: {t['ms']:.4f} ms, device {t['device_ms']:.4f} ms "
          f"(plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms by "
          f"{t['bound_by']}{ffma}; SDPA {lib})")


#: The (B, H, N, hd) attention at each extraction path's shape.
HEADS_SHAPES = {"uni3d": (1, 16, 513, 64), "openshape": (1, 8, 385, 64),
                "ulip": (1, 6, 513, 64)}
#: Head dims off the 64-wide path: the padded variants (16, 32 and 12 → 16).
HEADS_GENERAL_SHAPES = ((2, 3, 70, 32), (3, 4, 77, 16), (1, 3, 77, 12))
#: The attention core's edges, (B, H, N, hd): one key, one whole 64-key
#: chunk, one key past it, a last chunk of one key after 32 full ones (at
#: hd 128, the widest variant), and a grid of several waves (8 x 16 heads x
#: 9 query tiles, 1152 blocks on 132 SMs).
HEADS_EDGE_SHAPES = ((1, 2, 1, 128), (1, 2, 64, 128), (1, 2, 65, 128),
                     (1, 2, 2049, 128), (8, 16, 513, 64))


def check_attention_heads(torch, gen) -> dict:
    """The (B, H, N, hd) attention, bf16, q and k scaled by BLOCK_LN_GAMMA
    so that logits have std ≈ 5 (peaked attention): at the three
    extraction paths' shapes within the block's tolerance, which two
    planted faults must fail, and with times against SDPA; then the
    general-hd variants at three more shapes and the core's edges
    (HEADS_EDGE_SHAPES)."""
    import torch.nn.functional as F

    from uni_adapter_torch.ops.attention_heads import (attention_heads_cuda,
                                                       attention_heads_plain)

    def inputs(B, H, N, hd):
        qkv = torch.randn(3, B, H, N, hd, generator=gen, device="cuda")
        qkv[:2] *= BLOCK_LN_GAMMA        # logit std ≈ γ² whatever hd
        return qkv.to(torch.bfloat16).unbind(0)

    def check(what, q, k, v):
        got = attention_heads_cuda(q, k, v).float()
        want = attention_heads_plain(q, k, v).float()
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            fail(f"attention_heads ({what}): non-finite output")
        err, r = (got - want).abs().max().item(), block_err(got, want)
        print(f"attention_heads {what}: max abs err {err}, err/tolerance "
              f"{r:.3f} (rtol {BLOCK_RTOL}, atol {block_atol(want):.5f})")
        if r > 1:
            fail(f"attention_heads ({what}): outside the tolerance")
        return err, want

    entry, shapes = None, {}
    for path, (B, H, N, hd) in HEADS_SHAPES.items():
        q, k, v = inputs(B, H, N, hd)
        err, want = check(f"{path} {(B, H, N, hd)}", q, k, v)
        neighbour = want.clone()
        neighbour[:, 0] = want[:, 1]
        faults = (
            (f"tail key {N - 1} dropped", attention_heads_plain(
                q, k[:, :, :N - 1], v[:, :, :N - 1]).float()),
            ("head 0 from head 1", neighbour))
        for fault, bad in faults:
            rf = block_err(bad, want)
            print(f"  planted fault '{fault}': err/tolerance {rf:.1f}")
            if rf <= 1:
                fail(f"attention_heads ({path}): the tolerance passes the "
                     f"planted fault '{fault}'")
        b_ms, b_by = bound(4 * B * H * N * hd * 2, 4 * B * H * N * N * hd,
                           PEAK_BF16)
        shapes[path] = {
            "shape": [B, H, N, hd], "max_abs_err": err,
            "ms": time_ms(lambda: attention_heads_cuda(q, k, v)),
            "device_ms": device_ms(lambda: attention_heads_cuda(q, k, v)),
            "plain_ms": time_ms(lambda: attention_heads_plain(q, k, v)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v)),
            "library_device_ms": device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v))}
        print_times(f"attention_heads {path}", shapes[path])
        if entry is None:              # the entry's numbers: Uni3D's
            entry = {"name": "attention_heads", "route": "cuda",
                     "source": "uni_adapter_torch/csrc/attention_heads.cu",
                     "replaces": "uni_adapter_tpu/ops/attention_pallas.py:141",
                     **{key: val for key, val in shapes[path].items()
                        if key != "shape"}}
    for what, shape_set in (("general head dim", HEADS_GENERAL_SHAPES),
                            ("edge", HEADS_EDGE_SHAPES)):
        for shape in shape_set:
            err, _ = check(f"{what} {shape}", *inputs(*shape))
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
    entry["max_abs_err"] = max([entry["max_abs_err"]]
                               + [s["max_abs_err"] for s in shapes.values()])
    entry["shapes"] = shapes
    return entry


def rounded_faults(run, operands) -> dict:
    """The two rounding faults of an fp32 kernel: `run` on its operands
    rounded to bf16 and to TF32 (rounding that a kernel on the tensor
    cores would make)."""
    return {f"operands rounded to {name}": run(*map(rnd, operands))
            for name, rnd in (("bf16", round_bf16), ("TF32", round_tf32))}


def check_attention_fp32(torch, gen) -> dict:
    """Row 9, the fp32 (B, H, N, hd) attention, q and k scaled by
    BLOCK_LN_GAMMA (peaked attention): at the three extraction paths'
    shapes within the fp32 tolerance, which three planted faults must each
    fail by F32_FAULT_MARGIN, with times against SDPA on the same fp32
    inputs; then at head dims 32, 16 and 12."""
    import torch.nn.functional as F

    from uni_adapter_torch.ops.attention_fp32 import (attention_fp32_cuda,
                                                      attention_fp32_plain)

    def inputs(B, H, N, hd):
        qkv = torch.randn(3, B, H, N, hd, generator=gen, device="cuda")
        qkv[:2] *= BLOCK_LN_GAMMA
        return qkv.unbind(0)

    entry, shapes = None, {}
    for path, (B, H, N, hd) in HEADS_SHAPES.items():
        q, k, v = inputs(B, H, N, hd)
        want = attention_fp32_plain(q, k, v)
        faults = {name: (got, want) for name, got in rounded_faults(
            attention_fp32_cuda, (q, k, v)).items()}
        faults[f"last key {N - 1} dropped"] = (attention_fp32_plain(
            q, k[:, :, :N - 1], v[:, :, :N - 1]), want)
        err = check_f32(f"attention_fp32 {path} {(B, H, N, hd)}",
                        attention_fp32_cuda(q, k, v), want, faults)
        shapes[path] = {
            "shape": [B, H, N, hd], "max_abs_err": err,
            "ms": time_ms(lambda: attention_fp32_cuda(q, k, v)),
            "device_ms": device_ms(lambda: attention_fp32_cuda(q, k, v)),
            "plain_ms": time_ms(lambda: attention_fp32_plain(q, k, v)),
            **tc_bounds(4 * B * H * N * hd * 4, 4 * B * H * N * N * hd),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v)),
            "library_device_ms": device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v))}
        print_times(f"attention_fp32 {path}", shapes[path])
        if entry is None:              # the entry's numbers: Uni3D's
            entry = {"name": "attention_fp32", "route": "cuda",
                     "source": "uni_adapter_torch/csrc/attention_fp32.cu",
                     "replaces": "uni_adapter_tpu/ops/attention_pallas.py:56",
                     **{key: val for key, val in shapes[path].items()
                        if key != "shape"}}
    for shape in HEADS_GENERAL_SHAPES:
        q, k, v = inputs(*shape)
        err = check_f32(f"attention_fp32 general head dim {shape}",
                        attention_fp32_cuda(q, k, v),
                        attention_fp32_plain(q, k, v), {})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
    entry["max_abs_err"] = max([entry["max_abs_err"]]
                               + [s["max_abs_err"] for s in shapes.values()])
    entry["shapes"] = shapes
    return entry


def check_eva_attention_fp32(torch, gen) -> dict:
    """The fp32 natural-layout attention at OpenShape-G's and ULIP-2's
    shapes on the three column slices of one fp32 (B, N, 3D) tensor, with
    peaked attention, without and with the q/k LayerNorm: within the fp32
    tolerance, each planted fault F32_FAULT_MARGIN outside it."""
    import torch.nn.functional as F

    from uni_adapter_torch.ops.eva_attention import (eva_attention_fp32_cuda,
                                                     eva_attention_plain)

    entry, shapes = None, {}
    for path, (B, N, D, H) in (("openshape", (2, 385, 512, 8)),
                               ("ulip", (2, 513, 384, 6))):
        qkv = torch.randn(B, N, 3 * D, generator=gen, device="cuda")
        ln = [BLOCK_LN_GAMMA + 0.1 * torch.randn(64, generator=gen,
                                                 device="cuda"),
              0.1 * torch.randn(64, generator=gen, device="cuda"),
              BLOCK_LN_GAMMA + 0.1 * torch.randn(64, generator=gen,
                                                 device="cuda"),
              0.1 * torch.randn(64, generator=gen, device="cuda")]
        q0, k0, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]
        err = 0.0
        # without the LayerNorm q and k carry the peak; with it, γ does
        for variant, q, k, norm in (
                ("", q0 * BLOCK_LN_GAMMA, k0 * BLOCK_LN_GAMMA, []),
                (" with q/k LayerNorm", q0, k0, ln)):
            def kernel(q, k, v):
                return eva_attention_fp32_cuda(q, k, v, *norm, num_heads=H)

            want = eva_attention_plain(q, k, v, *norm, num_heads=H)
            faults = {name: (got, want) for name, got in rounded_faults(
                kernel, (q, k, v)).items()}
            faults[f"last key {N - 1} dropped"] = (eva_attention_plain(
                q, k[:, :N - 1], v[:, :N - 1], *norm, num_heads=H), want)
            err = max(err, check_f32(
                f"eva_attention_fp32 {path} {(B, N, D, H)}{variant}",
                kernel(q, k, v), want, faults))
        q, k = qkv[..., :D], qkv[..., D:2 * D]   # the paths' slices, no LN
        heads = [t.unflatten(-1, (H, 64)).transpose(1, 2) for t in (q, k, v)]
        shapes[path] = {
            "shape": [B, N, D, H], "max_abs_err": err,
            "ms": time_ms(lambda: eva_attention_fp32_cuda(q, k, v,
                                                          num_heads=H)),
            "device_ms": device_ms(lambda: eva_attention_fp32_cuda(
                q, k, v, num_heads=H)),
            "plain_ms": time_ms(lambda: eva_attention_plain(q, k, v,
                                                            num_heads=H)),
            **tc_bounds(4 * B * N * D * 4, 4 * B * H * N * N * 64),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                *heads)),
            "library_device_ms": device_ms(
                lambda: F.scaled_dot_product_attention(*heads))}
        print_times(f"eva_attention_fp32 {path}", shapes[path])
        if entry is None:              # the entry's numbers: OpenShape's
            entry = {"name": "eva_attention_fp32", "route": "cuda",
                     "source": "uni_adapter_torch/csrc/eva_attention.cu",
                     "replaces": "uni_adapter_tpu/ops/attention_pallas.py:368",
                     **{key: val for key, val in shapes[path].items()
                        if key != "shape"}}
    entry["max_abs_err"] = max(s["max_abs_err"] for s in shapes.values())
    entry["shapes"] = shapes
    return entry


#: attn_f32_tc_kernel's edges through the (B, H, N, hd) entry (row 9's
#: three shapes are checked with it), each of its block shapes with ragged
#: tails: one key (three idle key ranges), a key short of two 32-key
#: chunks, exactly two, one key past them; 385 keys at 64 rows x 4 ranges,
#: at 80 x 3 (20 heads at 385, 100 at 65) and at 64 x 2 (the block's 288
#: blocks, and the 15-stream x 2 batch x 16 heads, B·H = 480); 2049 keys
#: at 64 x 4 and 64 x 2; a head of 48 padded to 64.
TC_EDGE_SHAPES = ((1, 2, 1, 64), (1, 2, 63, 64), (1, 2, 64, 64),
                  (1, 2, 65, 64), (2, 8, 385, 64), (1, 20, 385, 64),
                  (1, 100, 65, 64), (2, 16, 513, 64), (30, 16, 513, 64),
                  (1, 2, 2049, 64), (2, 16, 2049, 64), (1, 3, 77, 48))


def check_attention_f32_tc(torch, gen) -> dict:
    """attn_f32_tc_kernel, the split-TF32 fp32 attention behind every fp32
    main path: at TC_EDGE_SHAPES through `attention_fp32_cuda` against
    `attention_fp32_plain`, peaked attention, within the fp32 tolerance,
    with the three planted faults each F32_FAULT_MARGIN outside it (at one
    key there is no key to drop, and a one-key softmax is v itself, which
    no rounding of q or k can move: that case is held to the tolerance
    alone); then at the fp32 block's attention step, (B, N, D, H) = (2,
    513, 1024, 16) on the q/k/v column slices of one (B, N, 3D) tensor as
    the block hands them over, checked the same way and timed (the kernels
    line's numbers) against its bounds, the plain version and SDPA."""
    import torch.nn.functional as F

    from uni_adapter_torch.ops.attention_fp32 import (attention_fp32_cuda,
                                                      attention_fp32_plain)
    from uni_adapter_torch.ops.eva_attention import (eva_attention_fp32_cuda,
                                                     eva_attention_plain)

    worst = 0.0
    for B, H, N, hd in TC_EDGE_SHAPES:
        qkv = torch.randn(3, B, H, N, hd, generator=gen, device="cuda")
        qkv[:2] *= BLOCK_LN_GAMMA
        q, k, v = qkv.unbind(0)
        want = attention_fp32_plain(q, k, v)
        faults = {}
        if N > 1:
            faults = {name: (got, want) for name, got in rounded_faults(
                attention_fp32_cuda, (q, k, v)).items()}
            faults[f"last key {N - 1} dropped"] = (attention_fp32_plain(
                q, k[:, :, :N - 1], v[:, :, :N - 1]), want)
        worst = max(worst, check_f32(
            f"attn_f32_tc_kernel {(B, H, N, hd)}",
            attention_fp32_cuda(q, k, v), want, faults))

    B, N, D, H = 2, 513, 1024, 16
    qkv = torch.randn(B, N, 3 * D, generator=gen, device="cuda")
    qkv[..., :2 * D] *= BLOCK_LN_GAMMA
    q, k, v = qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:]

    def kernel(q, k, v):
        return eva_attention_fp32_cuda(q, k, v, num_heads=H)

    def plain(q, k, v):
        return eva_attention_plain(q, k, v, num_heads=H)

    want = plain(q, k, v)
    faults = {name: (got, want) for name, got in rounded_faults(
        kernel, (q, k, v)).items()}
    faults[f"last key {N - 1} dropped"] = (
        plain(q, k[:, :N - 1], v[:, :N - 1]), want)
    err = check_f32(f"attn_f32_tc_kernel block step {(B, N, D, H)}",
                    kernel(q, k, v), want, faults)
    heads = [t.unflatten(-1, (H, 64)).transpose(1, 2) for t in (q, k, v)]
    entry = {"name": "attn_f32_tc", "route": "cuda",
             "source": "uni_adapter_torch/csrc/attention_core_f32_tc.cuh",
             "replaces": "uni_adapter_tpu/ops/attention_pallas.py:56",
             "max_abs_err": max(err, worst), "shape": [B, N, D, H],
             "ms": time_ms(lambda: kernel(q, k, v)),
             "device_ms": device_ms(lambda: kernel(q, k, v)),
             "plain_ms": time_ms(lambda: plain(q, k, v)),
             **tc_bounds(4 * B * N * D * 4, 4 * B * H * N * N * 64),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                 *heads)),
             "library_device_ms": device_ms(
                 lambda: F.scaled_dot_product_attention(*heads))}
    print_times(f"attn_f32_tc_kernel block step {(B, N, D, H)}", entry)
    return entry


def check_f32_routes(torch, gen) -> None:
    """Which fp32 attention kernel each call runs, from the profiler's
    trace: attn_f32_tc_kernel for every fp32 launch of the main paths (the
    block's attention step, the natural layout without its LayerNorm, the
    (B, H, N, hd) attention at hd 64) and at hd 48; attn_f32_kernel for
    the LayerNorm variant and head dims 32, 16 and 128.  The launch that
    each call's C entry reports (the attn_f32_tc counter) must agree."""
    from uni_adapter_torch.ops import attention, build
    from uni_adapter_torch.ops.attention_fp32 import attention_fp32_cuda
    from uni_adapter_torch.ops.eva_attention import eva_attention_fp32_cuda

    def heads(B, H, N, hd):
        return torch.randn(3, B, H, N, hd, generator=gen,
                           device="cuda").unbind(0)

    def natural(ln):
        B, N, D, H = 2, 385, 512, 8
        qkv = torch.randn(B, N, 3 * D, generator=gen, device="cuda")
        norm = [torch.ones(64, device="cuda"), torch.zeros(64, device="cuda"),
                torch.ones(64, device="cuda"),
                torch.zeros(64, device="cuda")] if ln else []
        return lambda: eva_attention_fp32_cuda(
            qkv[..., :D], qkv[..., D:2 * D], qkv[..., 2 * D:], *norm,
            num_heads=H)

    block = block_inputs(torch, gen, (2, 513, 1024), torch.float32)
    calls = {
        "block attention step": (lambda: attention.eva_attn_block_fp32_cuda(
            *block, num_heads=16), "attn_f32_tc_kernel"),
        "natural layout": (natural(False), "attn_f32_tc_kernel"),
        "natural layout with q/k LayerNorm": (natural(True),
                                              "attn_f32_kernel")}
    for shape, want in (((1, 16, 513, 64), "attn_f32_tc_kernel"),
                        ((1, 3, 77, 48), "attn_f32_tc_kernel"),
                        ((2, 3, 70, 32), "attn_f32_kernel"),
                        ((3, 4, 77, 16), "attn_f32_kernel"),
                        ((1, 2, 65, 128), "attn_f32_kernel")):
        calls[f"(B, H, N, hd) {shape}"] = (
            functools.partial(attention_fp32_cuda, *heads(*shape)), want)
    for what, (fn, want) in calls.items():
        fn()
        for _ in range(3):          # a trace may record nothing: retake it
            ran = [name for name, _ in device_kernel_times(torch, fn)]
            if ran:
                break
        attn = [n for n in ran if "attn_f32" in n]
        if len(attn) != 1 or want not in attn[0]:
            fail(f"fp32 {what}: the trace holds {ran}, expected one {want}")
        before = build.attn_f32_tc.launches
        fn()
        reported = build.attn_f32_tc.launches - before
        if reported != (want == "attn_f32_tc_kernel"):
            fail(f"fp32 {what}: the entry reported {reported} "
                 f"attn_f32_tc_kernel launches, the trace {attn[0][:90]}")
        print(f"fp32 {what}: runs {attn[0][:90]} (reported {reported})")


def check_block_fp32(torch, gen) -> dict:
    """The fp32 EVA attention block at Uni3D-L's (2, 513, 1024), 16 heads,
    fp32 weights, q/k LayerNorm γ ≈ BLOCK_LN_GAMMA (peaked attention):
    within the fp32 tolerance; xn and the four weights rounded to bf16 and
    to TF32, the last token dropped and the projections' last K tile
    skipped, each F32_FAULT_MARGIN outside; then the times of its three
    launches."""
    from uni_adapter_torch.ops import attention

    Bt, T, D, H = 2, 513, 1024, 16
    hd = D // H

    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    w = [rnd(D, D, std=D ** -0.5) for _ in range(4)]
    b = [rnd(D, std=0.02) for _ in range(3)]
    ln = [BLOCK_LN_GAMMA + rnd(hd, std=0.1), rnd(hd, std=0.1),
          BLOCK_LN_GAMMA + rnd(hd, std=0.1), rnd(hd, std=0.1)]
    xn = rnd(Bt, T, D)

    def block(kernel, xn, wq, wk, wv, wo):
        return kernel(xn, wq, b[0], wk, wv, b[1], *ln, wo, b[2],
                      num_heads=H)

    kernel = functools.partial(block, attention.eva_attn_block_fp32_cuda)
    plain = functools.partial(block, attention.eva_attn_block_plain)
    operands = (xn, w[0], w[1], w[2], w[3])
    want = plain(*operands)
    faults = {name: (got, want) for name, got in rounded_faults(
        kernel, operands).items()}
    faults[f"last token {T - 1} dropped"] = (
        plain(xn[:, :T - 1].contiguous(), *operands[1:]), want[:, :T - 1])
    faults["last K tile skipped"] = (
        plain(skip_last_k_tile(xn), *operands[1:]), want)
    err = check_f32(f"eva_attn_block_fp32 {(Bt, T, D, H)}",
                    kernel(*operands), want, faults)
    Mt = Bt * T
    flops = 2 * Mt * D * 4 * D + 4 * Bt * H * T * T * hd
    n_bytes = (2 * Mt * D + 4 * D * D + 3 * D + 4 * hd) * 4
    b_ms, b_by = bound(n_bytes, flops, PEAK_FP32)
    return {"name": "eva_attn_block_fp32", "route": "cuda",
            "source": "uni_adapter_torch/csrc/eva_attn_block.cu",
            "replaces": "uni_adapter_tpu/ops/attention_pallas.py:308",
            "max_abs_err": err,
            "ms": time_ms(lambda: kernel(*operands)),
            "device_ms": device_ms(lambda: kernel(*operands)),
            "plain_ms": time_ms(lambda: plain(*operands)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library_device_ms": None,
            "per_launch": block_launch_times(
                torch, gen, attention.eva_attn_block_fp32_cuda,
                (xn, w[0], b[0], w[1], w[2], b[1], *ln, w[3], b[2]), H,
                PEAK_FP32)}


def block_launch_times(torch, gen, kernel, args, H, peak) -> dict:
    """The block's three launches in device ms each (torch.profiler): the
    two GEMMs (the first and third kernels of a call) beside each one's
    bound and TFLOP/s and cuBLAS's device ms for the same product
    (`F.linear` of xn by [Wq|Wk|Wv] and of the head concat by Wo; TF32
    off), and the attention step (the second) beside its bounds (fp32:
    `tc_bounds`) and SDPA's device ms on (B, H, N, 64) heads of the same
    dtype; cuBLAS and SDPA are yardsticks the port never calls."""
    import torch.nn.functional as F

    xn, wq, wk, wv, wo = args[0], args[1], args[3], args[4], args[10]
    B, N, D = xn.shape
    M, size = B * N, xn.element_size()
    per_launch = device_ms_by_launch(lambda: kernel(*args, num_heads=H), 3)
    x2 = xn.reshape(M, D)
    cat = torch.randn(M, D, generator=gen, device="cuda").to(xn.dtype)
    out = {}
    for what, (name, ms), a, w, n_bias in (
            ("qkv", per_launch[0], x2, torch.cat([wq, wk, wv]), 2 * D),
            ("out", per_launch[2], cat, wo, D)):
        n = w.shape[0]
        flops = 2 * M * D * n
        b_ms, b_by = bound((M * D + n * D + M * n + n_bias) * size, flops,
                           peak)
        out[what] = {"kernel": name, "device_ms": ms, "bound_ms": b_ms,
                     "bound_by": b_by, "tflops": flops / ms / 1e9,
                     "cublas_device_ms": device_ms(lambda: F.linear(a, w))}
        print(f"  {xn.dtype} block {what} GEMM ({M} x {n} x {D}): device "
              f"{ms:.4f} ms a launch, {out[what]['tflops']:.1f} TFLOP/s "
              f"(bound {b_ms:.5f} ms by {b_by}; cuBLAS "
              f"{out[what]['cublas_device_ms']:.4f} ms) [{name[:70]}]")
    name, ms = per_launch[1]
    n_bytes, n_ops = 4 * M * D * size, 4 * B * H * N * N * (D // H)
    if xn.dtype == torch.float32:
        bounds = tc_bounds(n_bytes, n_ops)
    else:
        b_ms, b_by = bound(n_bytes, n_ops, peak)
        bounds = {"bound_ms": b_ms, "bound_by": b_by}
    heads = torch.randn(3, B, H, N, D // H, generator=gen,
                        device="cuda").to(xn.dtype).unbind(0)
    out["attention"] = {"kernel": name, "device_ms": ms, **bounds,
                        "sdpa_device_ms": device_ms(
                            lambda: F.scaled_dot_product_attention(*heads))}
    ffma = ("" if "bound_ffma_ms" not in bounds else
            f", FFMA bound {bounds['bound_ffma_ms']:.5f} ms")
    print(f"  {xn.dtype} block attention step ({B}, {H}, {N}, {D // H}): "
          f"device {ms:.4f} ms a launch (bound {bounds['bound_ms']:.5f} ms "
          f"by {bounds['bound_by']}{ffma}; SDPA "
          f"{out['attention']['sdpa_device_ms']:.4f} ms) [{name[:70]}]")
    return out


#: The block's shapes beyond the main path's checks, (B, N, D, H): one
#: token and one head, 65 tokens at ULIP-2's width (a ragged 64-row tile,
#: 6 heads), Uni3D-L's main path, the 15-stream x 2 fused batch (15,390
#: rows, several waves of tiles), and the cache paths' one cloud a step
#: and 15 streams' one cloud each.
BLOCK_SHAPES = ((1, 1, 64, 1), (1, 65, 384, 6), (2, 513, 1024, 16),
                (30, 513, 1024, 16), (1, 513, 1024, 16),
                (15, 513, 1024, 16))
#: The fused batch holds 15 times the outputs the bf16 tolerance was
#: calibrated on (the main path's).  On other draws than these, one output
#: of 15.76 M sat at 1.08x it on an H100, for the WMMA GEMM of earlier
#: versions as for the wgmma one, and it entered with the rounding of
#: q/k/v (the kernel's q/k/v through the plain attention and out
#: projection gave it too): the tail of the flips the tolerance admits.
#: Should this check fail just past 1 after its draws change, look there
#: first; the bitwise slice check below is what catches a grid fault.


def block_inputs(torch, gen, shape, dtype) -> tuple:
    """The block's twelve arguments for xn of `shape` (B, N, D) in `dtype`:
    weights of std D^-1/2, biases of std 0.02, fp32 q/k LayerNorm γ ≈
    BLOCK_LN_GAMMA (peaked attention) and β ≈ 0."""
    D = shape[-1]

    def rnd(*size, std=1.0, dt=dtype):
        return (torch.randn(*size, generator=gen, device="cuda") * std).to(dt)

    w = [rnd(D, D, std=D ** -0.5) for _ in range(4)]
    b = [rnd(D, std=0.02) for _ in range(3)]
    ln = [BLOCK_LN_GAMMA + rnd(64, std=0.1, dt=torch.float32),
          rnd(64, std=0.1, dt=torch.float32),
          BLOCK_LN_GAMMA + rnd(64, std=0.1, dt=torch.float32),
          rnd(64, std=0.1, dt=torch.float32)]
    return (rnd(*shape), w[0], b[0], w[1], w[2], b[1], *ln, w[3], b[2])


#: The head-sharded entry's shapes: a rank's heads of Uni3D-L's block
#: under tensor parallelism over 2 and 4 ranks, (B, N, D, heads), D the
#: block's input and output width, 64 · heads the rank's q/k/v width.
BLOCK_HEAD_SHARDS = ((2, 513, 1024, 8), (2, 513, 1024, 4))


def head_shard_inputs(torch, gen, shape, dtype) -> tuple:
    """A head shard's twelve arguments for (B, N, D, H): q/k/v weights
    (64H, D) of std D^-1/2, biases (64H,) of std 0.02, the out projection
    (D, 64H) of std (64H)^-1/2, peaked per-head LayerNorms, and no `bo`
    (the partial sum)."""
    B, N, D, H = shape
    Dh = 64 * H

    def rnd(*size, std=1.0, dt=dtype):
        return (torch.randn(*size, generator=gen, device="cuda") * std).to(dt)

    w = [rnd(Dh, D, std=D ** -0.5) for _ in range(3)]
    b = [rnd(Dh, std=0.02) for _ in range(2)]
    ln = [BLOCK_LN_GAMMA + rnd(64, std=0.1, dt=torch.float32),
          rnd(64, std=0.1, dt=torch.float32),
          BLOCK_LN_GAMMA + rnd(64, std=0.1, dt=torch.float32),
          rnd(64, std=0.1, dt=torch.float32)]
    return (rnd(B, N, D), w[0], b[0], w[1], w[2], b[1], *ln,
            rnd(D, Dh, std=Dh ** -0.5), None)


def check_block_head_shards(torch, gen) -> dict:
    """The block's head-sharded entry (no `bo`: the out projection's fp32
    partial sum, unrounded) in bf16 and fp32 at BLOCK_HEAD_SHARDS,
    against the plain version: bf16 within rtol BLOCK_RTOL and atol
    BLOCK_ATOL_RMS, fp32 within the fp32 tolerance, the planted fault
    'last K tile skipped' outside each.  Timed per call (device ms)
    beside its bound, and per launch: its two GEMMs (q/k/v M x 3Dh x D,
    out M x D x Dh) beside their bounds and cuBLAS's `F.linear` of the
    same product (a yardstick the port never calls)."""
    import torch.nn.functional as F

    from uni_adapter_torch.ops import attention

    out = {}
    for name, kernel, dtype, peak in (
            ("eva_attn_block", attention.eva_attn_block_cuda,
             torch.bfloat16, PEAK_BF16),
            ("eva_attn_block_fp32", attention.eva_attn_block_fp32_cuda,
             torch.float32, PEAK_FP32)):
        for shape in BLOCK_HEAD_SHARDS:
            B, N, D, H = shape
            Dh, M = 64 * H, B * N
            args = head_shard_inputs(torch, gen, shape, dtype)
            got = kernel(*args, num_heads=H)
            want = attention.eva_attn_block_plain(*args, num_heads=H)
            short_k = attention.eva_attn_block_plain(
                skip_last_k_tile(args[0]), *args[1:], num_heads=H)
            torch.cuda.synchronize()
            what = f"{name} head shard {shape}"
            if got.dtype != torch.float32 or tuple(got.shape) != (B, N, D):
                fail(f"{what}: returned {got.dtype} {tuple(got.shape)}, not "
                     f"the fp32 partial sum {(B, N, D)}")
            if dtype == torch.bfloat16:
                err = (got - want).abs().max().item()
                r, rf = block_err(got, want), block_err(short_k, want)
                print(f"{what}: max abs err {err:.3g}, err/tolerance "
                      f"{r:.4f}; planted fault 'last K tile skipped': "
                      f"err/tolerance {rf:.1f}")
                if not torch.isfinite(got).all() or r > 1:
                    fail(f"{what}: outside the bf16 block tolerance")
                if rf <= 1:
                    fail(f"{what}: the tolerance passes the planted fault")
            else:
                err = check_f32(what, got, want, {
                    "last K tile skipped": (short_k, want)})
            call = lambda: kernel(*args, num_heads=H)  # noqa: E731
            size = args[0].element_size()
            flops = 2 * M * D * 3 * Dh + 4 * B * H * N * N * 64 \
                + 2 * M * Dh * D
            n_bytes = (M * D + 4 * Dh * D + 2 * Dh) * size + 4 * 64 * 4 \
                + M * D * 4
            b_ms, b_by = bound(n_bytes, flops, peak)
            rec = {"max_abs_err": err, "ms": time_ms(call),
                   "device_ms": device_ms(call),
                   "plain_ms": time_ms(lambda: attention.eva_attn_block_plain(
                       *args, num_heads=H)),
                   "bound_ms": b_ms, "bound_by": b_by, "per_launch": {}}
            launches = device_ms_by_launch(call, 3)
            x2 = args[0].reshape(M, D)
            cat = torch.randn(M, Dh, generator=gen, device="cuda").to(dtype)
            for part, (kname, ms), a, w, n_out in (
                    ("qkv", launches[0], x2,
                     torch.cat([args[1], args[3], args[4]]), 3 * Dh),
                    ("out", launches[2], cat, args[10], D)):
                k_in = a.shape[1]
                g_flops = 2 * M * k_in * n_out
                g_ms, g_by = bound((M * k_in + n_out * k_in) * size
                                   + M * n_out * (4 if part == "out"
                                                  else size), g_flops, peak)
                rec["per_launch"][part] = {
                    "kernel": kname[:70], "device_ms": ms, "bound_ms": g_ms,
                    "bound_by": g_by, "tflops": g_flops / ms / 1e9,
                    "cublas_device_ms": device_ms(lambda: F.linear(a, w))}
            rec["per_launch"]["attention"] = {"kernel": launches[1][0][:70],
                                              "device_ms": launches[1][1]}
            print(f"{what}: device {rec['device_ms']:.4f} ms a call (bound "
                  f"{b_ms:.5f} ms by {b_by}, plain {rec['plain_ms']:.3f} ms);"
                  + "".join(f" {k} GEMM {v['device_ms']:.4f} ms "
                            f"({v['tflops']:.1f} TFLOP/s, bound "
                            f"{v['bound_ms']:.5f} ms, cuBLAS "
                            f"{v['cublas_device_ms']:.4f} ms);"
                            for k, v in rec["per_launch"].items()
                            if k != "attention")
                  + f" attention {launches[1][1]:.4f} ms")
            out[f"{name} {shape}"] = rec
    return out


def check_block_shapes(torch, gen) -> dict:
    """Both entries of the block at BLOCK_SHAPES, peaked attention (q/k
    LayerNorm γ ≈ BLOCK_LN_GAMMA), against the plain version: fp32 within
    rtol F32_RTOL and atol F32_ATOL_RMS of the RMS, bf16 within rtol
    BLOCK_RTOL and atol BLOCK_ATOL_RMS.  Past two batches, each 2-batch
    slice of the output (for an odd B the last overlaps the one before)
    must also equal bit for bit the kernel's run on that slice alone (the
    same rows through a grid of one wave).  Slices of one batch are not
    compared: the attention step picks its block shape from the grid
    (`attention_core.cuh::launch_attention`), and Uni3D-L's one cloud
    takes 80-row blocks with 3 key ranges where two or more clouds take
    64-row blocks with one, so its sums run in another order.  Returns
    the largest max abs err per entry."""
    from uni_adapter_torch.ops import attention

    worst = {}
    for name, kernel, dtype, tol in (
            ("eva_attn_block", attention.eva_attn_block_cuda,
             torch.bfloat16, (BLOCK_RTOL, BLOCK_ATOL_RMS)),
            ("eva_attn_block_fp32", attention.eva_attn_block_fp32_cuda,
             torch.float32, (F32_RTOL, F32_ATOL_RMS))):
        worst[name] = 0.0
        for B, N, D, H in BLOCK_SHAPES:
            args = block_inputs(torch, gen, (B, N, D), dtype)
            got = kernel(*args, num_heads=H)
            want = attention.eva_attn_block_plain(*args, num_heads=H).float()
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            r = block_err(got.float(), want, *tol)
            print(f"{name} {(B, N, D, H)}: max abs err {err:.3g}, "
                  f"err/tolerance {r:.4f} (rtol {tol[0]}, atol "
                  f"{block_atol(want, tol[1]):.3g})")
            if not torch.isfinite(got).all() or r > 1:
                fail(f"{name} {(B, N, D, H)}: outside the tolerance")
            if B > 2:
                for i in sorted({min(i, B - 2) for i in range(0, B, 2)}):
                    alone = kernel(args[0][i:i + 2].contiguous(), *args[1:],
                                   num_heads=H)
                    if not torch.equal(got[i:i + 2], alone):
                        fail(f"{name} {(B, N, D, H)}: batches {i}-{i + 1} "
                             f"differ from the kernel's run on them alone")
                print(f"{name} {(B, N, D, H)}: every 2-batch slice equal to "
                      f"the kernel's run on it alone")
            worst[name] = max(worst[name], err)
    return worst


def check_gemm_sass() -> None:
    """The block's bf16 GEMM runs on wgmma, its fp32 GEMM on no tensor
    core, its fp32 attention step on the tensor cores: in `cuobjdump
    --dump-sass` of the built library, every instantiation of
    gemm_bf16_kernel holds HGMMA instructions, no instantiation of
    gemm_f32_kernel holds an HMMA or HGMMA, and every attn_f32_tc_kernel
    holds HMMA (mma.sync, TF32)."""
    from uni_adapter_torch.ops import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run(
        [tool, "--dump-sass", str(build.library_path("eva_attn_block"))],
        capture_output=True, text=True, check=True, timeout=300).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
            counts[func] = {"HGMMA": 0, "HMMA": 0}
        elif func is not None:
            for op in counts[func]:
                if re.search(rf"\b{op}\b", line):
                    counts[func][op] += 1
    bf16 = {f: c for f, c in counts.items() if "gemm_bf16_kernel" in f}
    f32 = {f: c for f, c in counts.items() if "gemm_f32_kernel" in f}
    tc = {f: c for f, c in counts.items() if "attn_f32_tc_kernel" in f}
    for f, c in {**bf16, **f32, **tc}.items():
        print(f"SASS {kernel_label(f)}: {c['HGMMA']} HGMMA, {c['HMMA']} HMMA")
    if not bf16 or not all(c["HGMMA"] > 0 for c in bf16.values()):
        fail("the bf16 block GEMM has no HGMMA in its SASS")
    if not f32 or any(c["HGMMA"] + c["HMMA"] for c in f32.values()):
        fail("the fp32 block GEMM has tensor-core instructions in its SASS, "
             "or is missing")
    if not tc or not all(c["HMMA"] > 0 for c in tc.values()):
        fail("the fp32 block's attention step has no HMMA in its SASS")


def kernel_label(mangled: str) -> str:
    """A mangled kernel name as name<template arguments>: the
    length-prefixed identifier that ends in `_kernel`."""
    for m in re.finditer(r"(?=(\d{1,3}))", mangled):  # every digit run start
        for k in range(1, len(m.group(1)) + 1):
            start = m.start() + k
            end = start + int(mangled[m.start():start])
            name = mangled[start:end]
            if name.endswith("_kernel") and name.isidentifier():
                t = re.match(r"I((?:L[ib]\d+E)+)E", mangled[end:])
                args = re.findall(r"\d+", t.group(1)) if t else []
                return name + (f"<{', '.join(args)}>" if args else "")
    return mangled


def ptxas_report(name: str, log: str) -> None:
    """Registers, spills and wgmma advisories from nvcc's -Xptxas -v
    output, each line under the kernel it is about."""
    func = ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            func = kernel_label(m.group(1))
        elif "registers" in line or "spill" in line or "wgmma" in line:
            print(f"  {name}: {func}: {line.strip()}")


def check_float16_raises(torch) -> None:
    """float16 has no kernel on the card: each attention wrapper raises a
    ValueError naming it, before any launch."""
    from uni_adapter_torch.ops import attention, attention_fp32
    from uni_adapter_torch.ops import attention_heads, eva_attention

    h = torch.zeros(1, 2, 5, 64, dtype=torch.float16, device="cuda")
    x = torch.zeros(1, 5, 64, dtype=torch.float16, device="cuda")
    w = torch.zeros(64, 64, dtype=torch.float16, device="cuda")
    b = torch.zeros(64, dtype=torch.float16, device="cuda")
    calls = {
        "attention_heads": lambda: attention_heads.attention_heads(h, h, h),
        "attention_fp32": lambda: attention_fp32.attention_fp32(h, h, h),
        "eva_attention": lambda: eva_attention.eva_attention_fused(
            x, x, x, num_heads=1),
        "eva_attn_block": lambda: attention.eva_attn_block(
            x, w, b, w, w, b, b, b, b, b, w, b, num_heads=1)}
    for name, call in calls.items():
        try:
            call()
        except ValueError as e:
            if "float16" not in str(e):
                fail(f"{name} on float16 raised without naming it: {e}")
            continue
        fail(f"{name} ran on float16 tensors on the card")
    print(f"float16 on the card: {', '.join(calls)} raise, naming it")


def cloud(torch, gen, B=2, N=1024):
    """xyz on a sphere of radius 0.5 (the synthetic stream's clouds) and a
    random color, (B, N, 6)."""
    return torch.cat([sphere_cloud(torch, gen, B, N),
                      torch.rand(B, N, 3, generator=gen, device="cuda")], -1)


#: Largest |Δ| of an attention-map entry, card against CPU, at depth 2 in
#: bf16.  Both sides store q·kᵀ in bf16; where the two sums of one logit
#: round to neighbouring bf16 values (or an upstream bf16 rounding
#: flipped), that logit differs by one ulp, 2⁻⁸ of itself, and its
#: probability by a few per cent of itself.  The card read at most 1.0e-3
#: on these near-uniform random-weight maps (entries ≈ 1/N); 1e-2 leaves
#: ten times that.  It bounds rounding in the maps' own path (`attn_probs`
#: on the card's q and k); the kernel's faults are phase 3's to catch.
MAP_ATOL = 1e-2


#: Each backbone's forward arguments from a (B, N, 6) xyz‖color cloud.
FORWARD_INPUTS = {"uni3d": lambda pc: (pc,),
                  "openshape": lambda pc: (pc[..., :3], pc),
                  "ulip": lambda pc: (pc[..., :3],)}


#: Backbones also checked on 10,000-point clouds, and the kernels their
#: grouping must launch there.
LARGE_CLOUD_KERNELS = {"uni3d": ("fps_grid", "knn_gather"),
                       "openshape": ("fps_grid", "ballquery")}


def depth2_backbones(compute_dtype: str) -> dict:
    """Uni3D-L, OpenShape-G and ULIP-2 at depth 2 and full width in
    `compute_dtype`: kind → build(device, state_dict or None)."""
    import dataclasses

    from uni_adapter_torch.config import ModelConfig
    from uni_adapter_torch.models import ppta
    from uni_adapter_torch.models.pointbert import create_ulip
    from uni_adapter_torch.models.uni3d import create_uni3d

    g2 = dataclasses.replace(ppta.PRESETS[4], depth=2)
    mc = ModelConfig(compute_dtype=compute_dtype)
    return {
        "uni3d": lambda dev, sd: create_uni3d(
            dataclasses.replace(mc, eva_depth=2), dev, seed=0, state_dict=sd),
        "openshape": lambda dev, sd: ppta.create_openshape(
            mc, dev, seed=0, state_dict=sd, preset=g2),
        "ulip": lambda dev, sd: create_ulip(
            dataclasses.replace(mc, ulip_depth=2), dev, seed=0,
            state_dict=sd),
    }


def check_features(torch, gen) -> None:
    """Uni3D-L, OpenShape-G and ULIP-2 at depth 2 and full width: the card's
    kernels against the CPU's plain versions on the same bf16 weights and
    input (cosine ≥ 0.99), without and with `return_attn`.  With it, every
    map must be finite with rows summing to 1 within 1e-3 and within
    MAP_ATOL of the CPU's, and the card's features within cosine 0.99 of
    its own plain forward (block or natural-layout kernel).  Uni3D and
    OpenShape also on 10,000-point clouds (cosine ≥ 0.99), where their
    grouping must run the large-cloud kernels and not fps.cu or knn.cu."""
    for kind, build_model in depth2_backbones("bfloat16").items():
        inputs = FORWARD_INPUTS[kind]
        gpu = build_model("cuda", None)
        cpu = build_model("cpu", {k: v.float().cpu()
                                  for k, v in gpu.state_dict().items()})
        if kind == "uni3d":
            pc = torch.cat([torch.randn(2, 1024, 3, generator=gen,
                                        device="cuda"),
                            torch.ones(2, 1024, 3, device="cuda")], dim=-1)
        else:
            pc = cloud(torch, gen)
        with torch.no_grad():
            f_gpu = gpu(*inputs(pc)).cpu()
            f_cpu = cpu(*inputs(pc.cpu()))
            fa_gpu, maps_gpu = gpu(*inputs(pc), return_attn=True)
            fa_cpu, maps_cpu = cpu(*inputs(pc.cpu()), return_attn=True)
        cos = torch.nn.functional.cosine_similarity(f_gpu, f_cpu, dim=-1)
        print(f"features {kind} (depth 2, full width, bf16) {tuple(f_gpu.shape)}"
              f": cosine card vs cpu {cos.tolist()}, max abs diff "
              f"{(f_gpu - f_cpu).abs().max().item():.4g}")
        if not (torch.isfinite(f_gpu).all() and cos.min() > 0.99):
            fail(f"{kind} features on the card disagree with the CPU's plain "
                 f"path")
        fa_gpu = fa_gpu.cpu()
        cos_a = torch.nn.functional.cosine_similarity(fa_gpu, fa_cpu, dim=-1)
        cos_k = torch.nn.functional.cosine_similarity(fa_gpu, f_gpu, dim=-1)
        row_err = max((m.sum(-1) - 1).abs().max().item() for m in maps_gpu)
        map_err = max((g.cpu() - c).abs().max().item()
                      for g, c in zip(maps_gpu, maps_cpu))
        print(f"return_attn {kind}: {len(maps_gpu)} maps "
              f"{tuple(maps_gpu[0].shape)}; features cosine card vs cpu "
              f"{min(cos_a.tolist()):.6f}, card vs its plain forward "
              f"{min(cos_k.tolist()):.6f}; map rows sum to 1 within "
              f"{row_err:.3g}; maps max abs diff card vs cpu {map_err:.4g} "
              f"(tolerance {MAP_ATOL})")
        if not (torch.isfinite(fa_gpu).all()
                and all(torch.isfinite(m).all() for m in maps_gpu)):
            fail(f"{kind} return_attn: non-finite features or maps")
        if cos_a.min() < 0.99 or cos_k.min() < 0.99:
            fail(f"{kind} return_attn features disagree (cosine < 0.99)")
        if row_err > 1e-3 or map_err > MAP_ATOL:
            fail(f"{kind} return_attn maps outside their tolerance")
        if kind not in LARGE_CLOUD_KERNELS:
            continue
        pc = cloud(torch, gen, 2, 10000)
        counters = launch_counters()
        for c in counters.values():
            c.launches = 0
        with torch.no_grad():
            f_gpu = gpu(*inputs(pc)).cpu()
        launches = {n: c.launches for n, c in counters.items()}
        with torch.no_grad():
            f_cpu = cpu(*inputs(pc.cpu()))
        cos = torch.nn.functional.cosine_similarity(f_gpu, f_cpu, dim=-1)
        print(f"features {kind} on 10,000-point clouds (depth 2, full width, "
              f"bf16): cosine card vs cpu {cos.tolist()}, max abs diff "
              f"{(f_gpu - f_cpu).abs().max().item():.4g}; launches "
              f"{ {n: v for n, v in launches.items() if v} }")
        if not (torch.isfinite(f_gpu).all() and cos.min() > 0.99):
            fail(f"{kind} features on 10,000 points disagree with the CPU's")
        if (not all(launches[n] for n in LARGE_CLOUD_KERNELS[kind])
                or launches["fps"] or launches["knn"]):
            fail(f"{kind} on 10,000 points took another route: {launches}")


#: fp32 features on the card against the CPU at depth 2: the largest
#: 1 − cosine, and the largest |Δ| of a map entry.  Both sides compute in
#: fp32 with the same weights (TF32 off), so they differ by summation order
#: alone, ~1e-7 relative per layer; the gates leave a thousand times that.
F32_FEATURE_1MCOS, F32_MAP_ATOL = 1e-4, 1e-5
#: Each backbone's fp32 kernel without maps: the block for Uni3D, the
#: natural layout for the ViT backbones.
FP32_FORWARD_KERNEL = {"uni3d": "eva_attn_block_fp32",
                       "openshape": "eva_attention_fp32",
                       "ulip": "eva_attention_fp32"}
#: The attention kernels, by dtype; FP32_KERNELS adds the split-TF32
#: kernel, whose launches the three fp32 wrappers share.
BF16_ATTENTION = ("eva_attn_block", "eva_attention", "attention_heads")
FP32_ATTENTION = ("eva_attn_block_fp32", "eva_attention_fp32",
                  "attention_fp32")
FP32_KERNELS = FP32_ATTENTION + ("attn_f32_tc",)
#: The kernels a 1024-point bf16 Uni3D path must not run.
UNI3D_IDLE = ("fps_grid", "knn_gather", "ballquery", "eva_attention",
              "attention_heads") + FP32_KERNELS


def check_features_fp32(torch, gen) -> None:
    """The three backbones at depth 2 and full width in fp32, the card's
    kernels against the CPU's plain versions on the same fp32 weights and
    input, without and with `return_attn`: 1 − cosine ≤ F32_FEATURE_1MCOS
    (also card with maps against card without), maps within F32_MAP_ATOL,
    and the card's forward on its fp32 kernels alone (the block or the
    natural layout without maps, row 9's kernel with them)."""
    counters = launch_counters()
    for kind, build_model in depth2_backbones("float32").items():
        inputs = FORWARD_INPUTS[kind]
        gpu = build_model("cuda", None)
        cpu = build_model("cpu", {k: v.cpu() for k, v in
                                  gpu.state_dict().items()})
        pc = cloud(torch, gen)
        card, host, launches = {}, {}, {}
        for maps in (False, True):
            for c in counters.values():
                c.launches = 0
            with torch.no_grad():
                card[maps] = gpu(*inputs(pc), return_attn=maps)
            torch.cuda.synchronize()
            launches[maps] = {n: c.launches for n, c in counters.items()}
            with torch.no_grad():
                host[maps] = cpu(*inputs(pc.cpu()), return_attn=maps)
        f_gpu, f_cpu = card[False].cpu(), host[False]
        (fa_gpu, maps_gpu), (fa_cpu, maps_cpu) = card[True], host[True]
        fa_gpu = fa_gpu.cpu()
        cos = torch.nn.functional.cosine_similarity
        gaps = {"card vs cpu": 1 - cos(f_gpu, f_cpu, dim=-1).min().item(),
                "with maps, card vs cpu":
                    1 - cos(fa_gpu, fa_cpu, dim=-1).min().item(),
                "card with maps vs without":
                    1 - cos(fa_gpu, f_gpu, dim=-1).min().item()}
        map_err = max((g.cpu() - c).abs().max().item()
                      for g, c in zip(maps_gpu, maps_cpu))
        print(f"features {kind} (depth 2, full width, fp32) "
              f"{tuple(f_gpu.shape)}: 1 − cosine "
              f"{ {k: f'{v:.3g}' for k, v in gaps.items()} } (gate "
              f"{F32_FEATURE_1MCOS}), max abs diff card vs cpu "
              f"{(f_gpu - f_cpu).abs().max().item():.3g} (with maps "
              f"{(fa_gpu - fa_cpu).abs().max().item():.3g}); {len(maps_gpu)} "
              f"maps, max abs diff {map_err:.3g} (tolerance {F32_MAP_ATOL})")
        print(f"features {kind} fp32 launches: without maps "
              f"{ {n: v for n, v in launches[False].items() if v} }, with "
              f"maps { {n: v for n, v in launches[True].items() if v} }")
        if not (torch.isfinite(f_gpu).all() and torch.isfinite(fa_gpu).all()
                and all(torch.isfinite(m).all() for m in maps_gpu)):
            fail(f"{kind} fp32: non-finite features or maps")
        if max(gaps.values()) > F32_FEATURE_1MCOS:
            fail(f"{kind} fp32 features disagree: {gaps}")
        if map_err > F32_MAP_ATOL:
            fail(f"{kind} fp32 maps differ from the CPU's by {map_err}")
        want = {False: FP32_FORWARD_KERNEL[kind], True: "attention_fp32"}
        for maps, n in want.items():
            ran = [k for k in BF16_ATTENTION + FP32_ATTENTION
                   if launches[maps][k]]
            if ran != [n]:
                fail(f"{kind} fp32 forward (return_attn={maps}) ran the "
                     f"attention kernels {ran}, expected [{n!r}]")
            # one attention a call (the block's wrapper counts 3 launches)
            calls = launches[maps][n] // (3 if n == "eva_attn_block_fp32"
                                          else 1)
            if launches[maps]["attn_f32_tc"] != calls:
                fail(f"{kind} fp32 forward (return_attn={maps}): "
                     f"attn_f32_tc_kernel ran {launches[maps]['attn_f32_tc']} "
                     f"times for {calls} attention calls")


def launch_counters() -> dict:
    """Each kernel's launch counter: the wrapper that owns it (the
    split-TF32 core's, which the three fp32 wrappers share, adds the
    launches that their C entries report ran it).  A wrapper counts each
    launch it issues, also one that a CUDA graph's capture records."""
    from uni_adapter_torch.ops import attention, attention_fp32
    from uni_adapter_torch.ops import attention_heads, ballquery, build
    from uni_adapter_torch.ops import eva_attention, fps, knn, knn_gather

    return {"fps": fps.farthest_point_sample, "knn": knn.knn,
            "eva_attn_block": attention.eva_attn_block,
            "ballquery": ballquery.query_ball,
            "eva_attention": eva_attention.eva_attention_fused,
            "attention_heads": attention_heads.attention_heads,
            "knn_gather": knn_gather.knn_gather,
            "fps_grid": fps.fps_grid_cuda,
            "attention_fp32": attention_fp32.attention_fp32,
            "eva_attention_fp32": eva_attention.eva_attention_fp32_cuda,
            "eva_attn_block_fp32": attention.eva_attn_block_fp32_cuda,
            "attn_f32_tc": build.attn_f32_tc,
            "eva_attn_block_bwd": attention.eva_attn_block_bwd_cuda}


#: The main paths: extra CLI flags; the stream's points a cloud and
#: classes; the anchor bank ('large': the shipped bank of the dataset,
#: else the (K, width) of a seeded file); the launches a 16-step run must
#: reach per kernel (the block's wrappers launch three kernels a block);
#: and the kernels that must not run.  The first three are the 1024-point
#: ModelNet40 paths, the next two the clouds above the register kernels'
#: limits (fps.cu: 4096 points, knn.cu: 2048), the last three the
#: 1024-point paths again with `--compute-dtype float32`: the fp32
#: kernels, and no bf16 attention kernel; then Uni3D-L on the prototype
#: cache path (`--dota-use-mode-dota false`: one forward of the batch-1
#: cloud a step), on ModelNet40 (the dense graph, K·C = 1200, the CG) and
#: on ShapeNetCore-C (55 classes, the shipped bank, the explicit solve of
#: the dataset's table).
PATHS = {
    "uni3d": ([], (1024, 40), "large",
              {"fps": 1, "knn": 1, "eva_attn_block": 24 * 3},
              ("fps_grid", "knn_gather") + FP32_KERNELS),
    "openshape": (["--vlm3d", "openshape"], (1024, 40), (40, 1280),
                  {"fps": 1, "ballquery": 1, "eva_attention": 12},
                  ("fps_grid", "knn_gather") + FP32_KERNELS),
    "ulip": (["--vlm3d", "ulip"], (1024, 40), (40, 512),
             {"fps": 1, "knn": 1, "eva_attention": 12},
             ("fps_grid", "knn_gather") + FP32_KERNELS),
    "uni3d_lvis10k": (["--dataset-name", "objaverse_lvis", "--npoints",
                       "10000"], (10000, 1156), (1156, 1024),
                      {"fps_grid": 1, "knn_gather": 1,
                       "eva_attn_block": 24 * 3},
                      ("fps", "knn") + FP32_KERNELS),
    "ulip_scanobjectnn8192": (["--vlm3d", "ulip", "--dataset-name",
                               "scanobjectnn", "--npoints", "8192"],
                              (8192, 15), (15, 512),
                              {"fps_grid": 1, "knn_gather": 1,
                               "eva_attention": 12},
                              ("fps", "knn") + FP32_KERNELS),
    "uni3d_fp32": (["--compute-dtype", "float32"], (1024, 40), "large",
                   {"fps": 1, "knn": 1, "eva_attn_block_fp32": 24 * 3,
                    "attn_f32_tc": 24},
                   ("fps_grid", "knn_gather", "eva_attention_fp32",
                    "attention_fp32") + BF16_ATTENTION),
    "openshape_fp32": (["--vlm3d", "openshape", "--compute-dtype", "float32"],
                       (1024, 40), (40, 1280),
                       {"fps": 1, "ballquery": 1, "eva_attention_fp32": 12,
                        "attn_f32_tc": 12},
                       ("fps_grid", "knn_gather", "eva_attn_block_fp32",
                        "attention_fp32") + BF16_ATTENTION),
    "ulip_fp32": (["--vlm3d", "ulip", "--compute-dtype", "float32"],
                  (1024, 40), (40, 512),
                  {"fps": 1, "knn": 1, "eva_attention_fp32": 12,
                   "attn_f32_tc": 12},
                  ("fps_grid", "knn_gather", "eva_attn_block_fp32",
                   "attention_fp32") + BF16_ATTENTION),
    "uni3d_cache": (["--dota-use-mode-dota", "false"], (1024, 40), "large",
                    {"fps": 1, "knn": 1, "eva_attn_block": 24 * 3},
                    UNI3D_IDLE),
    "uni3d_cache_shapenet": (["--dota-use-mode-dota", "false",
                              "--dataset-name", "shapenetcore"],
                             (1024, 55), "large",
                             {"fps": 1, "knn": 1, "eva_attn_block": 24 * 3},
                             UNI3D_IDLE),
    # the eager step loop of each method (every path above runs the scan)
    "uni3d_eager": (["--use-scan", "false"], (1024, 40), "large",
                    {"fps": 1, "knn": 1, "eva_attn_block": 24 * 3},
                    UNI3D_IDLE),
    "uni3d_cache_eager": (["--dota-use-mode-dota", "false", "--use-scan",
                           "false"], (1024, 40), "large",
                          {"fps": 1, "knn": 1, "eva_attn_block": 24 * 3},
                          UNI3D_IDLE),
}
#: The other DOTA variants on Uni3D-L (one forward of the batch-1 cloud a
#: step, no noise), captured, and plain DOTA's eager loop.  Their traced
#: launches must equal exactly one forward's a step: 16 replayed steps
#: and the WARMUP_RUNS eager ones before the capture (eager: 16 steps).
VARIANT_FLAGS = {
    "uni3d_dota": ["--dota-use-mode-dota", "false", "--dota-use-dota",
                   "true"],
    "uni3d_gmm": ["--dota-use-mode-dota", "false", "--dota-use-gmm-dota",
                  "true"],
    "uni3d_adaptive": ["--dota-use-mode-dota", "false",
                       "--dota-use-adaptive-dota", "true"],
}
VARIANT_FLAGS["uni3d_dota_eager"] = VARIANT_FLAGS["uni3d_dota"] + [
    "--use-scan", "false"]
PATHS.update({kind: (flags, (1024, 40), "large",
                     {"fps": 1, "knn": 1, "eva_attn_block": 24 * 3},
                     UNI3D_IDLE) for kind, flags in VARIANT_FLAGS.items()})


def write_stream(root: Path, n_points: int, n_classes: int,
                 n_clouds: int = 16, corruptions=("uniform",)) -> None:
    """Synthetic corruption streams, one file a corruption with one label
    file: clouds on spheres of radius 0.5-0.9, written at their full size
    (no resampling duplicates points)."""
    import numpy as np

    rng = np.random.default_rng(0)
    labels = rng.integers(0, n_classes, n_clouds)
    root.mkdir(parents=True, exist_ok=True)
    for corr in corruptions:
        pts = rng.standard_normal((n_clouds, n_points, 3)).astype(np.float32)
        pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
        pts *= (0.5 + 0.1 * (labels % 5))[:, None, None].astype(np.float32)
        np.save(root / f"data_{corr}_5.npy", pts)
    np.save(root / "label.npy", labels.astype(np.int64))


def write_bank(path: Path, n_classes: int, width: int) -> None:
    """A seeded, row-normalised (n_classes, width) anchor bank."""
    import numpy as np

    bank = np.random.default_rng(width).standard_normal((n_classes, width))
    bank /= np.linalg.norm(bank, axis=1, keepdims=True)
    np.save(path, bank.astype(np.float32))


def bank_arg(tmp: Path, bank) -> str:
    """`--precomputed-text-features` of a path: 'large', or a seeded bank
    of the (K, width) it names, written under tmp."""
    if bank == "large":
        return bank
    path = tmp / f"bank_{bank[0]}x{bank[1]}.npy"
    if not path.exists():
        write_bank(path, *bank)
    return str(path)


def zeroed_counters() -> dict:
    """The launch counters, each set to 0."""
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    return counters


#: The port's kernels as a profiler trace names them, by the counter whose
#: wrapper launches them: a block's wrapper launches two GEMMs and an
#: attention step a call and counts three; an fp32 wrapper's attention
#: step is the FFMA or the split-TF32 kernel, the latter also counted as
#: `attn_f32_tc`.  Counters that share a kernel never run on one path.
COUNTER_KERNELS = {
    "fps": ("fps_kernel",), "knn": ("knn_kernel",),
    "eva_attn_block": ("gemm_bf16_kernel", "attn_kernel"),
    "ballquery": ("ballquery_kernel",),
    "eva_attention": ("attn_kernel",),
    "attention_heads": ("attn_kernel",),
    "knn_gather": ("knn_gather_kernel",),
    "fps_grid": ("fps_grid_kernel",),
    "attention_fp32": ("attn_f32_kernel", "attn_f32_tc_kernel"),
    "eva_attention_fp32": ("attn_f32_kernel", "attn_f32_tc_kernel"),
    "eva_attn_block_fp32": ("gemm_f32_kernel", "attn_f32_kernel",
                            "attn_f32_tc_kernel"),
    "attn_f32_tc": ("attn_f32_tc_kernel",),
    "eva_attn_block_bwd": ("eva_bwd_dq_kernel", "eva_bwd_dkdv_kernel",
                           "eva_bwd_ln_kernel", "eva_bwd_ln_sum_kernel"),
}
PORT_KERNELS = sorted({k for ks in COUNTER_KERNELS.values() for k in ks})


def kernel_counts(names) -> dict:
    """How often each of PORT_KERNELS ran among a trace's kernel names."""
    by_name = collections.Counter(names)
    return {k: sum(n for name, n in by_name.items()
                   if re.search(rf"\b{k}\b", name)) for k in PORT_KERNELS}


def device_kernel_names(torch, prof) -> list:
    """The names of the device events of a finished trace, read from the
    profiler's raw events (building its FunctionEvents takes seconds for
    a whole run's)."""
    cuda = torch.autograd.DeviceType.CUDA
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        return [ev.name for ev in prof.events() if ev.device_type == cuda]
    return [ev.name() for ev in events if ev.device_type() == cuda]


def device_kernel_times(torch, fn) -> list:
    """(name, device ms) of each device activity (kernels, copies, fills)
    of one call of fn(), from the raw events of a CUDA trace, as
    `traced_run` reads them.  The train step's FPS and kNN launches were
    missing from `trace_kernels`'s function events in three traces of
    three, and present in these."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        warm_trace(torch)
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return [(ev.name(), ev.duration_ns() / 1e6)
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == cuda and "spin_kernel" not in ev.name()]


def warm_trace(torch) -> None:
    """A few short kernels (`torch.cuda._sleep`'s spin_kernel), finished
    at the start of a trace: on an H100, traces taken late in the process
    lost the first kernels launched in them, a step's FPS and kNN."""
    for _ in range(4):
        torch.cuda._sleep(20_000)
    torch.cuda.synchronize()


def by_counter(counts: dict, on_path) -> dict:
    """Kernel counts as launches of the counters `on_path` (0 for the
    others)."""
    return {c: (sum(counts[k] for k in ks) if c in on_path else 0)
            for c, ks in COUNTER_KERNELS.items()}


def traced_run(torch, what: str, run, on_path) -> tuple:
    """Drive a main path, run(), with every launch counter at 0 and the
    device traced.  Returns its result, its launches by counter as the
    trace counts them (what ran on the card: the eager steps and a
    captured step's replays; a wrapper counts a launch that a capture
    records, and no replay) and the wrappers' counts.  Fails if the
    trace holds none of the port's kernels, or one that the counters
    `on_path` do not launch, if a wrapper off the path counted anything
    or one on it nothing."""
    counters = zeroed_counters()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        warm_trace(torch)
        result = run()
        torch.cuda.synchronize()
    counts = kernel_counts(device_kernel_names(torch, prof))
    wrapper = {n: c.launches for n, c in counters.items()}
    owned = {k for c in on_path for k in COUNTER_KERNELS[c]}
    stray = {k: n for k, n in counts.items() if n and k not in owned}
    off = {c: n for c, n in wrapper.items() if n and c not in on_path}
    silent = [c for c in on_path if not wrapper[c]]
    if not any(counts.values()):
        fail(f"torch.profiler recorded none of the port's kernels on {what}")
    if stray or off or silent:
        fail(f"{what}: kernels in the trace that its counters do not launch "
             f"{stray}, wrappers off the path that counted {off}, wrappers "
             f"on it that counted nothing {silent}")
    return result, by_counter(counts, on_path), wrapper


def check_launches(what: str, launches: dict, need: dict, idle) -> None:
    """At least need[name] launches of each kernel of a run, none of the
    idle ones."""
    for name, n in need.items():
        if launches[name] < n:
            fail(f"{name} launched {launches[name]} times on {what}, "
                 f"expected at least {n}")
    for name in idle:
        if launches[name]:
            fail(f"{name} launched {launches[name]} times on {what}, "
                 f"expected none")


def run_main_path(tmp: Path, kind: str, n_clouds: int = 16, spec=None):
    """One main path through `cli.tta.main`, traced (`traced_run`): its
    launches and its steady ms a step (median of steps 2-16, under the
    trace).  On an eager path the trace's launches must equal the
    wrappers' counts.  `spec`: a path's PATHS entry, for one not in
    PATHS."""
    import torch

    from uni_adapter_torch.cli import tta

    flags, (n_points, n_classes), bank, per_step, idle = spec or PATHS[kind]
    root = tmp / f"stream_{n_points}x{n_classes}"
    if not root.exists():
        write_stream(root, n_points, n_classes, n_clouds)
    bank = bank_arg(tmp, bank)
    what = f"the {kind} main path"
    summary, launches, wrapper = traced_run(torch, what, lambda: tta.main(
        ["--root", str(root), "--corruption", "uniform",
         "--precomputed-text-features", bank, *flags, "--device", "cuda",
         "--output-dir", str(tmp / "out"), "--name", f"smoke-{kind}"]),
        per_step)
    if "--use-scan" in flags and launches != wrapper:
        # the eager loop: every launch a wrapper counts runs, once
        fail(f"{what}: the trace's launches {launches} differ from the "
             f"wrappers' {wrapper}")

    step_ms = summary["step_ms"]["uniform"]
    steady = statistics.median(step_ms[1:])
    print(f"main path {kind}: {len(step_ms)} steps, first {step_ms[0]:.1f} "
          f"ms, then median {steady:.2f} ms/step ({1e3 / steady:.2f} pc/s), "
          f"mean {statistics.mean(step_ms[1:]):.2f}, "
          f"max {max(step_ms[1:]):.2f}")
    print(f"main path {kind} launches (traced): {launches}; the wrappers "
          f"counted {wrapper}")
    print(f"main path {kind} final logits finite: "
          f"{summary['finite']['uniform']}")
    if summary["cg_iters"]["uniform"] is not None:
        print(f"main path {kind} CG iterations a step: "
              f"{summary['cg_iters']['uniform']}")
    if len(step_ms) != n_clouds:
        fail(f"{kind}: {len(step_ms)} steps, expected {n_clouds}")
    check_launches(what, launches,
                   {n: k * n_clouds for n, k in per_step.items()}, idle)
    if kind in VARIANT_FLAGS:
        from uni_adapter_torch.engine import WARMUP_RUNS

        runs = n_clouds + (0 if "--use-scan" in flags else WARMUP_RUNS)
        want = {n: k * runs for n, k in per_step.items()}
        if {n: launches[n] for n in per_step} != want:
            fail(f"{what}: launches {launches}, expected exactly {want} "
                 f"(one forward a step)")
    if not summary["finite"]["uniform"]:
        fail(f"{kind}: non-finite final logits")
    for f in ("results.json", "results_zs.json"):
        res = json.loads((Path(summary["log_dir"]) / f).read_text())
        if set(res) != {"uniform"}:
            fail(f"{kind} {f}: unexpected content {res}")
    return launches, steady


#: bench.py's eight configurations as 15-corruption sweeps (its metric
#: names, `_metric_name` and its LVIS keys; protocol: 15 corruption
#: streams x 16 steps, batch 1 a stream, 1024 points): the metric; the
#: PATHS entry whose flags, kernels and launches a step the sweep shares;
#: flags added to it; and, where the stream is not the path's, its
#: (points, classes) and bank.  First the three MODE-DOTA headline
#: sweeps and the cache's (K = 40), then the Objaverse-LVIS ones (K =
#: 1156, a seeded (1156, 1024) bank): the cache at shot capacity 8, as
#: bench.py sets it above 256 classes (K·C = 9248: the prototype graph),
#: and MODE-DOTA at each residual precision tier.
LVIS_SWEEP = ["--dataset-name", "objaverse_lvis", "--npoints", "1024"]
SWEEPS = {
    "uni3d": ("mode_dota_tta_throughput_uni3d_large_15corruption_sweep",
              "uni3d", [], None),
    "ulip": ("mode_dota_tta_throughput_ulip_15corruption_sweep", "ulip", [],
             None),
    "openshape": ("mode_dota_tta_throughput_openshape_15corruption_sweep",
                  "openshape", [], None),
    "uni3d_cache": ("cache_tta_throughput_uni3d_large_15corruption_sweep",
                    "uni3d_cache", [], None),
    "uni3d_cache_lvis1156": (
        "cache_tta_throughput_uni3d_large_lvis1156", "uni3d_cache",
        LVIS_SWEEP + ["--cache-shot-capacity", "8"], ((1024, 1156),
                                                       (1156, 1024))),
    **{f"uni3d_lvis1156_res_{tier}": (
        f"mode_dota_tta_throughput_uni3d_large_lvis1156_res_{tier}", "uni3d",
        LVIS_SWEEP + ["--dota-residual-precision", tier],
        ((1024, 1156), (1156, 1024))) for tier in ("highest", "high",
                                                    "default")},
    # the other DOTA variants' sweeps (no bench.py metric): the 15 streams'
    # clouds in one forward a step, captured; plain DOTA also eager
    **{kind: (None, kind, [], None) for kind in ("uni3d_dota", "uni3d_gmm",
                                                 "uni3d_adaptive")},
    "uni3d_dota_eager": (None, "uni3d_dota", ["--use-scan", "false"], None),
}


def run_sweep(tmp: Path, name: str, batch1_ms, card: str,
              n_steps: int = 16) -> tuple:
    """A 15-corruption sweep through `cli.tta.main --vmap-corruptions
    true` on 15 synthetic streams of n_steps clouds, traced
    (`traced_run`): every kernel of the path launched at least as often
    as the batch-1 path launches it in n_steps steps, none of the others;
    15 keys in both result files, finite logits.  Prints its ms a step
    and pc/s under the trace (beside the batch-1 path's of this call,
    where that runs the same stream: `batch1_ms`) and, on the cache path,
    the CG's iterations a step.  Returns its launches and numbers."""
    import torch

    from uni_adapter_torch.cli import tta
    from uni_adapter_torch.config import CORRUPTIONS

    metric, path, extra, stream = SWEEPS[name]
    flags, (n_points, n_classes), bank, per_step, idle = PATHS[path]
    if stream is not None:
        (n_points, n_classes), bank = stream
    root = tmp / f"sweep_{n_points}x{n_classes}"
    if not root.exists():
        write_stream(root, n_points, n_classes, n_steps, CORRUPTIONS)
    torch.cuda.reset_peak_memory_stats()
    what = f"the {name} sweep"
    summary, launches, wrapper = traced_run(torch, what, lambda: tta.main(
        ["--root", str(root), "--corruption", "all", "--vmap-corruptions",
         "true", "--precomputed-text-features", bank_arg(tmp, bank), *flags,
         *extra, "--device", "cuda", "--output-dir", str(tmp / "out"),
         "--name", f"smoke-sweep-{name}"]), per_step)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    step_ms = summary["step_ms"][CORRUPTIONS[0]]
    if len(step_ms) != n_steps:
        fail(f"{what}: {len(step_ms)} steps, expected {n_steps}")
    check_launches(what, launches,
                   {n: k * n_steps for n, k in per_step.items()}, idle)
    if not all(summary["finite"].values()):
        fail(f"{what}: non-finite final logits ({summary['finite']})")
    for f in ("results.json", "results_zs.json"):
        res = json.loads((Path(summary["log_dir"]) / f).read_text())
        if list(res) != list(CORRUPTIONS):
            fail(f"{what} {f}: keys {list(res)}")
    steady = step_ms[1:]
    iters = summary["cg_iters"][CORRUPTIONS[0]]
    out = {"metric": metric, "streams": len(CORRUPTIONS), "steps": n_steps,
           "first_step_ms": step_ms[0],
           "median_ms": statistics.median(steady),
           "pc_s": len(CORRUPTIONS) * len(steady) / sum(steady) * 1e3,
           "batch1_median_ms": batch1_ms,
           "batch1_pc_s": None if batch1_ms is None else 1e3 / batch1_ms,
           "card": card, "peak_memory_gib": peak_gib,
           "cg_iters": summary["cg_iters"] if iters is not None else None}
    beside = ("" if batch1_ms is None else
              f"; the batch-1 path of this call {batch1_ms:.2f} ms/step, "
              f"{1e3 / batch1_ms:.2f} pc/s")
    protocol = (f"{metric}'s protocol" if metric else
                "bench.py's sweep protocol, no bench.py metric")
    print(f"sweep {name} ({protocol}, {card}): "
          f"{len(CORRUPTIONS)} streams x {n_steps} steps, first step "
          f"{step_ms[0]:.1f} ms, then median {out['median_ms']:.2f} ms/step, "
          f"{out['pc_s']:.1f} pc/s over the steady steps{beside}; peak "
          f"memory {peak_gib:.2f} GiB")
    if iters is not None:
        per_step_iters = list(zip(*summary["cg_iters"].values()))
        print(f"sweep {name} CG iterations a step (min-max over the 15 "
              f"streams): {[(min(i), max(i)) for i in per_step_iters]}")
    print(f"sweep {name} launches (traced): {launches}; the wrappers "
          f"counted {wrapper}")
    return launches, out


def fed(step, noises, outputs: list):
    """The step with its noise taken from `noises` in turn and its outputs
    appended to `outputs`."""
    it = iter(noises)

    def run(text, state, batch):
        state, out = step(text, state, batch, noise=next(it))
        outputs.append(out)
        return state, out

    return run


def check_streams_equal_sequential(torch) -> None:
    """`engine.run_streams` on the card against the same streams run one by
    one (`engine.run_stream`, seeds 42 + c), the same noise handed to
    both: Uni3D at width 1024 and depth 2, fp32, 3 streams.  Without
    residual learning over 4 steps, with it over 2 (step 1 runs the Adam
    loop): final logits within atol 1e-3 every step, identical correct
    counts; the residuals held in distribution (median < 1e-6, 90th
    percentile < 2e-4: Adam's first steps move an element whose gradient
    is near zero by ±lr on a last-bit difference).  Then plain, GMM and
    adaptive DOTA over 4 steps (no noise; GMM's stream c draws its init
    from seed 42 + c on both sides): final logits within max(1e-3,
    VARIANT_TOL of the largest), correct counts identical."""
    from uni_adapter_torch import engine
    from uni_adapter_torch.anchors import load_precomputed
    from uni_adapter_torch.config import Config, DotaConfig, ModelConfig
    from uni_adapter_torch.models.loader import build_backbone

    S, T = 3, 4
    mc = ModelConfig(eva_depth=2, compute_dtype="float32")
    model, _, _ = build_backbone("uni3d", mc, "cuda", seed=0)
    text = load_precomputed("large", "modelnet").cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    pcs = sphere_cloud(torch, gen, S * T, 1024).reshape(S, T, 1, 1024, 3)
    rgbs = torch.ones_like(pcs)
    targets = torch.randint(0, 40, (S, T, 1), generator=gen, device="cuda")
    noise = torch.randn(T, S, 1, 1024, 3, generator=gen, device="cuda")
    for res_learning, n in ((False, T), (True, 2)):
        cfg = Config(model=mc, dota=DotaConfig(res_learning=res_learning))
        step = engine.make_step_fn(cfg, model)
        outs = []
        res = engine.run_streams(cfg, model, text, pcs[:, :n], rgbs[:, :n],
                                 targets[:, :n], step_fn=fed(
                                     step, noise[:n], outs))
        err, residuals = 0.0, []
        for c in range(S):
            seq = []
            one = engine.run_stream(
                cfg, model, text, zip(pcs[c, :n], rgbs[c, :n],
                                      targets[c, :n]),
                seed=42 + c, step_fn=fed(step, noise[:n, c], seq))
            for t, (o, w) in enumerate(zip(outs, seq, strict=True)):
                err = max(err, (o.final_logits[c] - w.final_logits)
                          .abs().max().item())
                if not (torch.equal(o.correct[c], w.correct)
                        and torch.equal(o.zs_correct[c], w.zs_correct)):
                    fail(f"streams vs sequential (residuals "
                         f"{res_learning}): stream {c} step {t} correct "
                         f"counts differ")
            if res_learning:
                residuals.append(one["state"].res_state.residuals)
        if err > 1e-3:
            fail(f"streams vs sequential (residuals {res_learning}): final "
                 f"logits differ by {err}")
        line = (f"streams vs sequential on the card, Uni3D width 1024 depth "
                f"2 fp32, {S} streams x {n} steps, residual learning "
                f"{res_learning}: final logits max abs err {err:.3g} (atol "
                f"1e-3), correct counts identical")
        if res_learning:
            d = (res["state"].res_state.residuals
                 - torch.stack(residuals)).abs().flatten()
            med, p90 = d.median().item(), d.quantile(0.9).item()
            if not (med < 1e-6 and p90 < 2e-4):
                fail(f"streams vs sequential: residuals |d| median {med}, "
                     f"90th percentile {p90}")
            line += f"; residuals |d| median {med:.3g}, 90th pct {p90:.3g}"
        print(line)
    for flag in VARIANT_DOTA:
        cfg = Config(model=mc, dota=DotaConfig(use_mode_dota=False,
                                               **{flag: True}))
        step = engine.make_step_fn(cfg, model)
        outs = []
        engine.run_streams(cfg, model, text, pcs, rgbs, targets,
                           step_fn=fed_outputs(step, outs))
        err, scale = 0.0, 0.0
        for c in range(S):
            seq = []
            engine.run_stream(cfg, model, text,
                              zip(pcs[c], rgbs[c], targets[c]), seed=42 + c,
                              step_fn=fed_outputs(step, seq))
            for t, (o, w) in enumerate(zip(outs, seq, strict=True)):
                err = max(err, (o.final_logits[c] - w.final_logits)
                          .abs().max().item())
                scale = max(scale, w.final_logits.abs().max().item())
                if not torch.equal(o.correct[c], w.correct):
                    fail(f"streams vs sequential ({flag}): stream {c} step "
                         f"{t} correct counts differ")
        tol = max(1e-3, VARIANT_TOL[flag] * scale)
        print(f"streams vs sequential on the card ({flag}), Uni3D width 1024 "
              f"depth 2 fp32, {S} streams x {T} steps: final logits max abs "
              f"err {err:.3g} (tolerance max(1e-3, {VARIANT_TOL[flag]} x the "
              f"largest, {scale:.4g}) = {tol:.3g}), correct counts identical")
        if err > tol:
            fail(f"streams vs sequential ({flag}): final logits differ by "
                 f"{err}")


#: The DOTA variants' config flags.
VARIANT_DOTA = ("use_dota", "use_gmm_dota", "use_adaptive_dota")


#: The card-vs-CPU check of the cache's functions: (classes K, shot
#: capacity C, steps, classes the features come from).  K = 40 at C = 2:
#: the dense graph (80 nodes), every class of 12 filled and merged into;
#: K = 1156 at C = 8: the prototype graph (K·C = 9248 > 4096), 12 classes
#: of about 10 samples each.
CACHE_CASES = ((40, 2, 120, 12), (1156, 8, 120, 12))
#: The card's cache against the CPU's: both compute in fp32 (TF32 off) and
#: differ by summation order, which the CG carries into its solution
#: scaled by the condition number of L + 2λI (≤ (2 + 2λ) / 2λ ≈ 11).
#: Tolerances (max abs) on the final state's features, confidences and
#: probabilities, on every step's refined labels, and (relative to the
#: largest) on every step's fused logits; counts, slots and insert/merge
#: decisions must be identical.
CACHE_TOL = {"feats": 1e-5, "conf": 1e-5, "probs": 1e-5, "refined": 1e-5,
             "logits": 1e-5}


def cache_sequence(K: int, n_steps: int, n_cls: int, D: int = 1024):
    """A seeded (K, D) anchor bank and n_steps unit features, each 0.5·g
    (a direction that all share) plus 0.6·(w·a + (1 − w)·b) (w in
    0.5-0.7, plus noise), a mix of two anchors drawn from n_cls of the
    classes: the predictions stay on those classes (which fill and take
    merges), the probabilities are not one-hot, and g connects the
    graph's nodes (without it the prototype graph's nodes are isolated
    and its CG takes one iteration)."""
    import numpy as np

    rng = np.random.default_rng(K)
    text = rng.standard_normal((K, D)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    classes = rng.choice(K, n_cls, replace=False)
    pairs = rng.choice(classes, (n_steps, 2))
    w = rng.uniform(0.5, 0.7, (n_steps, 1)).astype(np.float32)
    g = rng.standard_normal(D).astype(np.float32)
    feats = (0.5 * g / np.linalg.norm(g)
             + 0.6 * (w * text[pairs[:, 0]] + (1 - w) * text[pairs[:, 1]])
             + 0.01 * rng.standard_normal((n_steps, D)).astype(np.float32))
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    return text, feats[:, None, :]


def run_cache_sequence(torch, device: str, text, feats, C: int) -> dict:
    """The cache step's functions on `device`, as the engine's cache step
    calls them, one feature a step: clip logits, `update_cache`, the
    refinement's parts (graph 'auto', CG: `start_refinement`,
    `refinement_iteration` until every system has stopped,
    `graph_readout`), `fuse_cache`; and, each step, the refined labels of
    the graph's valid nodes from the same solution (the readout reads
    them only through their argmax).  Returns the insert/merge
    decisions, CG iterations, fused logits and refined labels of every
    step, and the final state."""
    from uni_adapter_torch.adapt import cache, fusion
    from uni_adapter_torch.config import CacheConfig
    from uni_adapter_torch.engine import clip_logits_from
    from uni_adapter_torch.utils import math as umath

    cc = CacheConfig()
    K, D = text.shape
    w = torch.as_tensor(text, device=device).T
    state = cache.init(K, C, D, device=device)
    out = {"inserted": [], "iters": [], "logits": [], "refined": []}
    for f in torch.as_tensor(feats, device=device):
        clip, ent, prob, pred = clip_logits_from(f, w, 100.0)
        state, ins = cache.update_cache(
            state, pred, f, umath.normalized_entropy(ent[..., 0], K), prob,
            w, beta=cc.beta, logit_scale=100.0)
        ref = cache.start_refinement(state, cc.threshold, cc.lambda_reg,
                                     graph_mode="auto")
        umath.run_cg(lambda: cache.refinement_iteration(ref), cc.cg_max_iter)
        cl = cache.graph_readout(f, ref)
        valid = ref.graph.valid
        refined = umath.refined_labels(ref.sol, valid)[valid]
        for key, v in (("inserted", ins), ("iters", ref.cg.iters),
                       ("refined", refined),
                       ("logits", fusion.fuse_cache(clip, cl, 100.0))):
            out[key].append(v.cpu())
    out = {k: (v if k == "refined" else torch.stack(v))
           for k, v in out.items()}
    out["state"] = state._replace(**{n: t.cpu() for n, t in
                                     state._asdict().items()})
    return out


def cg_iteration_per_column_(A, s, tol: float = 1e-5):
    """A planted fault: `utils/math.cg_iteration_` with each column
    stopped on its own once its residual is below tol (the reference
    stops a system only when all its columns have converged)."""
    import torch

    live = (s.rz >= tol) & ~s.done[..., None]
    Ap = torch.matmul(A, s.p)
    alpha = (s.rz / (torch.sum(s.p * Ap, dim=-2) + 1e-8)).unsqueeze(-2)
    keep = live.unsqueeze(-2)
    r_new = s.r - alpha * Ap
    rz_new = torch.sum(r_new * r_new, dim=-2)
    beta = (rz_new / (s.rz + 1e-8)).unsqueeze(-2)
    s.x.copy_(torch.where(keep, s.x + alpha * s.p, s.x))
    s.p.copy_(torch.where(keep, r_new + beta * s.p, s.p))
    s.r.copy_(torch.where(keep, r_new, s.r))
    s.rz.copy_(torch.where(live, rz_new, s.rz))
    s.iters.add_(live.any(dim=-1).to(torch.int32))
    s.done.logical_or_(torch.all(s.rz < tol, dim=-1))
    return s.done.all()


def cache_errors(got: dict, want: dict) -> tuple:
    """Each CACHE_TOL quantity's error of `got` against `want`, as a
    multiple of its tolerance, and whether the decisions, counts and
    slots are identical."""
    import torch

    errs = {n: (getattr(got["state"], n) - getattr(want["state"], n))
            .abs().max().item() for n in ("feats", "conf", "probs")}
    errs["refined"] = max((g - w).abs().max().item() if g.shape == w.shape
                          else float("inf")
                          for g, w in zip(got["refined"], want["refined"]))
    errs["logits"] = ((got["logits"] - want["logits"]).abs().max()
                      / want["logits"].abs().max()).item()
    same = torch.equal(got["inserted"], want["inserted"]) and all(
        torch.equal(getattr(got["state"], n), getattr(want["state"], n))
        for n in ("counts", "valid"))
    return {n: e / CACHE_TOL[n] for n, e in errs.items()}, same


def check_cache_card_vs_cpu(torch) -> None:
    """The port's cache functions on the card against the same functions on
    the CPU, fed one seeded sequence of unit features (CACHE_CASES):
    identical insert/merge decisions, counts and occupied slots (so
    identical merged slots), the CG's iterations printed side by side,
    and the state, every step's refined labels and fused logits within
    CACHE_TOL.  Three planted faults on the card side must
    each fail it: TF32 on for the products, a per-column CG stop, a merge
    into the wrong slot."""
    from uni_adapter_torch.adapt import cache
    from uni_adapter_torch.utils import math as umath

    def tf32(run):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return run()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    def patched(module, name, fn):
        def wrap(run):
            saved = getattr(module, name)
            setattr(module, name, fn)
            try:
                return run()
            finally:
                setattr(module, name, saved)
        return wrap

    faults = {
        "TF32 products": tf32,
        "per-column CG stop": patched(umath, "cg_iteration_",
                                      cg_iteration_per_column_),
        "merge into the wrong slot": patched(
            cache, "merge_slot",
            lambda sims: (torch.argmax(sims, -1) + 1) % sims.shape[-1]),
    }
    for K, C, n_steps, n_cls in CACHE_CASES:
        text, feats = cache_sequence(K, n_steps, n_cls)
        t0 = time.perf_counter()
        want = run_cache_sequence(torch, "cpu", text, feats, C)
        cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = run_cache_sequence(torch, "cuda", text, feats, C)
        card_s = time.perf_counter() - t0
        ratios, same = cache_errors(got, want)
        merges = int((~want["inserted"]).sum())
        print(f"cache card vs cpu, K {K}, C {C}, {n_steps} steps "
              f"({merges} merges, {int(want['state'].valid.sum())} slots "
              f"filled; card {card_s:.1f} s, cpu {cpu_s:.1f} s): "
              f"decisions, counts and slots identical: {same}; "
              f"err/tolerance {ratios}")
        print(f"cache card vs cpu, K {K}: CG iterations card "
              f"{got['iters'].tolist()}")
        print(f"cache card vs cpu, K {K}: CG iterations cpu  "
              f"{want['iters'].tolist()}")
        if not same or max(ratios.values()) > 1 or merges == 0:
            fail(f"cache on the card disagrees with the CPU at K {K}: "
                 f"identical {same}, err/tolerance {ratios}, {merges} "
                 f"merges")
        for what, plant in faults.items():
            bad = plant(lambda: run_cache_sequence(torch, "cuda", text, feats,
                                                   C))
            r, same = cache_errors(bad, want)
            print(f"cache planted fault at K {K}, {what}: identical {same}, "
                  f"err/tolerance {r}")
            if same and max(r.values()) <= 1:
                fail(f"the cache check at K {K} passes with a planted "
                     f"fault: {what}")


def check_cache_streams_equal_sequential(torch) -> None:
    """`engine.run_streams` on the cache path on the card against the same
    streams run one by one (`engine.run_stream`): Uni3D at width 1024
    and depth 2, fp32, 3 streams x 8 steps, shot capacity 2 (classes fill
    and merge); clouds at scales 0.25-2 so that predictions differ.  Final
    logits within atol 1e-3 every step, correct counts identical, and
    each stream's CG iterations equal its own run's, step by step."""
    from uni_adapter_torch import engine
    from uni_adapter_torch.anchors import load_precomputed
    from uni_adapter_torch.config import (CacheConfig, Config, DotaConfig,
                                          ModelConfig)
    from uni_adapter_torch.models.loader import build_backbone

    S, T = 3, 8
    mc = ModelConfig(eva_depth=2, compute_dtype="float32")
    model, _, _ = build_backbone("uni3d", mc, "cuda", seed=0)
    text = load_precomputed("large", "modelnet").cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    scale = torch.exp(torch.empty(S * T, 1, 1, device="cuda").uniform_(
        -1.4, 0.7, generator=gen))
    pcs = (scale * sphere_cloud(torch, gen, S * T, 1024)).reshape(
        S, T, 1, 1024, 3)
    rgbs = torch.ones_like(pcs)
    targets = torch.randint(0, 40, (S, T, 1), generator=gen, device="cuda")
    cfg = Config(model=mc, dota=DotaConfig(use_mode_dota=False),
                 cache=CacheConfig(shot_capacity=2))
    res = engine.run_streams(cfg, model, text, pcs, rgbs, targets)
    err, seq_iters = 0.0, []
    for c in range(S):
        seq = []
        one = engine.run_stream(cfg, model, text,
                                zip(pcs[c], rgbs[c], targets[c]),
                                seed=42 + c, step_fn=fed_outputs(
                                    engine.make_step_fn(cfg, model), seq))
        for t, (o, w) in enumerate(zip(res["outputs"], seq, strict=True)):
            err = max(err, (o.final_logits[c] - w.final_logits)
                      .abs().max().item())
            if not torch.equal(o.correct[c], w.correct):
                fail(f"cache streams vs sequential: stream {c} step {t} "
                     f"correct counts differ")
        seq_iters.append(one["cg_iters"])
    iters = torch.stack([o.cg_iters for o in res["outputs"]]).T.tolist()
    print(f"cache streams vs sequential on the card, Uni3D width 1024 depth "
          f"2 fp32, {S} streams x {T} steps: final logits max abs err "
          f"{err:.3g} (atol 1e-3), correct counts identical; CG iterations "
          f"a step, streams run {iters}, one by one {seq_iters}")
    if err > 1e-3 or iters != seq_iters:
        fail("cache streams vs sequential: logits or CG iterations differ")


def fed_outputs(step, outputs: list):
    """The step with its outputs appended to `outputs`."""
    def run(text, state, batch):
        state, out = step(text, state, batch)
        outputs.append(out)
        return state, out
    return run


#: The residual loop's products at the LVIS sweep's shape: 15 streams'
#: (K, 2D) · (2D, K) at K = 1156, D = 1024, one of the M = 4 a step.
TIER_PRODUCT = (15, 1156, 2048)


def check_residual_tiers(torch, gen) -> dict:
    """The 'default' tier's product on the card (`tier_product`: bf16
    operands, fp32 sums and result) and its input gradient (g @ P, the
    JAX custom VJP's backward at the tier), each against the same
    bf16-rounded operands multiplied in fp32 with TF32 off (the CPU's
    route): within 1e-5 of the result's largest value; a bf16-rounded
    result (a product that returns bf16) and, for the gradient, an fp32
    backward (g @ P unrounded) at least 10× further.  Then each tier's
    product timed at TIER_PRODUCT (device ms, CUDA events)."""
    from uni_adapter_torch.adapt import residual

    def bf16(t):
        return t.bfloat16().float()

    S, K, D2 = TIER_PRODUCT
    X = torch.randn(S, K, D2, generator=gen, device="cuda")
    P = torch.randn(S, K, D2, generator=gen, device="cuda")
    G = torch.randn(S, K, K, generator=gen, device="cuda")
    x = X.clone().requires_grad_(True)
    got = residual.tier_product(x, P, "default")
    (got_g,) = torch.autograd.grad(got, x, G)
    Pt = P.transpose(-1, -2)
    for what, out, want, wrong in (
            ("product", got, torch.matmul(bf16(X), bf16(Pt)),
             {"a bf16 result": torch.matmul(X.bfloat16(),
                                            Pt.bfloat16()).float()}),
            ("gradient", got_g, torch.matmul(bf16(G), bf16(P)),
             {"a bf16 result": torch.matmul(G.bfloat16(),
                                            P.bfloat16()).float(),
              "an fp32 backward": torch.matmul(G, P)})):
        scale = want.abs().max().item()
        err = (out - want).abs().max().item() / scale
        errs = {w: (t - want).abs().max().item() / scale
                for w, t in wrong.items()}
        print(f"residual tier 'default' {what} at {TIER_PRODUCT}: relative "
              f"err {err:.3g} against fp32 sums of the bf16 operands (gate "
              f"1e-5); " + ", ".join(f"{w} {e:.3g}" for w, e in errs.items()))
        if out.dtype != torch.float32 or err > 1e-5 or \
                min(errs.values()) < 10 * err:
            fail(f"the 'default' tier's {what} is not bf16 operands with "
                 f"fp32 sums and result")
    times = {}
    for tier in residual.PRECISIONS:
        times[tier] = time_ms(lambda: residual.tier_product(X, P, tier))
    flops = 2 * S * K * K * D2
    print(f"residual tier products at {TIER_PRODUCT}, ms (TFLOP/s): "
          + ", ".join(f"{t} {ms:.3f} ({flops / ms / 1e9:.0f})"
                      for t, ms in times.items()))
    return times


def run_continual(tmp: Path, n_steps: int = 4, path: str = "uni3d") -> dict:
    """`cli.tta.main --corruption all --continual true` (Uni3D-L, bf16, the
    method of PATHS[path]) on 15 streams of n_steps clouds, traced
    (`traced_run`): each corruption starts from the one before's carry,
    its step counter running n_steps·i → n_steps·(i + 1)."""
    import torch

    from uni_adapter_torch.cli import tta
    from uni_adapter_torch.config import CORRUPTIONS

    root = tmp / f"continual_1024x40x{n_steps}"
    if not root.exists():
        write_stream(root, 1024, 40, n_steps, CORRUPTIONS)
    flags, _, _, per_step, idle = PATHS[path]
    what = f"the --continual path ({path})"
    summary, launches, wrapper = traced_run(torch, what, lambda: tta.main(
        ["--root", str(root), "--corruption", "all", "--continual", "true",
         "--precomputed-text-features", "large", *flags, "--device", "cuda",
         "--output-dir", str(tmp / "out"), "--name",
         f"smoke-continual-{path}"]), per_step)
    steps = [summary["steps"][c] for c in CORRUPTIONS]
    want = [[n_steps * i, n_steps * (i + 1)] for i in range(len(CORRUPTIONS))]
    if steps != want:
        fail(f"--continual: step counters {steps}, expected {want}")
    if not all(summary["finite"].values()):
        fail("--continual: non-finite final logits")
    check_launches(what, launches, {n: k * n_steps * len(CORRUPTIONS)
                                    for n, k in per_step.items()}, idle)
    print(f"--continual ({path}): {CORRUPTIONS[0]} steps {steps[0]}, "
          f"{CORRUPTIONS[1]} "
          f"steps {steps[1]} (from the first's carry), ..., {CORRUPTIONS[-1]}"
          f" steps {steps[-1]}; launches (traced) {launches}; the wrappers "
          f"counted {wrapper}")
    return launches


def check_replayed_kernels(torch, what: str, run, per_step: dict,
                           steps: int) -> None:
    """A trace of run() (`steps` steps of a scan whose step is already
    captured, so that it only replays) must hold, for each counter of
    `per_step` (an eager step's launches by counter), `steps` times its
    launches, and no other port kernel.  The kernels are read from the
    trace's raw device events (`device_kernel_times`): the function events
    of a trace that records the host too once lacked one replay's FPS and
    kNN on an H100.  A trace that holds other counts is taken again, up to
    three times; a stray port kernel fails at once."""
    want = {c: steps * per_step.get(c, 0) for c in COUNTER_KERNELS}
    owned = {k for c in per_step for k in COUNTER_KERNELS[c]}
    for attempt in range(3):
        counts = kernel_counts(name for name, _ in
                               device_kernel_times(torch, run))
        got = by_counter(counts, per_step)
        stray = {k: n for k, n in counts.items() if n and k not in owned}
        print(f"scan {what}: launches in a trace of {steps} replayed steps "
              f"{ {c: n for c, n in got.items() if n} }, {steps} eager "
              f"steps' { {c: n for c, n in want.items() if n} }")
        if stray:
            fail(f"scan {what}: the replays launched {stray}, which no "
                 f"eager step launches")
        if got == want:
            return
    fail(f"scan {what}: the replays' kernels {counts} are not the eager "
         f"steps' in three traces")


def check_captured_noise(torch) -> None:
    """Draws of two generators in a captured segment, replayed four times,
    against the same generators' eager draws from the same seeds: equal,
    bitwise."""
    from uni_adapter_torch.engine import _Segment

    gens = tuple(torch.Generator(device="cuda").manual_seed(42 + i)
                 for i in range(2))
    refs = [torch.Generator(device="cuda").manual_seed(42 + i)
            for i in range(2)]
    shape = (2, 1024, 3)
    seg = _Segment(lambda: torch.stack(
        [torch.randn(shape, generator=g, device="cuda") for g in gens]),
        gens)
    seg.capture()
    got = [seg().clone() for _ in range(4)]
    want = [torch.stack([torch.randn(shape, generator=g, device="cuda")
                         for g in refs]) for _ in range(4)]
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"scan: noise of 2 generators in 4 replays equal to their eager "
          f"draws: {same}")
    if not same:
        fail("the captured step's noise differs from the eager draws")


def check_captured_fps_grid(torch, gen) -> None:
    """`fps_grid.cu`'s cluster launch (`cudaLaunchKernelEx`) captured and
    replayed at 10,000 points (the LVIS path's, in registers) and at
    24,576 (where its launch sets the kernel's shared-memory attribute at
    every call, inside the capture too): indices equal to an eager
    launch's, in three replays."""
    from uni_adapter_torch.engine import _Segment
    from uni_adapter_torch.ops import fps

    for n in (10000, 24576):
        xyz = sphere_cloud(torch, gen, 2, n)
        want = fps.farthest_point_sample(xyz, 512)
        seg = _Segment(lambda: fps.farthest_point_sample(xyz, 512))
        seg.capture()
        same = all(torch.equal(seg(), want) for _ in range(3))
        print(f"scan: fps_grid captured at (2, {n}) → 512, replays equal to "
              f"an eager launch: {same}")
        if not same:
            fail(f"captured fps_grid at {n} points differs from eager")


def stacked_eager(torch, cfg, model, text, pcs, rgbs, targets):
    """The eager loop (`engine.run_stream`) on one stream, or on S
    (`engine.run_streams`, pcs (S, T, ...)): its final state, outputs
    stacked (T, ...) and ms a step."""
    from uni_adapter_torch import engine

    if pcs.dim() == 5:
        res = engine.run_streams(cfg, model, text, pcs, rgbs, targets)
        return res["state"], engine.stack_outputs(res["outputs"]), \
            res["step_ms"]
    outs = []
    res = engine.run_stream(cfg, model, text, zip(pcs, rgbs, targets),
                            step_fn=fed_outputs(engine.make_step_fn(
                                cfg, model), outs))
    return res["state"], engine.stack_outputs(outs), res["step_ms"]


def scan_against_eager(torch, what, cfg, model, text, pcs, rgbs, targets,
                       atol, trace=False) -> tuple:
    """The stream(s) through the eager loop and through the scan (its
    step captured and replayed): final logits within atol every step,
    identical correct counts and CG iterations, both finite; ms a step of
    each (median of the steps after the first) printed.  With `trace`, a
    second scan of the first two steps is traced and must launch each
    kernel as often as two eager steps do (the wrappers' counts over the
    eager run, a step's the same at every step).  Returns the eager and
    the scan's final states and (eager, captured) ms a step."""
    from uni_adapter_torch import engine

    streams = pcs.dim() == 5
    T = pcs.shape[1] if streams else pcs.shape[0]
    counters = zeroed_counters()
    e_state, e_out, e_ms = stacked_eager(torch, cfg, model, text, pcs,
                                         rgbs, targets)
    eager = {c: n.launches for c, n in counters.items() if n.launches}
    if any(n % T for n in eager.values()):
        fail(f"scan {what}: the eager run's {T} steps launched {eager}")
    per_step = {c: n // T for c, n in eager.items()}
    scan_fn = engine.make_scan_fn(cfg, model)
    run = engine.run_streams_scan if streams else engine.run_stream_scan
    torch.cuda.reset_peak_memory_stats()
    s_state, s_out = run(cfg, model, text, pcs, rgbs, targets,
                         scan_fn=scan_fn)
    peak = torch.cuda.max_memory_allocated() / 2**30
    s_ms = scan_fn.step_ms
    err = (e_out.final_logits - s_out.final_logits).abs().max().item()
    same = (torch.equal(e_out.correct, s_out.correct)
            and torch.equal(e_out.zs_correct, s_out.zs_correct))
    iters_same = (e_out.cg_iters is None
                  or torch.equal(e_out.cg_iters, s_out.cg_iters))
    finite = bool(torch.isfinite(s_out.final_logits).all()
                  and torch.isfinite(e_out.final_logits).all())
    em, sm = statistics.median(e_ms[1:]), statistics.median(s_ms[1:])
    print(f"scan {what}: eager {em:.2f} ms/step, captured {sm:.2f} ms/step "
          f"(first step {e_ms[0]:.1f} / {s_ms[0]:.1f} ms; peak memory "
          f"{peak:.2f} GiB); final logits max abs err {err:.3g} (atol "
          f"{atol}); correct counts identical {same}; CG iterations "
          f"{None if e_out.cg_iters is None else e_out.cg_iters.tolist()} "
          f"identical {iters_same}; finite {finite}")
    if err > atol or not (same and iters_same and finite):
        fail(f"scan {what}: the captured step disagrees with the eager one")
    if trace:
        cut = (lambda a: a[:, :2]) if streams else (lambda a: a[:2])
        check_replayed_kernels(torch, what, lambda: run(
            cfg, model, text, cut(pcs), cut(rgbs), cut(targets),
            scan_fn=scan_fn), per_step, 2)
    return e_state, s_state, (em, sm)


def check_scan(torch) -> dict:
    """The captured step (`engine.run_stream_scan`, `run_streams_scan`)
    against the eager loop on the card: Uni3D-L bf16 at full width and
    depth, MODE-DOTA with residual learning, batch 1, 16 clouds; Uni3D
    at width 1024 and depth 2 in fp32, residuals off (8 steps: logits
    within 1e-4) and on at tiers 'highest' and 'high' (2 steps: logits
    within 1e-3, residuals within the envelope of the streams check, the
    Adam count 10, the sample count equal; the two tiers' captured
    residuals must differ: the captured loop keeps TF32); ULIP-2's 15-stream sweep (4 steps); Uni3D-L on the
    cache, ModelNet40 (the CG) and ShapeNetCore (the explicit solve), 8
    clouds: CG iterations identical and the refined labels of the final
    caches equal.  Each full-size path's replays are traced: two
    replayed steps must launch each kernel as often as two eager steps.
    Returns ms a step, eager and captured, by path."""
    from uni_adapter_torch.adapt import cache as cache_mod
    from uni_adapter_torch.anchors import load_precomputed
    from uni_adapter_torch.config import (CacheConfig, Config, DataConfig,
                                          DotaConfig, ModelConfig)
    from uni_adapter_torch.models.loader import build_backbone
    from uni_adapter_torch.utils import math as umath

    check_captured_noise(torch)
    gen = torch.Generator(device="cuda").manual_seed(11)
    check_captured_fps_grid(torch, gen)
    text = load_precomputed("large", "modelnet").cuda()
    ms = {}

    def stream(T, S=None, N=1024, scale=False):
        lead = (T,) if S is None else (S, T)
        n = T if S is None else S * T
        pcs = sphere_cloud(torch, gen, n, N)
        if scale:   # predictions that differ from cloud to cloud
            pcs = pcs * torch.exp(torch.empty(n, 1, 1, device="cuda")
                                  .uniform_(-1.4, 0.7, generator=gen))
        pcs = pcs.reshape(*lead, 1, N, 3)
        return (pcs, torch.ones_like(pcs),
                torch.randint(0, 40, (*lead, 1), generator=gen,
                              device="cuda"))

    # depth 2, fp32: the tolerance of an fp32 path
    mc = ModelConfig(eva_depth=2, compute_dtype="float32")
    model, _, _ = build_backbone("uni3d", mc, "cuda", seed=0)
    pcs, rgbs, tgts = stream(8)
    residuals = {}
    for res_learning, T, atol, tier in ((False, 8, 1e-4, "highest"),
                                        (True, 2, 1e-3, "highest"),
                                        (True, 2, 1e-3, "high")):
        cfg = Config(model=mc, dota=DotaConfig(res_learning=res_learning,
                                               residual_precision=tier))
        e, s, _ = scan_against_eager(
            torch, f"uni3d depth 2 fp32, residuals {res_learning} ({tier})",
            cfg, model, text, pcs[:T], rgbs[:T], tgts[:T], atol)
        if not torch.equal(e.method_state.t, s.method_state.t):
            fail("scan: sample counts differ")
        if res_learning:
            residuals[tier] = s.res_state.residuals
            d = (e.res_state.residuals - s.res_state.residuals).abs()
            med, p90 = d.median().item(), d.flatten().quantile(0.9).item()
            print(f"scan residuals ({tier}) |d| median {med:.3g}, 90th pct "
                  f"{p90:.3g}; Adam count {int(s.res_state.count)}")
            if not (med < 1e-6 and p90 < 2e-4
                    and int(s.res_state.count) == 10
                    and torch.equal(e.res_state.count, s.res_state.count)):
                fail("scan: residuals or the Adam count out of the envelope")
    # the captured 'high' loop keeps TF32: its residuals are not fp32's
    tf32 = (residuals["high"] - residuals["highest"]).abs().max().item()
    print(f"scan: captured residuals 'high' vs 'highest' max abs diff "
          f"{tf32:.3g}")
    if tf32 == 0:
        fail("scan: the captured 'high' tier computed fp32 products")

    # full width and depth, bf16
    cfg = Config(model=ModelConfig(), dota=DotaConfig())
    model, _, _ = build_backbone("uni3d", cfg.model, "cuda", seed=0)
    pcs, rgbs, tgts = stream(16)
    _, _, ms["uni3d"] = scan_against_eager(
        torch, "uni3d (Uni3D-L, MODE-DOTA, residuals, batch 1)", cfg, model,
        text, pcs, rgbs, tgts, 1e-2, trace=True)
    for name, dataset in (("uni3d_cache", "modelnet"),
                          ("uni3d_cache_shapenet", "shapenetcore")):
        ccfg = Config(model=cfg.model, dota=DotaConfig(use_mode_dota=False),
                      data=DataConfig(dataset_name=dataset)).resolve()
        bank = load_precomputed("large", dataset).cuda()
        pcs, rgbs, tgts = stream(8, scale=True)
        e, s, ms[name] = scan_against_eager(
            torch, name, ccfg, model, bank, pcs, rgbs, tgts, 1e-2,
            trace=True)
        cc = ccfg.cache
        labels = []
        for st in (e, s):
            ref = cache_mod.start_refinement(
                st.method_state, cc.threshold, cc.lambda_reg,
                cc.use_new_approximation, cc.graph_mode)
            if ref.cg is not None:
                umath.run_cg(lambda: cache_mod.refinement_iteration(ref),
                             cc.cg_max_iter)
            valid = ref.graph.valid
            labels.append(umath.refined_labels(ref.sol, valid)
                          .argmax(-1)[valid])
        print(f"scan {name}: refined labels of the final caches equal: "
              f"{torch.equal(*labels)} ({labels[0].numel()} nodes)")
        if not torch.equal(*labels):
            fail(f"scan {name}: refined labels differ")
    del model
    ucfg = Config(model=ModelConfig(vlm3d="ulip"), dota=DotaConfig())
    model, _, _ = build_backbone("ulip", ucfg.model, "cuda", seed=0)
    bank = torch.randn(40, 512, generator=gen, device="cuda")
    bank = bank / bank.norm(dim=1, keepdim=True)
    pcs, rgbs, tgts = stream(4, S=15)
    _, _, ms["sweep_ulip"] = scan_against_eager(
        torch, "sweep_ulip (15 streams)", ucfg, model, bank, pcs, rgbs, tgts,
        1e-2, trace=True)
    return {k: {"eager_ms": v[0], "captured_ms": v[1]} for k, v in ms.items()}


#: The extraction paths at full width and depth: CLI flags, then the
#: layers, heads and tokens of every map (one (B, H, N, hd) attention launch
#: a layer).
EXTRACT_PATHS = {
    "uni3d": (["--vlm3d", "uni3d", "--depth", "24"], 24, 16, 513),
    "openshape": (["--vlm3d", "openshape"], 12, 8, 385),
    "ulip": (["--vlm3d", "ulip"], 12, 6, 513),
}


def run_extraction(tmp: Path, kind: str, extra=(), label: str = "") -> dict:
    """`python -m uni_adapter_torch.cli.extract_attention --device cuda` on
    the synthetic sphere (`extra` flags added, e.g. `--checkpoint`): the
    whole `main` where matplotlib imports, else its device half `extract`
    (the same device work, no figures).  Checks the maps and the launch
    counters, then times one more extraction."""
    import importlib.util

    import numpy as np
    import torch

    from uni_adapter_torch.cli import extract_attention

    flags, layers, H, N = EXTRACT_PATHS[kind]
    name = f"{kind}{label}"
    out = tmp / f"attn-{name}"
    argv = ["--device", "cuda", "--out", str(out), *flags, *extra]
    figures = importlib.util.find_spec("matplotlib") is not None
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    if figures:
        extractor, pc, _ = extract_attention.main(argv)
    else:
        extractor, pc, _ = extract_attention.extract(
            extract_attention.parse_args(argv))
    run_s = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}

    maps = np.load(out / "attention_maps.npz")
    if sorted(maps.files) != sorted(f"layer_{i}" for i in range(layers)):
        fail(f"extract {name}: attention_maps.npz holds {maps.files}")
    for key in maps.files:
        a = maps[key]
        if a.shape != (1, H, N, N) or not np.isfinite(a).all() or \
                np.abs(a.sum(-1) - 1).max() > 1e-3:
            fail(f"extract {name}: {key} is {a.shape}, or not finite, or its "
                 f"rows do not sum to 1")
    if not (out / "attention_stats.json").exists():
        fail(f"extract {name}: no attention_stats.json")
    if launches["attention_heads"] != layers:
        fail(f"extract {name}: attention_heads launched "
             f"{launches['attention_heads']} times, expected {layers}")
    if any(launches[n] for n in ("eva_attn_block", "eva_attention")
           + FP32_KERNELS):
        fail(f"extract {name}: the block, natural-layout or an fp32 kernel "
             f"ran ({launches})")
    t0 = time.perf_counter()
    extractor.extract(pc)              # ends in the copy to the host
    one_ms = (time.perf_counter() - t0) * 1e3
    xyz = torch.as_tensor(pc, device="cuda")[None]
    cloud6 = torch.cat([xyz, torch.ones_like(xyz)], dim=-1)   # as extract()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extractor.model(*FORWARD_INPUTS[kind](cloud6),
                        return_attn=True)
        torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    drawn = ("figures drawn" if figures else
             "matplotlib does not import here: figures not drawn")
    print(f"extract {name}: {layers} maps of {(1, H, N, N)} in "
          f"attention_maps.npz; {drawn}; whole run {run_s:.1f} s, one "
          f"extraction {one_ms:.1f} ms wall, of which the forward with its "
          f"maps on the card {fwd_ms:.1f} ms")
    print(f"extract {name} launches: {launches}")
    return launches


def run_extraction_fp32(kind: str) -> dict:
    """fp32 extraction at full width and depth on the synthetic sphere: the
    backbone from `build_backbone` with `compute_dtype="float32"`, through
    `AttentionExtractor` (the extraction CLI has no dtype flag).  Every
    layer's map finite with rows summing to 1, one row-9 launch a layer and
    no other attention kernel; then one more extraction, timed."""
    import numpy as np
    import torch

    from uni_adapter_torch.analysis.attention import AttentionExtractor
    from uni_adapter_torch.cli.extract_attention import (WEIGHT_SEED,
                                                         synthetic_sphere)
    from uni_adapter_torch.config import ModelConfig
    from uni_adapter_torch.models.loader import build_backbone

    layers, H, N = EXTRACT_PATHS[kind][1:]
    model, n_group, group_size = build_backbone(
        kind, ModelConfig(vlm3d=kind, compute_dtype="float32"), "cuda",
        seed=WEIGHT_SEED)
    extractor = AttentionExtractor(model, n_group, group_size, vlm3d=kind)
    pc = synthetic_sphere()
    counters = launch_counters()
    for c in counters.values():
        c.launches = 0
    maps = extractor.extract(pc)
    launches = {n: c.launches for n, c in counters.items()}
    if sorted(maps) != sorted(f"layer_{i}" for i in range(layers)):
        fail(f"extract {kind} fp32: maps {sorted(maps)}")
    for key, a in maps.items():
        if a.shape != (1, H, N, N) or not np.isfinite(a).all() or \
                np.abs(a.sum(-1) - 1).max() > 1e-5:
            fail(f"extract {kind} fp32: {key} is {a.shape}, or not finite, "
                 f"or its rows do not sum to 1 within 1e-5")
    others = [n for n in BF16_ATTENTION + FP32_ATTENTION
              if n != "attention_fp32" and launches[n]]
    if launches["attention_fp32"] != layers or others or \
            launches["attn_f32_tc"] != layers:
        fail(f"extract {kind} fp32: attention_fp32 launched "
             f"{launches['attention_fp32']} times (expected {layers}; "
             f"attn_f32_tc_kernel {launches['attn_f32_tc']}), and {others} "
             f"ran")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    extractor.extract(pc)              # ends in the copy to the host
    one_ms = (time.perf_counter() - t0) * 1e3
    print(f"extract {kind} fp32: {layers} maps of {(1, H, N, N)}, one "
          f"extraction {one_ms:.1f} ms wall")
    print(f"extract {kind} fp32 launches: {launches}")
    return launches


#: The DOTA variants' functions on the card against the CPU: (classes K,
#: steps) on `cache_sequence`'s seeded unit features from 12 of the
#: classes; plain DOTA takes DOTA_STEPS[K] steps (it has no split, and at
#: K = 1156 one copy of its (K, D, D) covariances is 4.8 GB, which the
#: CPU side takes seconds a step to update).  The adaptive split check at
#: fit 50 must split (threshold 10 σ_init = 1e-3, count ≥ 2).
VARIANT_CASES = ((40, 60), (1156, 60))
DOTA_STEPS = {40: 20, 1156: 3}
#: Tolerances of the variants' card-vs-CPU check, each error relative to
#: the largest |value| of its quantity (every step's scores, each field of
#: the final state); masks and counts must be identical.  Both sides are
#: fp32 with TF32 off, and differ by summation order (~1e-7 relative a
#: product).  Plain DOTA's Λ is an inverse (cuSOLVER's Cholesky against
#: LAPACK's), which scales those differences by the condition number of
#: (1 − ε)Σ̄ + εI, a few hundred here: 1e-4.  GMM-DOTA's and adaptive
#: DOTA's E-step takes a softmax over modes of log-densities Σ_d (x−μ)²/σ
#: of ~1e4 (σ ≈ 1e-4 a dimension): a summation-order difference of 1e-7
#: relative moves an exponent by ~1e-3, and with it the responsibilities
#: and everything they weight (the first card run read 1.7e-4 on GMM's
#: σ): 1e-3.
VARIANT_TOL = {"use_dota": 1e-4, "use_gmm_dota": 1e-3,
               "use_adaptive_dota": 1e-3}


def run_variant_sequence(torch, device: str, flag: str, text, feats) -> dict:
    """One DOTA variant's functions on `device`, as the engine's step calls
    them, one feature a step: the clip probabilities, `predict` of the
    state before the fit (plain DOTA with a 5-step prior), `fit`, then
    `update` (the adaptive split check inside `fit`).  GMM-DOTA's init is
    drawn on the CPU and moved, so both sides start equal.  Returns every
    step's scores and the final state, on the CPU."""
    from uni_adapter_torch.adapt import adaptive, dota, gmm
    from uni_adapter_torch.engine import clip_logits_from

    eps = 1e-4
    K, D = text.shape
    w = torch.as_tensor(text, device=device).T
    if flag == "use_dota":
        st = dota.init(eps, 1e-4, D, K, torch.full((D, K), 1e-3,
                                                    device=device))
    elif flag == "use_gmm_dota":
        st = gmm.init(eps, 1e-4, D, K, w.cpu(), num_modes=4,
                      generator=torch.Generator().manual_seed(0))
        st = type(st)(*(t.to(device) for t in st))
    else:
        st = adaptive.init(eps, 1e-4, D, K, w, max_modes=4)
    scores = []
    for f in torch.as_tensor(feats, device=device):
        prob = clip_logits_from(f, w, 100.0)[2]
        if flag == "use_dota":
            scores.append(dota.predict(st, f, prior_pre_steps=5))
            st = dota.update(dota.fit(st, f, prob), eps)
        elif flag == "use_gmm_dota":
            scores.append(gmm.predict(st, f, alpha_max=0.5))
            st = gmm.update(gmm.fit(st, f, prob), eps)
        else:
            scores.append(adaptive.predict(st, f, eps))
            st = adaptive.fit(st, f, prob, eps, split_threshold=1e-3,
                              min_count_to_split=2.0)
    return {"scores": torch.stack(scores).cpu(),
            "state": type(st)(*(t.cpu() for t in st))}


def variant_errors(flag: str, got: dict, want: dict) -> tuple:
    """Each quantity's error relative to its largest |value|, as a multiple
    of VARIANT_TOL[flag]; and whether the masks and counts are equal.
    Adaptive DOTA's means and variances are compared on the valid slots
    (an empty slot holds the variance 1e10)."""
    import torch

    errs, same = {}, True
    valid = getattr(want["state"], "mask", None)
    for name, g, w in (("scores", got["scores"], want["scores"]),
                       *zip(want["state"]._fields, got["state"],
                            want["state"])):
        if w.dtype in (torch.bool, torch.int32):
            same &= torch.equal(g, w)
            continue
        if valid is not None and name in ("mu", "var"):
            g, w = g[valid], w[valid]
        errs[name] = ((g - w).abs().max() / w.abs().max()).item() / \
            VARIANT_TOL[flag]
    return errs, same


def dota_fit_stats_unweighted_delta(mu, x, y):
    """A planted fault: `adapt/dota.fit_stats` with Δ summed without the
    soft labels."""
    import torch

    x, y = x.to(torch.float32), y.to(torch.float32)
    sum_w = y.sum(dim=-2)
    weighted_x = torch.matmul(y.transpose(-1, -2), x)
    xm = (x[..., :, None, :] - mu[..., None, :, :]).movedim(-3, -2)
    return sum_w, weighted_x, torch.matmul(xm.transpose(-1, -2), xm)


def gmm_fit_new_mu(fit):
    """A planted fault: `adapt/gmm.fit` with the covariance taken about the
    NEW means."""
    import torch

    from uni_adapter_torch.adapt import gmm

    def bad(state, x, y):
        new = fit(state, x, y)
        x, y = x.to(torch.float32), y.to(torch.float32)
        log_l = gmm._log_gauss_diag(x, state.mu, state.sigma)
        r = torch.softmax(torch.log(torch.clamp(state.pi, min=1e-10))
                          [..., None, :, :] + log_l, dim=-1)
        gamma = y[..., None] * r
        diff = x[..., :, None, None, :] - new.mu[..., None, :, :, :]
        wdsq = (gamma[..., None] * (diff * diff)).sum(dim=-4)
        denom = torch.clamp(new.C[..., None], min=1e-10)
        return new._replace(sigma=torch.clamp(
            (state.C[..., None] * state.sigma + wdsq) / denom, min=1e-8))
    return bad


def time_dota_update(torch, K: int, S=None) -> float:
    """Device ms of one `dota.update` (the Λ inverse) at K classes, D 1024,
    one stream or S, after a fit (median of 10, CUDA events)."""
    from uni_adapter_torch.adapt import dota

    D = 1024
    st = dota.init(1e-4, 1e-4, D, K, torch.full((D, K), 1e-3, device="cuda"))
    if S:
        st = dota.DOTAState(*(t.expand(S, *t.shape).contiguous() if t.dim()
                              else t for t in st))
    gen = torch.Generator(device="cuda").manual_seed(1)
    lead = (S,) if S else ()
    x = torch.nn.functional.normalize(
        torch.randn(*lead, 1, D, generator=gen, device="cuda"), dim=-1)
    y = torch.softmax(torch.randn(*lead, 1, K, generator=gen,
                                  device="cuda") * 3, -1)
    st = dota.fit(st, x, y)
    return time_ms(lambda: dota.update(st, 1e-4), runs=10, per_run=1)


def check_variants_card_vs_cpu(torch) -> dict:
    """Plain, GMM and adaptive DOTA's functions on the card against the same
    functions on the CPU (VARIANT_CASES, VARIANT_TOL): every step's
    scores and the final state within tolerance, masks and counts
    identical, the adaptive split fired.  Planted faults on the card side
    must each fail it: DOTA's products in TF32 (at K 40; reported at K
    1156) and its Δ without the soft labels, GMM's covariance about the
    new means, adaptive DOTA's split check skipped.  Also times DOTA's
    update.  Returns the update's ms."""
    from uni_adapter_torch.adapt import adaptive, dota, gmm

    def tf32(run):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return run()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    def patched(module, name, make):
        """Run with module.name replaced by make(the original)."""
        def wrap(run):
            saved = getattr(module, name)
            setattr(module, name, make(saved))
            try:
                return run()
            finally:
                setattr(module, name, saved)
        return wrap

    faults = {"use_dota": {"TF32 products": tf32,
                           "Δ without the soft labels": patched(
                               dota, "fit_stats",
                               lambda _: dota_fit_stats_unweighted_delta)},
              "use_gmm_dota": {"covariance about the new means": patched(
                  gmm, "fit", gmm_fit_new_mu)},
              "use_adaptive_dota": {"the split check skipped": patched(
                  adaptive, "check_and_split",
                  lambda _: lambda state, *args, **kwargs: state)}}
    for K, n_steps in VARIANT_CASES:
        text, feats = cache_sequence(K, n_steps, 12)
        for flag in VARIANT_DOTA:
            steps = DOTA_STEPS[K] if flag == "use_dota" else n_steps
            t0 = time.perf_counter()
            want = run_variant_sequence(torch, "cpu", flag, text,
                                        feats[:steps])
            cpu_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = run_variant_sequence(torch, "cuda", flag, text,
                                       feats[:steps])
            card_s = time.perf_counter() - t0
            ratios, same = variant_errors(flag, got, want)
            extra = ""
            if flag == "use_adaptive_dota":
                modes = int(adaptive.num_modes_per_class(got["state"]).sum())
                extra = f"; modes {modes} (K {K})"
                if modes <= K:
                    fail(f"{flag} at K {K}: no split fired")
            print(f"{flag} card vs cpu, K {K}, {steps} steps (card "
                  f"{card_s:.1f} s, cpu {cpu_s:.1f} s): masks and counts "
                  f"identical {same}; err/tolerance "
                  f"{ {n: round(r, 3) for n, r in ratios.items()} }{extra}")
            if not same or max(ratios.values()) > 1:
                fail(f"{flag} on the card disagrees with the CPU at K {K}")
            for what, plant in faults[flag].items():
                bad = plant(lambda: run_variant_sequence(
                    torch, "cuda", flag, text, feats[:steps]))
                r, same = variant_errors(flag, bad, want)
                # at K 1156 (3 steps) Σ̄ is better conditioned, and TF32's
                # rounding moves Λ by about its tolerance: reported there
                required = not (what == "TF32 products" and K > 1000)
                print(f"{flag} planted fault at K {K}, {what}: identical "
                      f"{same}, largest err/tolerance {max(r.values()):.3g}"
                      + ("" if required else " (reported, not required)"))
                if required and same and max(r.values()) <= 1:
                    fail(f"the {flag} check at K {K} passes with a planted "
                         f"fault: {what}")
    ms = {"K40": time_dota_update(torch, 40),
          "K40_S15": time_dota_update(torch, 40, 15),
          "K1156": time_dota_update(torch, 1156)}
    print(f"dota update (the Λ inverse, cuSOLVER Cholesky, D 1024), ms: "
          f"{ {k: round(v, 4) for k, v in ms.items()} }")
    return ms


def diverse_stream(torch, gen, T: int, N: int = 1024):
    """T batch-1 clouds on spheres, each scaled by exp(U(−1.4, 0.7)) and
    each axis by exp(U(−0.7, 0.7)): features and predictions that differ
    from cloud to cloud.  (pcs, rgbs, targets) (T, 1, ...)."""
    pcs = sphere_cloud(torch, gen, T, N) * torch.exp(
        torch.empty(T, 1, 1, device="cuda").uniform_(-1.4, 0.7,
                                                     generator=gen)) \
        * torch.exp(torch.empty(T, 1, 3, device="cuda").uniform_(
            -0.7, 0.7, generator=gen))
    pcs = pcs.reshape(T, 1, N, 3)
    return (pcs, torch.ones_like(pcs),
            torch.randint(0, 40, (T, 1), generator=gen, device="cuda"))


def check_variant_scans(torch) -> dict:
    """Each variant on Uni3D-L (bf16, full width and depth, batch 1), the
    captured step against the eager loop (`scan_against_eager`, traced):
    plain DOTA and GMM-DOTA over 16 clouds, adaptive DOTA over 60, so that
    the split check at fit 50 runs inside the captured graph.  At σ 5e-4
    (split threshold 5e-3, the JAX package's split test's) it is printed
    whether a split fired and the largest variance of a mode with the
    count to split; at σ 1e-6 (threshold 1e-5) a split must fire: more
    modes than classes, the valid slots a contiguous prefix, and the
    captured run's mask equal to the eager run's, its μ within 1e-5.
    (Random weights map the clouds near one feature, so a mode's variance
    decays about as 1/count.)  Returns ms a step, eager and captured."""
    from uni_adapter_torch.adapt import adaptive
    from uni_adapter_torch.anchors import load_precomputed
    from uni_adapter_torch.config import Config, DotaConfig, ModelConfig
    from uni_adapter_torch.models.loader import build_backbone

    gen = torch.Generator(device="cuda").manual_seed(13)
    text = load_precomputed("large", "modelnet").cuda()
    model, _, _ = build_backbone("uni3d", ModelConfig(), "cuda", seed=0)
    ms = {}
    for flag, T, sigma in (("use_dota", 16, 1e-4), ("use_gmm_dota", 16, 1e-4),
                           ("use_adaptive_dota", 60, 5e-4),
                           ("use_adaptive_dota", 60, 1e-6)):
        cfg = Config(model=ModelConfig(), dota=DotaConfig(
            use_mode_dota=False, sigma=sigma, **{flag: True}))
        pcs, rgbs, tgts = diverse_stream(torch, gen, T)
        e, s, times = scan_against_eager(
            torch, f"uni3d {flag} ({T} steps, sigma {sigma})", cfg, model,
            text, pcs, rgbs, tgts, 1e-2, trace=True)
        ms[f"{flag}_sigma{sigma:g}"] = {"eager_ms": times[0],
                                        "captured_ms": times[1]}
        diffs = {n: (a.float() - b.float()).abs().max().item() for n, a, b in
                 zip(e.method_state._fields, e.method_state, s.method_state)}
        print(f"scan {flag}: final state captured vs eager, max abs diff "
              f"{ {n: f'{d:.3g}' for n, d in diffs.items()} }")
        if flag != "use_adaptive_dota":
            continue
        es, ss = e.method_state, s.method_state
        counts = adaptive.num_modes_per_class(ss)
        wide = torch.where(ss.mask & (ss.c >= 5.0), ss.var.amax(-1), 0.0)
        print(f"scan {flag} at sigma {sigma:g}: the largest variance of a "
              f"mode with count >= 5 {wide.max().item():.3g} (split "
              f"threshold {10 * sigma:.3g}), largest count "
              f"{ss.c.max().item():.3g}")
        if sigma > 1e-5:
            continue
        prefix = all(bool(ss.mask[k, :n].all() and not ss.mask[k, n:].any())
                     for k, n in enumerate(counts.tolist()))
        print(f"scan {flag}: {int(counts.sum())} modes over {len(counts)} "
              f"classes after {T} steps (split check at fit 50), valid "
              f"slots a contiguous prefix {prefix}, masks equal "
              f"{torch.equal(es.mask, ss.mask)}, fit calls "
              f"{int(ss.fit_calls)}; mode stats "
              f"{adaptive.get_mode_stats(ss)}")
        if not (int(counts.sum()) > len(counts) and prefix
                and torch.equal(es.mask, ss.mask) and diffs["mu"] <= 1e-5):
            fail("the adaptive split inside the captured step: no split, "
                 "slots not a prefix, or captured differs from eager")
    return ms


def run_short_last_batch(tmp: Path) -> dict:
    """`cli.tta.main --use-scan false --batch-size 3` (Uni3D-L, MODE-DOTA)
    over the 16-cloud stream: 6 steps (5 of 3 clouds, 1 of 1), all 16
    clouds adapted on and counted, finite logits.  Returns its launches."""
    from uni_adapter_torch.cli import tta

    counters = zeroed_counters()
    summary = tta.main(
        ["--root", str(tmp / "stream_1024x40"), "--corruption", "uniform",
         "--precomputed-text-features", "large", "--use-scan", "false",
         "--batch-size", "3", "--device", "cuda", "--output-dir",
         str(tmp / "out"), "--name", "smoke-batch3"])
    launches = {n: c.launches for n, c in counters.items()}
    steps, n = summary["steps"]["uniform"], summary["n"]["uniform"]
    step_ms = summary["step_ms"]["uniform"]
    print(f"--use-scan false --batch-size 3 over 16 clouds: steps {steps}, "
          f"{n} clouds counted, ms a step {[round(t, 2) for t in step_ms]}, "
          f"finite {summary['finite']['uniform']}; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    if steps != [0, 6] or n != 16 or len(step_ms) != 6 \
            or not summary["finite"]["uniform"]:
        fail("the eager loop at batch 3 did not take the short last batch")
    return launches


def run_profile_dir(tmp: Path) -> dict:
    """`cli.tta.main --profile-dir` (plain DOTA on Uni3D-L, captured), not
    under `traced_run` (two profiler sessions cannot nest): one Chrome
    trace written, holding the path's kernels (the warm-up steps' and the
    replays') and no other port kernel.  Returns the launches in it."""
    from uni_adapter_torch.cli import tta

    prof = tmp / "profile"
    tta.main(["--root", str(tmp / "stream_1024x40"), "--corruption",
              "uniform", "--precomputed-text-features", "large",
              *VARIANT_FLAGS["uni3d_dota"], "--profile-dir", str(prof),
              "--device", "cuda", "--output-dir", str(tmp / "out"),
              "--name", "smoke-profile"])
    traces = sorted(prof.glob("trace_*.json"))
    if len(traces) != 1:
        fail(f"--profile-dir wrote {len(traces)} traces")
    events = json.loads(traces[0].read_text()).get("traceEvents", [])
    counts = kernel_counts(e.get("name", "") for e in events
                           if e.get("cat") == "kernel")
    print(f"--profile-dir: {traces[0].name}, "
          f"{traces[0].stat().st_size / 2**20:.1f} MiB, {len(events)} "
          f"events; port kernels in it "
          f"{ {k: v for k, v in counts.items() if v} }")
    per_step = PATHS["uni3d_dota"][3]
    owned = {k for c in per_step for k in COUNTER_KERNELS[c]}
    if not all(counts[k] for k in owned) or any(
            n for k, n in counts.items() if k not in owned):
        fail("the --profile-dir trace lacks a kernel of the path or holds "
             "another's")
    return by_counter(counts, per_step)


def check_openshape_rest(torch, gen) -> dict:
    """OpenShape PPTA-G at full width and depth 2 with `rel_pe` and the
    `local` / `hierarchical` cache types, card (kernels; the biased
    attention in plain PyTorch) against the CPU on the same weights and
    input: fp32 within 1 − cosine F32_FEATURE_1MCOS for every output row
    (CLS features and the k-means centres), bf16 (`global` with `rel_pe`)
    within cosine 0.99.  FPS and the ball query run their kernels; with
    `rel_pe` no attention kernel runs, without it the natural layout's.
    Returns the launches."""
    import dataclasses

    from uni_adapter_torch.config import ModelConfig
    from uni_adapter_torch.models import ppta

    g2 = dataclasses.replace(ppta.PRESETS[4], depth=2)
    pc = cloud(torch, gen)
    total = collections.Counter()
    for dtype, cache_type, rel_pe in (
            ("float32", "global", True), ("float32", "local", False),
            ("float32", "hierarchical", True), ("bfloat16", "global", True)):
        mc = ModelConfig(compute_dtype=dtype)
        kw = dict(cache_type=cache_type, rel_pe=rel_pe)
        gpu = ppta.create_openshape(mc, "cuda", seed=0, preset=g2, **kw)
        cpu = ppta.create_openshape(mc, "cpu", seed=0, preset=g2, state_dict={
            k: v.float().cpu() for k, v in gpu.state_dict().items()}, **kw)
        counters = zeroed_counters()
        with torch.no_grad():
            outs_gpu = gpu(pc[..., :3], pc)
            launches = {n: c.launches for n, c in counters.items()}
            outs_cpu = cpu(pc[..., :3].cpu(), pc.cpu())
        total.update(launches)
        if cache_type != "hierarchical":
            outs_gpu, outs_cpu = (outs_gpu,), (outs_cpu,)
        cos = torch.cat([torch.nn.functional.cosine_similarity(
            g.cpu(), c, dim=-1) for g, c in zip(outs_gpu, outs_cpu)])
        worst = (1 - cos).max().item()
        bound = F32_FEATURE_1MCOS if dtype == "float32" else 0.01
        attn = [n for n in BF16_ATTENTION + FP32_ATTENTION if launches[n]]
        print(f"openshape {cache_type} rel_pe {rel_pe} ({dtype}, depth 2, "
              f"full width): outputs {[tuple(o.shape) for o in outs_gpu]}, "
              f"1 - cosine card vs cpu {worst:.3g} (bound {bound}); "
              f"launches { {k: v for k, v in launches.items() if v} }")
        if not (all(torch.isfinite(o).all() for o in outs_gpu)
                and worst <= bound):
            fail(f"openshape {cache_type} rel_pe {rel_pe} ({dtype}) on the "
                 f"card disagrees with the CPU")
        want_attn = [] if rel_pe else ["eva_attention_fp32"]
        if not (launches["fps"] and launches["ballquery"]) or \
                attn != want_attn:
            fail(f"openshape {cache_type} rel_pe {rel_pe}: launches "
                 f"{launches}")
    return dict(total)


def check_pointnet(torch, gen) -> dict:
    """`ops/pointnet.py` on the card against the CPU, fp32, seeded weights
    (BatchNorm statistics too): `PointNetSetAbstractionMsg` (512 centres,
    radii 0.1 / 0.2 / 0.4, 16 / 32 / 128 samples) on 2 clouds of 1024
    points (FPS on fps.cu) and of 10,000 (fps_grid.cu), the ball query
    on its kernel: centres equal, features within 1e-4 of their largest;
    then `PointNetFeaturePropagation` back to the 1024 points (no
    kernel).  Returns the launches."""
    import copy

    from uni_adapter_torch.models.common import BatchNormInference, Dense
    from uni_adapter_torch.ops import pointnet

    g = torch.Generator().manual_seed(0)

    def seeded(m):
        for mod in m.modules():
            if isinstance(mod, Dense):
                mod.reset_parameters(g)
                mod.bias.data.uniform_(-0.1, 0.1, generator=g)
            elif isinstance(mod, BatchNormInference):
                mod.mean.data.normal_(0, 0.1, generator=g)
                mod.var.data.uniform_(0.5, 1.5, generator=g)
                mod.scale.data.uniform_(0.5, 1.5, generator=g)
                mod.bias.data.normal_(0, 0.1, generator=g)
        return m.requires_grad_(False)

    msg = seeded(pointnet.PointNetSetAbstractionMsg(
        512, [0.1, 0.2, 0.4], [16, 32, 128], 3,
        [[32, 32, 64], [64, 64, 128], [64, 96, 128]]))
    fp = seeded(pointnet.PointNetFeaturePropagation(3 + 320, [256, 128]))
    msg_gpu, fp_gpu = copy.deepcopy(msg).cuda(), copy.deepcopy(fp).cuda()
    total = collections.Counter()
    for N, fps_kernel in ((1024, "fps"), (10000, "fps_grid")):
        pc = cloud(torch, gen, 2, N)
        xyz, rgb = pc[..., :3].contiguous(), pc[..., 3:].contiguous()
        counters = zeroed_counters()
        with torch.no_grad():
            c_gpu, f_gpu = msg_gpu(xyz, rgb)
            launches = {n: c.launches for n, c in counters.items()}
            c_cpu, f_cpu = msg(xyz.cpu(), rgb.cpu())
        total.update(launches)
        err = ((f_gpu.cpu() - f_cpu).abs().max() / f_cpu.abs().max()).item()
        same = torch.equal(c_gpu.cpu(), c_cpu)
        print(f"pointnet MSG on (2, {N}) clouds: centres equal {same}, "
              f"features {tuple(f_gpu.shape)} max abs err / largest "
              f"{err:.3g} (tolerance 1e-4); launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        if not same or err > 1e-4 or not launches[fps_kernel] \
                or launches["ballquery"] != 3:
            fail(f"pointnet MSG on {N} points: the card disagrees with the "
                 f"CPU or took another route")
        if N == 1024:
            with torch.no_grad():
                u_gpu = fp_gpu(xyz, c_gpu, rgb, f_gpu)
                u_cpu = fp(xyz.cpu(), c_cpu, rgb.cpu(), f_cpu)
            err = ((u_gpu.cpu() - u_cpu).abs().max()
                   / u_cpu.abs().max()).item()
            print(f"pointnet FP to (2, 1024): {tuple(u_gpu.shape)}, max abs "
                  f"err / largest {err:.3g} (tolerance 1e-4)")
            if err > 1e-4:
                fail("pointnet FP: the card disagrees with the CPU")
    return dict(total)


def check_float16_cli(tmp: Path) -> None:
    """`cli.tta.main --compute-dtype float16` on the card (Uni3D at depth 1)
    raises a ValueError naming the dtype: no kernel takes it."""
    from uni_adapter_torch.cli import tta

    root = tmp / "stream_1024x40"
    try:
        tta.main(["--root", str(root), "--corruption", "uniform",
                  "--precomputed-text-features", "large", "--eva-depth", "1",
                  "--compute-dtype", "float16", "--device", "cuda",
                  "--output-dir", str(tmp / "out"), "--name", "smoke-fp16"])
    except ValueError as e:
        if "float16" not in str(e):
            fail(f"--compute-dtype float16 raised without naming it: {e}")
        print(f"--compute-dtype float16 on the card raises: {e}")
        return
    fail("--compute-dtype float16 ran on the card")


#: The text tower on the card against the CPU: 1 − cosine of each row
#: (fp32: both sides in fp32, TF32 off, so summation order alone; bf16:
#: the features check's cosine 0.99), and the fp32 projection's error
#: relative to its largest output with TF32 allowed in the process (its
#: product must stay fp32: a TF32 product, the planted fault, moves it by
#: ~1e-3, at least TEXT_PROJ_FAULT_MARGIN times the gate).
TEXT_1MCOS = {"float32": 1e-5, "bfloat16": 1e-2}
TEXT_PROJ_RTOL, TEXT_PROJ_FAULT_MARGIN = 1e-5, 5
#: The banks timed on the card: text preset → the point backbone's width.
TEXT_BANKS = {"uni3d": 1024, "ulip": 512}


def text_prompts(n: int) -> list:
    """n ModelNet40 prompts (class × template), the first past 77 tokens."""
    from uni_adapter_torch.config import Config, load_labels, load_templates

    cfg = Config().resolve()
    names, templates = load_labels(cfg), load_templates(cfg)
    prompts = [t.format(c.replace("_", " ")) for c in names
               for t in templates]
    return [" ".join(["chair"] * 100)] + prompts[:n - 1]


def check_text_tower(torch) -> dict:
    """The CLIP text tower (`models/clip_text.py`, plain PyTorch on the
    card: masked attention never reaches a kernel, as in the JAX package).
    The `uni3d` preset at full width (1280, 20 heads, embed 1024) and depth
    2, card against CPU on 16 prompts in fp32 and bf16 (`TEXT_1MCOS`);
    its projection with TF32 allowed, against the CPU, with a TF32 product
    as a planted fault (`TEXT_PROJ_RTOL`); then the full `uni3d` (32
    layers) and `ulip` (12) presets, drawn on the card, each building
    ModelNet40's bank (40 classes × 64 templates, 2560 prompts, 256 a
    forward) in bf16 and fp32: finite unit rows, the bank's seconds and a
    256-prompt batch's ms (median of 5, CUDA events), its device ms and
    its GEMMs' (torch.profiler) beside its bound (the blocks' and the
    projection's products at the dtype's peak).  Returns those numbers by
    preset and dtype."""
    from uni_adapter_torch.anchors import clip_classifier
    from uni_adapter_torch.config import Config, load_labels, load_templates
    from uni_adapter_torch.adapt.residual import tier_product
    from uni_adapter_torch.models.clip_text import create_text_encoder
    from uni_adapter_torch.utils.tokenizer import tokenize

    ids = torch.from_numpy(tokenize(text_prompts(16)))
    if (ids[0] == 49407).any():
        fail("the long prompt kept its end-of-text token")
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        gpu = create_text_encoder("uni3d", "cuda", dt, seed=0, layers=2)
        cpu = create_text_encoder("uni3d", "cpu", dt, layers=2, state_dict={
            k: v.cpu() for k, v in gpu.state_dict().items()})
        with torch.no_grad():
            got, want = gpu(ids.cuda()).cpu(), cpu(ids)
        one_m_cos = (1 - torch.nn.functional.cosine_similarity(
            got, want, dim=-1)).max().item()
        print(f"text tower uni3d depth 2 {dtype}: {tuple(got.shape)}, "
              f"1 - cosine card vs cpu {one_m_cos:.3g} (gate "
              f"{TEXT_1MCOS[dtype]}), max abs diff "
              f"{(got - want).abs().max().item():.4g}")
        if not torch.isfinite(got).all() or one_m_cos > TEXT_1MCOS[dtype]:
            fail(f"the text tower ({dtype}) on the card disagrees with the "
                 f"CPU's")
    gen = torch.Generator(device="cuda").manual_seed(1)
    pooled = torch.randn(256, 1280, generator=gen, device="cuda")
    proj = torch.randn(1280, 1024, generator=gen, device="cuda") * 0.02
    want = pooled.cpu() @ proj.cpu()
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = tier_product(pooled, proj.T, "highest").cpu()   # the tower's
        tf32 = torch.matmul(pooled, proj).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    scale = want.abs().max().item()
    err = (got - want).abs().max().item() / scale
    fault = (tf32 - want).abs().max().item() / scale
    print(f"text projection fp32 with TF32 allowed: rel err {err:.3g} (gate "
          f"{TEXT_PROJ_RTOL}); a TF32 product {fault:.3g}")
    if err > TEXT_PROJ_RTOL or fault < TEXT_PROJ_FAULT_MARGIN * TEXT_PROJ_RTOL:
        fail("the text projection is not an fp32 product on the card, or "
             "its gate does not catch a TF32 one")

    cfg = Config().resolve()
    names, templates = load_labels(cfg), load_templates(cfg)
    batch = torch.from_numpy(tokenize(text_prompts(256))).cuda()
    numbers = {}
    for preset, width in TEXT_BANKS.items():
        for dtype in ("bfloat16", "float32"):
            tower = create_text_encoder(preset, "cuda", getattr(torch, dtype),
                                        seed=0)
            with torch.no_grad():
                tower(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bank = clip_classifier(names, templates, tower, device="cuda")
            torch.cuda.synchronize()
            bank_s = time.perf_counter() - t0
            with torch.no_grad():
                batch_ms = time_ms(lambda: tower(batch), runs=5, per_run=1,
                                   warmup=1)
                kern = trace_kernels(lambda: tower(batch), calls=2,
                                     warmup=1)
            busy = sum(k.device_time_total for k in kern) / 2e3
            by_name = collections.Counter()
            for k in kern:
                by_name[k.name[:48]] += k.device_time_total / 2e3
            gemm = sum(t for name, t in by_name.items()
                       if re.search(r"gemm|xmma|cutlass|nvjet", name))
            n_ops = 2 * 256 * 77 * sum(
                p.numel() for n, p in tower.named_parameters()
                if n.startswith("resblocks") or n == "text_projection")
            bound_ms = n_ops / (PEAK_BF16 if dtype == "bfloat16"
                                else PEAK_FP32) * 1e3
            norm_err = (bank.norm(dim=1) - 1).abs().max().item()
            print(f"text bank {preset} {dtype}: {tuple(bank.shape)} "
                  f"(2560 prompts) in {bank_s:.3f} s, one 256-prompt batch "
                  f"{batch_ms:.2f} ms (device {busy:.2f}, of which GEMMs "
                  f"{gemm:.2f}; bound {bound_ms:.2f} by operations); rows "
                  f"unit within {norm_err:.2g}; top kernels (ms a batch) "
                  f"{[(n, round(t, 2)) for n, t in by_name.most_common(6)]}")
            if bank.shape != (40, width) or not torch.isfinite(bank).all() \
                    or norm_err > 1e-5:
                fail(f"the {preset} {dtype} bank is {tuple(bank.shape)}, not "
                     f"finite or not of unit rows")
            numbers[f"{preset}_{dtype}"] = {
                "bank_s": bank_s, "batch256_ms": batch_ms,
                "batch256_device_ms": busy, "batch256_gemm_ms": gemm,
                "batch256_bound_ms": bound_ms}
            del tower
    torch.cuda.empty_cache()
    return numbers


def full_size_models(torch) -> dict:
    """name → (layout, build(seed), inputs(model)) at published widths and
    depths, in bf16: Uni3D-L, ULIP-2's Point-BERT, OpenShape PPTA-G and the
    `uni3d` text preset."""
    from uni_adapter_torch.config import ModelConfig
    from uni_adapter_torch.models.clip_text import create_text_encoder
    from uni_adapter_torch.models.loader import BACKBONES
    from uni_adapter_torch.utils.tokenizer import tokenize

    pc = cloud(torch, torch.Generator(device="cuda").manual_seed(7))
    ids = torch.from_numpy(tokenize(text_prompts(16))).cuda()

    def backbone(kind):
        return lambda seed: BACKBONES[kind](ModelConfig(vlm3d=kind), "cuda",
                                            seed=seed)

    return {
        **{kind: (kind, backbone(kind), FORWARD_INPUTS[kind](pc))
           for kind in ("uni3d", "ulip", "openshape")},
        "clip_text_uni3d": ("clip_text", lambda seed: create_text_encoder(
            "uni3d", "cuda", torch.bfloat16, seed=seed), (ids,)),
    }


def check_loader(torch) -> dict:
    """`models/loader.py` at full size on the card: each model of
    `full_size_models` from seed 1 written as a reference-layout checkpoint
    (`scripts/reference_layouts.py`: timm's fused EVA02 blocks with rope
    buffers for Uni3D, Point-BERT, PPTA, open_clip's text tower; the
    `module.` prefix), loaded into the same model from seed 2: the report
    CLEAN, every parameter equal to the source's bitwise, and one batch's
    features equal to the source model's bitwise (same kernels, same
    weights).  Returns the seconds each load took."""
    import io

    from scripts import reference_layouts
    from uni_adapter_torch.models.loader import load_checkpoint

    seconds = {}
    for name, (layout, build_model, inputs) in full_size_models(torch).items():
        src = build_model(1)
        buf = io.BytesIO()
        reference_layouts.save(reference_layouts.LAYOUTS[layout](src), buf)
        size = buf.tell()
        dst = build_model(2)
        buf.seek(0)
        t0 = time.perf_counter()
        report = load_checkpoint(dst, buf)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        clean = not (report["missing"] or report["unexpected"]
                     or report["shape_mismatches"])
        differ = [k for (k, a), (_, b) in zip(src.state_dict().items(),
                                              dst.state_dict().items())
                  if not torch.equal(a, b)]
        with torch.no_grad():
            same = torch.equal(src(*inputs), dst(*inputs))
        print(f"loader {name}: {size / 2**20:.0f} MiB checkpoint, "
              f"{report['n_model_leaves']} leaves, "
              f"{'CLEAN' if clean else 'DIFFS FOUND'}, loaded in "
              f"{seconds[name]:.2f} s; parameters differing from the "
              f"source {len(differ)}; features bitwise equal {same}")
        if not clean or differ or not same:
            fail(f"the {name} checkpoint did not load exactly: report "
                 f"{ {k: report[k] for k in ('missing', 'unexpected', 'shape_mismatches')} }, "
                 f"differing {differ[:5]}")
        del src, dst, buf
        torch.cuda.empty_cache()
    return seconds


def run_loaded_path(tmp: Path) -> tuple:
    """Uni3D-L from a reference-layout checkpoint through `cli.tta.main
    --checkpoint-path` with no bank: the anchors (40, 1024) from the
    `uni3d` text tower on the card, no random-weights warning, 16 clouds
    on the default captured path with FPS, kNN and the block launched as
    on the `uni3d` path (traced).  Then `extract_attention --checkpoint` on
    the same file, and `build_anchors` (the `ulip` preset from a seed and
    `--clip-checkpoint` of another seed's tower) against the bank that
    `clip_classifier` builds in-process from the checkpoint's tower:
    max |Δ| 0.  Returns the launches of the two CLI runs by path."""
    import numpy as np
    import torch

    from scripts import reference_layouts
    from uni_adapter_torch.anchors import clip_classifier
    from uni_adapter_torch.cli import build_anchors, tta
    from uni_adapter_torch.config import (Config, ModelConfig, load_labels,
                                          load_templates)
    from uni_adapter_torch.models.clip_text import create_text_encoder
    from uni_adapter_torch.models.uni3d import create_uni3d

    ckpt = tmp / "uni3d_L.pt"
    reference_layouts.save(reference_layouts.uni3d(
        create_uni3d(ModelConfig(), "cuda", seed=3)), ckpt)
    anchors = []
    fallback = tta.get_text_anchors_with_fallback

    def recorded(cfg, device):
        anchors.append(fallback(cfg, device))
        return anchors[-1]

    tta.get_text_anchors_with_fallback = recorded
    try:
        flags, _, _, per_step, idle = PATHS["uni3d"]
        summary, launches, wrapper = traced_run(
            torch, "the loaded uni3d path", lambda: tta.main(
                ["--root", str(tmp / "stream_1024x40"), "--corruption",
                 "uniform", "--checkpoint-path", str(ckpt), "--device",
                 "cuda", "--output-dir", str(tmp / "out"), "--name",
                 "smoke-loaded"]), per_step)
    finally:
        tta.get_text_anchors_with_fallback = fallback
    log = (Path(summary["log_dir"]) / "out.log").read_text()
    step_ms = summary["step_ms"]["uniform"]
    print(f"loaded path uni3d (--checkpoint-path, anchors from the text "
          f"tower): anchors {tuple(anchors[0].shape)}, {len(step_ms)} steps, "
          f"median {statistics.median(step_ms[1:]):.2f} ms/step; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    if "random weights" in log or tuple(anchors[0].shape) != (40, 1024) \
            or len(step_ms) != 16 or not summary["finite"]["uniform"]:
        fail("the loaded uni3d path warned of random weights, or its "
             "anchors, steps or logits are off")
    check_launches("the loaded uni3d path", launches,
                   {n: k * 16 for n, k in per_step.items()}, idle)
    by_path = {"loaded_uni3d": launches}
    by_path["extract_uni3d_loaded"] = run_extraction(
        tmp, "uni3d", ["--checkpoint", str(ckpt)], "_loaded")

    src = create_text_encoder("ulip", "cuda", torch.float32, seed=4)
    clip = tmp / "clip_ulip.pt"
    reference_layouts.save(reference_layouts.clip_text(src), clip)
    cfg = Config().resolve()
    bank = clip_classifier(load_labels(cfg), load_templates(cfg), src,
                           device="cuda").cpu().numpy()
    np.save(tmp / "bank_inprocess.npy", bank)
    counters = zeroed_counters()
    built = build_anchors.main(
        ["--text-preset", "ulip", "--clip-checkpoint", str(clip),
         "--labels-key", "modelnet40_openshape", "--seed", "5", "--out",
         str(tmp / "bank_cli.npy"), "--compare-to",
         str(tmp / "bank_inprocess.npy"), "--device", "cuda"])
    diff = float(np.abs(built - bank).max())
    print(f"build_anchors ulip on the card: {built.shape}, max |Δ| against "
          f"clip_classifier in-process {diff}; kernel launches "
          f"{sum(c.launches for c in counters.values())}")
    if built.shape != (40, 512) or diff != 0:
        fail("build_anchors on the card differs from clip_classifier")
    return by_path



# ---- serving: TTAServer, the HTTP front end, the int8 trunk --------------

#: The serving check's schedules, the clients of each tick.  Ragged: over
#: 5 ticks client i submits from tick i on, but for client 1 at tick 3, so
#: that chunks stack clients at step 0 with older ones.  With residual
#: learning: client 0 alone, then all four (the Adam loop for client 0
#: only), then clients 1-3 (their first loop), so that every client takes
#: one Adam loop, as the streams check holds them.
SERVE_TICKS = 5
SERVE_RAGGED = [[i for i in range(4) if t >= i and (i, t) != (1, 3)]
                for t in range(SERVE_TICKS)]
SERVE_RESIDUALS = [[0], [0, 1, 2, 3], [1, 2, 3]]


def check_serving_equals_sequential(torch) -> None:
    """`serve.TTAServer` on the card against each client's own
    `engine.run_stream` (seed 42 + i, the clouds it submitted): Uni3D at
    width 1024 and depth 2, fp32, 4 clients on the ladder (1, 2, 4) over
    ragged ticks whose chunks stack clients at step 0 with older ones
    (SERVE_RAGGED).  MODE-DOTA without residual learning and the cache on
    SERVE_RAGGED, MODE-DOTA with it on SERVE_RESIDUALS (the Adam loop runs
    for a chunk where only one gate is open): final logits within atol
    1e-3 every tick, step
    counts equal; with residual learning the residuals in the streams
    check's distribution (median < 1e-6, 90th percentile < 2e-4).  Then a
    blocking and a non-blocking snapshot taken mid-run and restored into
    a fresh server: the next tick's logits bitwise equal to the live
    server's."""
    from uni_adapter_torch import engine
    from uni_adapter_torch.anchors import load_precomputed
    from uni_adapter_torch.config import (CacheConfig, Config, DotaConfig,
                                          ModelConfig)
    from uni_adapter_torch.models.loader import build_backbone
    from uni_adapter_torch.serve import TTAServer

    C = 4
    mc = ModelConfig(eva_depth=2, compute_dtype="float32")
    model, _, _ = build_backbone("uni3d", mc, "cuda", seed=0)
    text = load_precomputed("large", "modelnet").cuda()
    gen = torch.Generator(device="cuda").manual_seed(7)
    scale = torch.exp(torch.empty(C * SERVE_TICKS, 1, 1, device="cuda")
                      .uniform_(-1.4, 0.7, generator=gen))
    clouds = (scale * sphere_cloud(torch, gen, C * SERVE_TICKS, 1024)
              ).reshape(C, SERVE_TICKS, 1, 1024, 3).cpu().numpy()
    cases = (("MODE-DOTA, residuals off", DotaConfig(res_learning=False),
              SERVE_RAGGED),
             ("MODE-DOTA, residuals on", DotaConfig(), SERVE_RESIDUALS),
             ("cache", DotaConfig(use_mode_dota=False), SERVE_RAGGED))
    for what, dota, schedule in cases:
        cfg = Config(model=mc, dota=dota, cache=CacheConfig(shot_capacity=2))
        server = TTAServer(cfg, model, text, sizes=(1, 2, 4), seed=42)
        for i in range(C):
            server.register(f"c{i}")
        got = [[] for _ in range(C)]
        seen = [[] for _ in range(C)]
        chunks = []
        run_chunk = server._run_chunk
        server._run_chunk = lambda reqs, size: (
            chunks.append((len(reqs), size)), run_chunk(reqs, size))[1]
        for t, clients in enumerate(schedule):
            out = server.submit([(f"c{i}", clouds[i, t], None)
                                 for i in clients])
            for i in clients:
                got[i].append(out[f"c{i}"])
                seen[i].append(clouds[i, t])
        err, residuals = 0.0, []
        for i in range(C):
            seq = []
            one = engine.run_stream(
                cfg, model, text, [(pc, torch.ones(pc.shape), torch.zeros(
                    1, dtype=torch.int64)) for pc in map(torch.from_numpy,
                                                        seen[i])],
                seed=42 + i, step_fn=fed_outputs(
                    engine.make_step_fn(cfg, model), seq))
            err = max(err, max(abs(g - w.final_logits.cpu().numpy()).max()
                               for g, w in zip(got[i], seq, strict=True)))
            if server.states[f"c{i}"].step != one["state"].step:
                fail(f"serving vs sequential ({what}): client {i} at step "
                     f"{server.states[f'c{i}'].step}, its stream at "
                     f"{one['state'].step}")
            if dota.use_mode_dota and dota.res_learning:
                residuals.append((server.states[f"c{i}"].res_state.residuals
                                  - one["state"].res_state.residuals)
                                 .abs().flatten())
        line = (f"serving vs sequential on the card ({what}), Uni3D width "
                f"1024 depth 2 fp32, {C} clients, ticks {schedule} on "
                f"the ladder (1, 2, 4), chunks (requests, size) {chunks}: "
                f"final logits max abs err {err:.3g} (atol 1e-3), step "
                f"counts equal")
        if residuals:
            d = torch.cat(residuals)
            med, p90 = d.median().item(), d.quantile(0.9).item()
            line += f"; residuals |d| median {med:.3g}, 90th pct {p90:.3g}"
            if not (med < 1e-6 and p90 < 2e-4):
                fail(f"serving vs sequential: residuals |d| median {med}, "
                     f"90th percentile {p90}")
        print(line)
        if err > 1e-3:
            fail(f"serving vs sequential ({what}): final logits differ by "
                 f"{err}")
    check_serving_snapshots(torch, model, text, clouds)


def check_serving_snapshots(torch, model, text, clouds) -> None:
    """MODE-DOTA with residuals: after two ticks of clients c0 and c1, c0
    snapshotted blocking and c1 on the background thread; the live
    server's third tick against a fresh server's (both clients restored,
    never registered there) on the same requests: bitwise equal."""
    from uni_adapter_torch.config import Config, DotaConfig, ModelConfig
    from uni_adapter_torch.serve import TTAServer

    cfg = Config(model=ModelConfig(eva_depth=2, compute_dtype="float32"),
                 dota=DotaConfig())
    live = TTAServer(cfg, model, text, sizes=(1, 2, 4), seed=42)
    for cid in ("c0", "c1"):
        live.register(cid)
    for t in range(2):
        live.submit([(f"c{i}", clouds[i, t], None) for i in range(2)])
    with tempfile.TemporaryDirectory() as tmp:
        live.snapshot("c0", f"{tmp}/c0")
        live.snapshot("c1", f"{tmp}/c1", blocking=False)
        reqs = [(f"c{i}", clouds[i, 2], None) for i in range(2)]
        want = live.submit(reqs)
        fresh = TTAServer(cfg, model, text, sizes=(1, 2, 4), seed=42)
        live.drain_snapshots()
        for cid in ("c0", "c1"):
            fresh.restore(cid, f"{tmp}/{cid}")
        got = fresh.submit(reqs)
    same = all((got[c] == want[c]).all() for c in want)
    print(f"serving snapshots on the card: blocking (c0) and non-blocking "
          f"(c1) after 2 ticks, restored into a fresh server: the next "
          f"tick's logits bitwise equal {same}")
    if not same:
        fail("a restored snapshot's next tick differs from the live server's")


def run_serving(tmp: Path, card: str) -> tuple:
    """The serving path at full width: `cli.serve.main` in-process
    (Uni3D-L, bf16, MODE-DOTA defaults with residual learning, the
    bundled ModelNet40 anchors, the ladder (1, 2, 4, 8), --warmup), then 6
    `client.TTAClient`s posting 1024-point clouds from threads for 8
    rounds, with the launch counters zeroed after the warm-up and read
    after the clients: every response (1, 40) and finite, /healthz's
    counts, each client's step count its submissions, a 404 and a 400
    while the clients run, and one tick traced on its own (4 requests,
    `traced_run`): FPS, kNN and the block, no other kernel.  Prints the
    warm-up s, the chunks and their ms by size, ms a tick (the server's
    `submit`), ms a request (the client's round trip) and ms a library
    tick of exactly 1, 2, 4, 6 and 8 requests, with the card."""
    import threading

    import numpy as np
    import torch

    from uni_adapter_torch.cli import serve as serve_cli
    from uni_adapter_torch.client import ServerError, TTAClient

    n_clients, rounds = 6, 8
    t0 = time.perf_counter()
    http_srv = serve_cli.main([
        "--port", "0", "--sizes", "1,2,4,8", "--warmup", "--gather-ms", "2",
        "--device", "cuda", "--precomputed-text-features", "large",
        "--output-dir", str(tmp / "serve"), "--snapshot-dir",
        str(tmp / "serve" / "snaps")])
    warmup_s = time.perf_counter() - t0
    server = http_srv.server
    chunks, tick_ms = [], []
    run_chunk, submit = server._run_chunk, server.submit

    def timed(fn, record):
        def run(*args):
            start = time.perf_counter()
            out = fn(*args)     # ends in the logits' copy to the host
            record((time.perf_counter() - start) * 1e3, *args)
            return out
        return run

    server._run_chunk = timed(run_chunk, lambda ms, reqs, size:
                              chunks.append((size, ms)))
    server.submit = timed(submit, lambda ms, reqs: tick_ms.append(ms))
    rng = np.random.default_rng(0)
    pcs = rng.standard_normal((n_clients, rounds, 1, 1024, 3)).astype(
        np.float32)
    pcs *= 0.5 / np.linalg.norm(pcs, axis=-1, keepdims=True)
    latency, bad, errors = [], [], []
    try:
        clients = [TTAClient("127.0.0.1", http_srv.port, f"robot-{i}",
                             timeout=300) for i in range(n_clients)]
        for c in clients:
            c.register()
        counters = zeroed_counters()

        def drive(i):
            try:
                for r in range(rounds):
                    start = time.perf_counter()
                    out = clients[i].submit(pcs[i, r])
                    latency.append((time.perf_counter() - start) * 1e3)
                    if out.shape != (1, 40) or not np.isfinite(out).all():
                        bad.append((i, r, out.shape))
            except Exception as e:     # reported below, fails the phase
                errors.append(repr(e))

        threads = [threading.Thread(target=drive, args=(i,))
                   for i in range(n_clients)]
        for th in threads:
            th.start()
        conn_codes = []
        for path, body in (("/nope", b""), ("/submit?client=robot-0",
                                             b"not an npz")):
            try:
                clients[0]._request("POST", path, body)
                conn_codes.append(200)
            except ServerError as e:
                conn_codes.append(e.status)
        for th in threads:
            th.join(timeout=600)
        torch.cuda.synchronize()
        launches = {n: c.launches for n, c in counters.items()}
        health = clients[0].healthz()
        steps = [server.states[f"robot-{i}"].step for i in range(n_clients)]
        server.submit, server._run_chunk = submit, run_chunk
        reqs = [(f"robot-{i}", pcs[i, 0], None) for i in range(4)]
        _, traced, _ = traced_run(torch, "a traced serving tick",
                                  lambda: server.submit(reqs),
                                  ("fps", "knn", "eva_attn_block"))
        # ticks of exactly n requests on the library server, 5 each
        sized_ms = {}
        for i in range(n_clients, 8):
            server.register(f"robot-{i}")
        for n in (1, 2, 4, 6, 8):
            reqs = [(f"robot-{i}", pcs[i % n_clients, 1], None)
                    for i in range(n)]
            ms = []
            for _ in range(5):
                start = time.perf_counter()
                server.submit(reqs)
                ms.append((time.perf_counter() - start) * 1e3)
            sized_ms[n] = statistics.median(ms)
    finally:
        http_srv.close()
    if any(th.is_alive() for th in threads) or errors or bad:
        fail(f"serving: clients failed {errors}, bad responses {bad}")
    lat = sorted(latency)
    p50, p95 = lat[len(lat) // 2], lat[int(0.95 * (len(lat) - 1))]
    by_size = collections.defaultdict(list)
    for size, ms in chunks:
        by_size[size].append(ms)
    chunk_ms = {size: statistics.median(v) for size, v in sorted(
        by_size.items())}
    print(f"serving Uni3D-L (bf16, MODE-DOTA with residuals, ladder "
          f"1,2,4,8) on {card}: warm-up {warmup_s:.1f} s (model, anchors, "
          f"one step a ladder size); {n_clients} clients x {rounds} rounds "
          f"in {len(tick_ms)} ticks, their chunks by size "
          f"{ {k: len(v) for k, v in sorted(by_size.items())} }, median ms a "
          f"chunk by size { {k: round(v, 2) for k, v in chunk_ms.items()} };"
          f" ms a tick median {statistics.median(tick_ms):.2f}, min "
          f"{min(tick_ms):.2f}, max {max(tick_ms):.2f}; ms a request "
          f"(client round trip) p50 {p50:.2f}, p95 {p95:.2f}; library ticks "
          f"of n requests, median of 5, ms "
          f"{ {k: round(v, 2) for k, v in sized_ms.items()} }")
    print(f"serving launches (counters over the clients' run): "
          f"{ {n: v for n, v in launches.items() if v} }; traced tick of 4 "
          f"requests: { {n: v for n, v in traced.items() if v} }; /healthz "
          f"{health}; step counts {steps}; mid-run codes {conn_codes}")
    if conn_codes != [404, 400]:
        fail(f"serving: the bad requests got {conn_codes}, not [404, 400]")
    if health["clients"] != n_clients or health["ticks"] < rounds:
        fail(f"serving: /healthz {health}")
    if steps != [rounds] * n_clients:
        fail(f"serving: step counts {steps}, expected {rounds} each")
    check_launches("the serving path", launches,
                   {"fps": rounds, "knn": rounds, "eva_attn_block": 72},
                   UNI3D_IDLE)
    return launches, {"warmup_s": warmup_s, "ticks": len(tick_ms),
                      "chunk_ms_by_size": chunk_ms,
                      "tick_ms_median": statistics.median(tick_ms),
                      "request_ms_p50": p50, "request_ms_p95": p95,
                      "tick_ms_by_requests": sized_ms}


#: The int8 path: Uni3D-L with `--quantize-int8 true`, captured.  Its
#: attention runs the (B, H, N, hd) kernel (row 7) once a block, and never
#: the block kernel (JAX bypasses `eva_attn_block_fused` under quantize).
INT8_PATH = (["--quantize-int8", "true"], (1024, 40), "large",
             {"fps": 1, "knn": 1, "attention_heads": 24},
             ("fps_grid", "knn_gather", "ballquery", "eva_attention",
              "eva_attn_block") + FP32_KERNELS)
#: QuantDense's shapes on Uni3D-L's trunk at batch 2: (rows, in, out).
QUANT_SHAPES = ((1026, 1024, 1024), (1026, 1024, 2730), (1026, 2730, 1024))


def check_quant(torch, tmp: Path, uni3d_ms: float) -> tuple:
    """The int8 trunk on the card: QuantDense's quantisation and int32
    products (cuBLASLt's int8 GEMM through `int_mm_padded`) bitwise equal
    to the CPU's at Uni3D-L's shapes; a quantised Uni3D-L at depth 2 in
    fp32, card against CPU within 1 − cosine 1e-4, and in bf16 within
    cosine 0.99 of the bf16 trunk's features (the JAX package's bound);
    then the full-width TTA path `uni3d_int8` through `cli.tta.main`
    (captured), its launches exactly 24 of row 7 a forward and none of
    the block kernel, its ms a step beside `uni3d`'s."""
    import dataclasses

    from uni_adapter_torch.config import ModelConfig
    from uni_adapter_torch.engine import WARMUP_RUNS
    from uni_adapter_torch.models import common
    from uni_adapter_torch.models.uni3d import create_uni3d

    # torch._int_mm's limits on the card, with the second operand laid out
    # as `int_mm_padded` passes it (the transpose of a contiguous (N, K))
    limits = {}
    for m, k, n in ((16, 64, 64), (17, 60, 64), (17, 64, 60), (17, 64, 64),
                    (24, 64, 64), (1026, 1024, 1024)):
        try:
            torch._int_mm(torch.ones(m, k, dtype=torch.int8, device="cuda"),
                          torch.ones(n, k, dtype=torch.int8, device="cuda").T)
            torch.cuda.synchronize()
            limits[(m, k, n)] = "runs"
        except RuntimeError as e:
            limits[(m, k, n)] = f"raises ({str(e).splitlines()[0][:70]})"
    print(f"torch._int_mm on the card, (M, K, N): {limits}")
    gen = torch.Generator(device="cuda").manual_seed(11)
    for rows, k, n in QUANT_SHAPES:
        x = torch.randn(rows, k, generator=gen, device="cuda")
        w = torch.randn(n, k, generator=gen, device="cuda") * 0.02
        xq, sx = common.quantize_rows(x)
        wq, sw = common.quantize_rows(w)
        xq_c, sx_c = common.quantize_rows(x.cpu())
        wq_c, sw_c = common.quantize_rows(w.cpu())
        acc = common.int8_matmul(xq, wq)
        acc_c = common.int8_matmul(xq_c, wq_c)
        same = (torch.equal(xq.cpu(), xq_c) and torch.equal(wq.cpu(), wq_c)
                and torch.equal(acc.cpu(), acc_c))
        ms = time_ms(lambda: common.int8_matmul(xq, wq))
        print(f"QuantDense ({rows}, {k}) -> {n}: int8 operands and int32 "
              f"products card vs cpu bitwise {same}; scales max |Δ| "
              f"{(sx.cpu() - sx_c).abs().max().item():.3g} / "
              f"{(sw.cpu() - sw_c).abs().max().item():.3g}; int8 GEMM "
              f"{ms:.4f} ms")
        if not same:
            fail(f"QuantDense's int8 product at ({rows}, {k}) -> {n} "
                 f"differs between the card and the CPU")
    mc = ModelConfig(eva_depth=2, compute_dtype="float32", quantize_int8=True)
    gpu = create_uni3d(mc, "cuda", seed=0)
    cpu = create_uni3d(mc, "cpu", state_dict={
        k: v.cpu() for k, v in gpu.state_dict().items()})
    bf16 = create_uni3d(dataclasses.replace(mc, compute_dtype="bfloat16"),
                        "cuda", state_dict=gpu.state_dict())
    plain = create_uni3d(dataclasses.replace(
        mc, compute_dtype="bfloat16", quantize_int8=False), "cuda",
        state_dict=gpu.state_dict())
    pc = torch.cat([sphere_cloud(torch, gen, 2, 1024),
                    torch.ones(2, 1024, 3, device="cuda")], dim=-1)
    with torch.no_grad():
        f_gpu, f_cpu = gpu(pc).cpu(), cpu(pc.cpu())
        f_q16, f_16 = bf16(pc), plain(pc)
    cos = torch.nn.functional.cosine_similarity
    c32 = cos(f_gpu, f_cpu, dim=-1).min().item()
    c8 = cos(f_q16, f_16, dim=-1).min().item()
    print(f"quantised Uni3D-L depth 2: fp32 card vs cpu 1 - cosine "
          f"{1 - c32:.3g} (gate 1e-4); int8 vs bf16 trunk on the card "
          f"cosine {c8:.5f} (gate 0.99)")
    if not (torch.isfinite(f_gpu).all() and 1 - c32 < 1e-4 and c8 > 0.99):
        fail("the quantised Uni3D disagrees with the CPU or the bf16 trunk")
    del gpu, cpu, bf16, plain
    # the captured MODE-DOTA step with residuals: two programs (the gate
    # closed at step 0, open after), each run WARMUP_RUNS times eagerly
    # before its capture, and 16 replays.  A trace that lost a launch (one
    # of this script's runs on an H100 counted 479 of 480) is taken again,
    # up to three times, as `check_replayed_kernels` does
    forwards = 16 + 2 * WARMUP_RUNS
    for _ in range(3):
        launches, step_ms = run_main_path(tmp, "uni3d_int8", spec=INT8_PATH)
        if launches["attention_heads"] == 24 * forwards:
            break
    else:
        fail(f"uni3d_int8: {launches['attention_heads']} attention_heads "
             f"launches over {forwards} forwards, expected 24 each, in "
             f"three traces")
    print(f"main path uni3d_int8: {step_ms:.2f} ms/step against uni3d's "
          f"{uni3d_ms:.2f} (bf16 block kernel); attention_heads 24 a "
          f"forward, eva_attn_block 0")
    return launches, step_ms


# ----------------------------------------------------------- phase 10


#: The block's twelve gradients, in `eva_attn_block`'s argument order.
BLOCK_GRADS = ("dxn", "dWq", "dbq", "dWk", "dWv", "dbv", "dγq", "dβq", "dγk",
               "dβk", "dWo", "dbo")


def grad_errs(got, want) -> dict:
    """err/tolerance of each of the block's gradients against its plain
    backward: rtol F32_RTOL + F32_ATOL_RMS of the gradient's RMS.  dβk is
    zero but for rounding (the softmax is invariant to a shift of every
    key by β, and so is the loss): its error scale is dγk's RMS, the same
    sum over the same dk rows times x̂."""
    out = {}
    for i, name in enumerate(BLOCK_GRADS):
        scale = want[8] if name == "dβk" else want[i]
        atol = F32_ATOL_RMS * scale.pow(2).mean().sqrt().item()
        out[name] = ((got[i] - want[i]).abs()
                     / (atol + F32_RTOL * want[i].abs())).max().item()
    return out


def check_block_backward(torch, gen) -> dict:
    """The backward of the fp32 EVA attention side at Uni3D-L's (2, 513,
    1024), 16 heads, peaked attention: the twelve gradients through
    `EvaAttnBlockFunction` on the card (the kernels of
    `csrc/eva_attn_block_bwd.cu`) against `eva_attn_block_backward` with
    the plain step (`eva_attn_block_bwd_plain`) on the same forward's
    workspaces, TF32 off, within rtol F32_RTOL + F32_ATOL_RMS of each
    gradient's RMS; two planted faults (the operands rounded to TF32, one
    key tile's dk and dv dropped) F32_FAULT_MARGIN outside.  Then the
    kernels' times (four launches, device ms each) beside the bound, the
    plain step's and the fp32 backward of SDPA on (B, H, N, 64) heads."""
    import torch.nn.functional as F

    from uni_adapter_torch.ops import attention

    Bt, T, D, H = 2, 513, 1024, 16
    hd, M = D // H, Bt * T
    scale, eps = hd ** -0.5, 1e-5
    args = [a.requires_grad_(True)
            for a in block_inputs(torch, gen, (Bt, T, D), torch.float32)]
    dy = torch.randn(Bt, T, D, generator=gen, device="cuda")
    plain_calls = attention.eva_attn_block_bwd_plain.calls
    out = attention.eva_attn_block(*args, num_heads=H, scale=scale)
    if out.grad_fn is None or "EvaAttnBlock" not in type(out.grad_fn).__name__:
        fail(f"eva_attn_block under grad did not run EvaAttnBlockFunction "
             f"({out.grad_fn})")
    got = torch.autograd.grad(out, args, dy)
    torch.cuda.synchronize()
    if attention.eva_attn_block_bwd_plain.calls != plain_calls:
        fail("the card's backward ran the plain version")
    x = [a.detach() for a in args]
    with torch.no_grad():
        fwd, qkv, attn = attention.eva_attn_block_fp32_cuda(
            *x, num_heads=H, scale=scale, workspaces=True)
    if not torch.equal(fwd, out.detach()):
        fail("eva_attn_block under grad: forward differs from the fp32 "
             "kernel's")
    saved = (x[0], x[1], x[2], x[3], x[4], x[6], x[8], x[10])

    def backward(dy, saved, qkv, attn, step):
        return attention.eva_attn_block_backward(
            dy, *saved, qkv, attn, H, scale, eps, step=step)

    want = backward(dy, saved, qkv, attn, attention.eva_attn_block_bwd_plain)
    errs = grad_errs(got, want)
    worst = max(errs.values())
    max_abs = max((g - w).abs().max().item() for g, w in zip(got, want))
    print(f"eva_attn_block backward (2, 513, 1024, 16): err/tolerance "
          + ", ".join(f"{n} {e:.4f}" for n, e in errs.items())
          + f" (rtol {F32_RTOL}, atol {F32_ATOL_RMS} × RMS); max abs err "
          f"{max_abs:.3g}")
    if not all(torch.isfinite(g).all() for g in got) or worst > 1:
        fail("eva_attn_block backward: outside the fp32 tolerance")

    def drop_key_tile(qkv, attn, dout, raw, gq, gk, B, N, H_, sc, ep):
        d = attention.attn_step_bwd_plain(qkv, attn, dout, B, N, H_, sc)
        d[:64, D:] = 0          # batch 0's first key tile: dk̂ and dv
        return attention.head_ln_bwd_plain(raw, d, gq, gk, H_, ep)

    faults = {
        "operands rounded to TF32": backward(
            round_tf32(dy), tuple(map(round_tf32, saved)), round_tf32(qkv),
            round_tf32(attn), attention.eva_attn_block_bwd_plain),
        "one key tile's dk, dv dropped": backward(
            dy, saved, qkv, attn, drop_key_tile)}
    for fault, bad in faults.items():
        rf = max(grad_errs(bad, want).values())
        print(f"  planted fault '{fault}': err/tolerance {rf:.1f}")
        if rf < F32_FAULT_MARGIN:
            fail(f"eva_attn_block backward: the planted fault '{fault}' is "
                 f"not {F32_FAULT_MARGIN}× outside the fp32 tolerance")

    dout = torch.matmul(dy.reshape(M, D), x[10]).contiguous()
    raw = torch.matmul(x[0].reshape(M, D), torch.cat([x[1], x[3]]).T)
    raw[:, :D] += x[2]
    step_args = (qkv, attn, dout, raw, x[6], x[8], Bt, T, H, scale, eps)
    kernel = lambda: attention.eva_attn_block_bwd_cuda(*step_args)
    plain = lambda: attention.eva_attn_block_bwd_plain(*step_args)
    q, k, v = (t.reshape(Bt, T, H, hd).transpose(1, 2).contiguous()
               .requires_grad_(True) for t in qkv.split(D, dim=1))
    o = F.scaled_dot_product_attention(q, k, v, scale=scale)
    do = dout.reshape(Bt, T, H, hd).transpose(1, 2).contiguous()
    sdpa_bwd = lambda: torch.autograd.grad(o, (q, k, v), do,
                                           retain_graph=True)
    n_ops = 5 * 2 * Bt * H * T * T * hd
    n_bytes = (3 * M * D + 2 * M * D + 2 * M * D + 2 * hd    # qkv, O, dO, raw
               + 3 * M * D + 4 * hd) * 4                     # dqkv, dln
    b_ms, b_by = bound(n_bytes, n_ops, PEAK_FP32)
    per_launch = device_ms_by_launch(kernel, 4)
    for name, ms in per_launch:
        print(f"  backward kernel {name[:60]}: device {ms:.4f} ms a launch")
    return {"name": "eva_attn_block_bwd", "route": "cuda",
            "source": "uni_adapter_torch/csrc/eva_attn_block_bwd.cu",
            "replaces": "none (the JAX package's XLA autodiff of "
                        "uni_adapter_tpu/models/common.py EvaAttention; the "
                        "forward is uni_adapter_tpu/ops/attention_pallas.py"
                        ":308)",
            "max_abs_err": max_abs, "ms": time_ms(kernel),
            "device_ms": device_ms(kernel), "plain_ms": time_ms(plain),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(sdpa_bwd),
            "library_device_ms": device_ms(sdpa_bwd),
            "per_launch": {name: ms for name, ms in per_launch}}


def check_grad_guard(torch) -> None:
    """Each wrapper whose kernel returns values and has no backward raises
    on the card when grad mode is on and an input requires grad (the
    result would carry no gradient): the bf16 block (row 3), the natural
    layout (rows 4, 4f), kNN + gather (row 6), the (B, H, N, hd) attention
    (rows 7, 9); under torch.no_grad each runs."""
    from uni_adapter_torch.ops import attention, attention_fp32
    from uni_adapter_torch.ops import attention_heads, eva_attention
    from uni_adapter_torch.ops import knn_gather

    def t(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, device="cuda").to(dtype).requires_grad_(
            True)

    bf, f32 = torch.bfloat16, torch.float32
    x, w, b = t(1, 65, 64), t(64, 64), t(64)
    ln = [t(64, dtype=f32) for _ in range(4)]
    h, hf = t(1, 1, 65, 64), t(1, 1, 65, 64, dtype=f32)
    xf = t(1, 65, 64, dtype=f32)
    xyz = t(1, 3000, 3, dtype=f32)
    calls = {
        "eva_attn_block (bf16)": lambda: attention.eva_attn_block(
            x, w, b, w, w, b, *ln, w, b, num_heads=1),
        "eva_attention (bf16)": lambda: eva_attention.eva_attention_fused(
            x, x, x, num_heads=1),
        "eva_attention (fp32)": lambda: eva_attention.eva_attention_fused(
            xf, xf, xf, num_heads=1),
        "knn_gather": lambda: knn_gather.knn_gather(8, xyz, xyz[:, :64],
                                                    xyz),
        "attention_heads": lambda: attention_heads.attention_heads(h, h, h),
        "attention_fp32": lambda: attention_fp32.attention_fp32(hf, hf, hf)}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if "no backward" not in str(e):
                fail(f"{name} under grad raised something else: {e}")
        else:
            fail(f"{name} ran under grad on inputs that require grad")
        with torch.no_grad():
            call()
    torch.cuda.synchronize()
    print(f"grad guard on the card: {', '.join(calls)} raise under grad, "
          "run under no_grad")


#: Pretraining at Uni3D-L's widths (`cli.pretrain`): EVA02-L trunk at
#: full depth, 512 groups of 64 on 10,000-point clouds, embeddings of
#: 1024, a global batch of 16 over PRETRAIN_SAMPLES seeded samples in two
#: shards (two batches an epoch), lr 1e-4.  The warmup spans the first
#: half, so the run stopped there (its --steps, and so its cosine, cut to
#: the half) took the same learning rates as the uninterrupted one.
PRETRAIN_DEPTH = 24
PRETRAIN_STEPS = 8
PRETRAIN_SAMPLES = 32
#: A train step's launches by counter (the fp32 block's wrapper counts
#: its three kernels, the backward's its four).
PRETRAIN_PER_STEP = {"fps_grid": 1, "knn_gather": 1,
                     "eva_attn_block_fp32": 3 * PRETRAIN_DEPTH,
                     "attn_f32_tc": PRETRAIN_DEPTH,
                     "eva_attn_block_bwd": 4 * PRETRAIN_DEPTH}
PRETRAIN_ARGS = ["--device", "cuda", "--trans-dim", "1024", "--heads", "16",
                 "--embed-dim", "1024", "--num-group", "512",
                 "--group-size", "64", "--encoder-dim", "512",
                 "--depth", str(PRETRAIN_DEPTH), "--batch-size", "16",
                 "--lr", "1e-4", "--warmup-steps", str(PRETRAIN_STEPS // 2),
                 "--log-every", "1", "--prefetch", "2"]


def write_corpus(root: Path, n: int = PRETRAIN_SAMPLES, n_points: int = 10000,
                 dim: int = 1024, shards: int = 2) -> list:
    """A seeded pretraining corpus as .npy shards: clouds (n, n_points, 6)
    of points on ellipsoids of per-sample axes (0.3-1) with one colour a
    cloud, and standard normal text and image embeddings of `dim`.
    Returns the --pc-shards / --text-shards / --image-shards flags."""
    import numpy as np

    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(1)
    per = n // shards
    for s in range(shards):
        u = rng.standard_normal((per, n_points, 3)).astype(np.float32)
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        u *= rng.uniform(0.3, 1.0, (per, 1, 3)).astype(np.float32)
        rgb = np.broadcast_to(rng.uniform(0, 1, (per, 1, 3)),
                              (per, n_points, 3)).astype(np.float32)
        np.save(root / f"pc_{s}.npy", np.concatenate([u, rgb], axis=-1))
        for tag in ("text", "image"):
            np.save(root / f"{tag}_{s}.npy",
                    rng.standard_normal((per, dim)).astype(np.float32))
    return ["--pc-shards", str(root / "pc_*.npy"), "--text-shards",
            str(root / "text_*.npy"), "--image-shards",
            str(root / "image_*.npy")]


def logged_losses(log: Path) -> list:
    """The per-step losses of a pretraining log (--log-every 1)."""
    return [float(m.group(1)) for m in
            re.finditer(r"step \d+/\d+  loss (\S+)", log.read_text())]


def assert_states_equal(what: str, a, b) -> None:
    """Two pretraining states bit for bit: step, count, log-scale, every
    parameter and both moments."""
    import torch

    if (a.step, a.opt_state.count) != (b.step, b.opt_state.count):
        fail(f"{what}: steps {a.step}/{a.opt_state.count} against "
             f"{b.step}/{b.opt_state.count}")
    pairs = [("logit_scale", a.logit_scale, b.logit_scale)]
    pairs += [(n, a.params[n], b.params[n]) for n in a.params]
    pairs += [(f"mu {n}", a.opt_state.mu[n], b.opt_state.mu[n])
              for n in a.opt_state.mu]
    pairs += [(f"nu {n}", a.opt_state.nu[n], b.opt_state.nu[n])
              for n in a.opt_state.nu]
    differ = [(n, (x - y).abs().max().item()) for n, x, y in pairs
              if not torch.equal(x, y)]
    if differ:
        fail(f"{what}: {len(differ)} of {len(pairs)} tensors differ, e.g. "
             f"{differ[:4]}")
    print(f"{what}: all {len(pairs)} tensors (parameters, moments, "
          f"log-scale) bitwise equal, step {a.step}")


def run_pretraining(tmp: Path, card: str) -> tuple:
    """Uni3D-L pretraining through `cli.pretrain` on the card (phase 10).

    A: PRETRAIN_STEPS steps in one go (`main` in-process, traced: every
    step through fps_grid, knn_gather, the fp32 block forward and its
    backward kernels, each backward kernel once a block a step, the plain
    backward never); B: `python -m uni_adapter_torch.cli.pretrain` for
    half the steps, a checkpoint; C: `--resume` from it to the end, which
    must equal A bit for bit.  The loss must stay finite and fall.  Then
    ms a step, samples a second and peak memory from a timed loop of the
    same train step.  Returns (A's launches by counter, summary)."""
    import torch

    from uni_adapter_torch import train
    from uni_adapter_torch.cli import pretrain
    from uni_adapter_torch.config import ModelConfig
    from uni_adapter_torch.data.streaming import (ShardedCorpus,
                                                  StreamingLoader)
    from uni_adapter_torch.models.uni3d import create_uni3d
    from uni_adapter_torch.native import loader
    from uni_adapter_torch.ops import attention

    shards = write_corpus(tmp / "corpus")
    args = PRETRAIN_ARGS + shards
    half = PRETRAIN_STEPS // 2
    plain_calls = attention.eva_attn_block_bwd_plain.calls
    out_a = tmp / "pretrain_a"
    t0 = time.perf_counter()
    state_a, launches, wrapper = traced_run(
        torch, "pretraining", lambda: pretrain.main(
            args + ["--steps", str(PRETRAIN_STEPS), "--ckpt-every", "100",
                    "--out", str(out_a)]),
        ("fps_grid", "knn_gather", "eva_attn_block_fp32", "attn_f32_tc",
         "eva_attn_block_bwd"))
    run_a_s = time.perf_counter() - t0
    if attention.eva_attn_block_bwd_plain.calls != plain_calls:
        fail("pretraining on the card ran the plain backward")
    want = {k: n * PRETRAIN_STEPS for k, n in PRETRAIN_PER_STEP.items()}
    got = {k: wrapper[k] for k in want}
    if got != want:
        fail(f"pretraining launches {got}, expected {want} (each backward "
             f"kernel once a block a step)")
    if any(launches[k] != n for k, n in want.items()):
        # late in a long process a trace has been seen to drop a few of a
        # run's kernels; the step traced below is held to the exact count
        print(f"  (the run's trace holds {launches}, of {want})")
    losses = logged_losses(out_a / "pretrain.log")
    if len(losses) != PRETRAIN_STEPS or not all(map(math.isfinite, losses)):
        fail(f"pretraining losses {losses}")
    first, last = sum(losses[:2]) / 2, sum(losses[-2:]) / 2
    print(f"pretraining (Uni3D-L, depth {PRETRAIN_DEPTH}, batch 16, "
          f"10,000 points): losses {losses}; launches {got} (traced "
          f"{ {k: launches[k] for k in want} }); {run_a_s:.1f} s for the "
          f"traced run")
    if not last < first:
        fail(f"pretraining: the loss did not fall (first two steps "
             f"{first:.4f}, last two {last:.4f})")
    if not loader.native_available():
        fail("the native .npy loader did not build on this machine")
    shutil.rmtree(out_a)

    out_b = tmp / "pretrain_b"
    repo = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = run_cmd(
        [sys.executable, "-m", "uni_adapter_torch.cli.pretrain", *args,
         "--steps", str(half), "--ckpt-every", str(half), "--out",
         str(out_b)], cwd=repo, timeout=600)
    if proc.returncode != 0:
        fail(f"python -m uni_adapter_torch.cli.pretrain exited "
             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    run_b_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state_c = pretrain.main(args + ["--steps", str(PRETRAIN_STEPS),
                                    "--ckpt-every", "100", "--resume",
                                    "--out", str(out_b)])
    run_c_s = time.perf_counter() - t0
    if "resumed at train step %d" % half not in (
            out_b / "pretrain.log").read_text():
        fail("the resumed pretraining run did not resume")
    assert_states_equal(f"pretraining stopped at step {half} and resumed "
                        f"against uninterrupted", state_a, state_c)
    print(f"pretraining B (python -m, {half} steps + checkpoint) "
          f"{run_b_s:.1f} s, C (--resume to {PRETRAIN_STEPS}) {run_c_s:.1f} s")
    del state_a, state_c
    shutil.rmtree(out_b)

    # ms a step: the same train step on the corpus, untraced
    cfg = ModelConfig(eva_depth=PRETRAIN_DEPTH, compute_dtype="float32")
    model = create_uni3d(cfg, "cuda", torch.float32, seed=0, trainable=True)
    tx = train.make_optimizer(lr=1e-4, total_steps=100, warmup_steps=1)
    state = train.init_train_state(model, tx)
    corpus = ShardedCorpus(*(sorted(map(str, (tmp / "corpus").glob(
        f"{tag}_*.npy"))) for tag in ("pc", "text", "image")))
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(
        StreamingLoader(corpus, 16, prefetch=0)).items()
        if k in ("pc", "text_embed", "image_embed", "mask")}
    step = lambda st: train.train_step(model, tx, st, batch["pc"],
                                       batch["text_embed"],
                                       batch["image_embed"], batch["mask"])
    state, _ = step(state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, metrics = step(state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"pretraining step ({card}): {ms:.1f} ms a step (steps {times}), "
          f"{16e3 / ms:.2f} samples/s, peak memory {peak_gb:.2f} GB")
    holder = [state]

    def one_step():
        holder[0] = step(holder[0])[0]

    exact = ("eva_attn_block_fp32", "attn_f32_tc", "eva_attn_block_bwd")
    for attempt in range(3):
        counters = zeroed_counters()
        kernels = device_kernel_times(torch, one_step)
        wrapped = {k: counters[k].launches for k in PRETRAIN_PER_STEP}
        by_name = kernel_counts(name for name, _ in kernels)
        counts = by_counter(by_name, PRETRAIN_PER_STEP)
        traced = {k: counts[k] for k in PRETRAIN_PER_STEP}
        bwd = {k: by_name[k] for k in COUNTER_KERNELS["eva_attn_block_bwd"]}
        if wrapped == PRETRAIN_PER_STEP and all(
                traced[k] == PRETRAIN_PER_STEP[k] for k in exact) and set(
                bwd.values()) == {PRETRAIN_DEPTH}:
            break
        print(f"  (a traced step: wrappers {wrapped}, trace {traced}, the "
              f"backward's kernels {bwd}, of {PRETRAIN_PER_STEP})")
    else:
        fail(f"three traced train steps: wrappers {wrapped}, trace "
             f"{traced}, not {PRETRAIN_PER_STEP} (each backward kernel "
             f"once a block)")
    print(f"pretraining: one traced step launches {wrapped} (trace "
          f"{traced}); the backward's kernels in the trace {bwd}: each "
          f"{PRETRAIN_DEPTH} times, once a block")
    if any(traced[k] != n for k, n in PRETRAIN_PER_STEP.items()):
        # the run's trace above held FPS and kNN once a step; this one
        # has lost them in four calls of four (their names, if any):
        names = {n[:90] for n, _ in kernels if "fps" in n or "knn" in n}
        print(f"  grouping kernels in this trace: {sorted(names)}")
    groups = dict.fromkeys((g for g, _ in STEP_GROUPS), 0.0)
    for name, ms_ in kernels:
        groups[next(g for g, pat in STEP_GROUPS if re.search(pat, name))] += ms_
    busy = sum(groups.values())
    print(f"pretraining step device ms by group (traced step, {card}): "
          + "; ".join(f"{g} {v:.1f}" for g, v in groups.items())
          + f"; busy {busy:.1f} of {ms:.1f} ms ({1 - busy / ms:.1%} idle)")
    del model, state, holder
    torch.cuda.empty_cache()
    return launches, {"losses": losses, "ms_a_step": ms,
                      "samples_per_s": 16e3 / ms, "peak_gb": peak_gb,
                      "device_ms_by_group": groups, "busy_ms": busy,
                      "run_s": {"traced_a": run_a_s, "subprocess_b": run_b_s,
                                "resume_c": run_c_s}}


#: The dVAE's card-against-CPU tolerance on one step's gradients: each
#: within DVAE_REL of its norm, ‖card − CPU‖ ≤ DVAE_REL·‖CPU‖.  Both sides
#: are fp32 with TF32 off and the same kNN indices, and sum in other
#: orders through GroupNorm's E[x²] − E[x]² over 8192 channels, a softmax
#: over 8192 tokens and Chamfer minima.  On the CPU alone, one thread
#: against eight parts these gradients by up to 2.3e-4 of their norm, and
#: element by element by up to 16× rtol 1e-3 + 1e-3 of the RMS (the
#: codebook's): an element-wise bound would measure that conditioning,
#: not the card.  On an H100 the worst was 1.16e-3 (GroupNorm 5's gain of
#: the first DGCNN).  A wrong neighbour or a dropped group moves a
#: gradient by a tenth of its norm or more.  The loss within 1e-5 of the
#: CPU's.
DVAE_REL = 5e-3

#: The train step's device time by group of kernels (by name), for the
#: breakdown `run_pretraining` prints.
STEP_GROUPS = (("backward kernels (eva_attn_block_bwd.cu)", r"eva_bwd_"),
               ("fp32 block forward (eva_attn_block.cu)",
                r"gemm_f32_kernel|attn_f32_tc_kernel|attn_f32_kernel"),
               ("grouping (fps_grid, knn_gather)",
                r"fps_grid_kernel|knn_gather_kernel"),
               ("cuBLAS GEMMs", r"gemm|xmma|cutlass|sm90_|ampere_"),
               ("other (elementwise, reductions, norms, optimizer)", r""))


def run_dvae(torch) -> tuple:
    """The dVAE at Point-BERT's widths (64 groups × 32, dims 256, 8192
    tokens, 1024-point clouds, batch 4) on the card (phase 10): one step's
    loss and gradients against the CPU's on the same weights and Gumbel
    draw, then three train steps traced (fps, knn: grouping and the k = 4
    graph), the loss finite.  Returns (the wrappers' launches by counter,
    summary)."""
    from uni_adapter_torch.models import dvae, dvae_train

    gen = torch.Generator(device="cuda").manual_seed(5)
    model = dvae.create_dvae("cuda", seed=0)
    xyz = cloud(torch, gen, B=4, N=1024)[..., :3].contiguous()
    gumbel = dvae.gumbel_noise((4, 64, 8192), gen, "cuda")
    temp, kl_w = dvae_train.schedule_at(dvae_train.DVAESchedule(), 5000,
                                        "cuda")
    cpu = dvae.create_dvae("cpu", state_dict={
        k: v.detach().cpu() for k, v in model.state_dict().items()})

    def loss_and_grads(m, x, g, t, k):
        params = list(m.parameters())
        rec, klv = dvae.dvae_loss(m(x, temperature=t, gumbel=g))
        loss = rec + k * klv
        return loss, torch.autograd.grad(loss, params)

    loss, grads = loss_and_grads(model, xyz, gumbel, temp, kl_w)
    want_loss, want = loss_and_grads(cpu, xyz.cpu(), gumbel.cpu(), temp.cpu(),
                                     kl_w.cpu())
    worst, name = 0.0, ""
    for (n, _), g, w in zip(model.named_parameters(), grads, want):
        r = ((g.cpu() - w).norm() / w.norm()).item()
        if r > worst:
            worst, name = r, n
    print(f"dVAE one step card vs CPU: loss {loss.item():.7f} / "
          f"{want_loss.item():.7f}, gradients' worst ‖Δ‖/‖CPU‖ {worst:.3g} "
          f"({name}; tolerance {DVAE_REL})")
    if not abs(loss.item() - want_loss.item()) <= 1e-5 * abs(
            want_loss.item()) or worst > DVAE_REL:
        fail("dVAE: the card's step is outside the tolerance of the CPU's")
    del cpu, want

    tx = dvae_train.make_optimizer()
    sched = dvae_train.DVAESchedule()
    state = dvae_train.init_train_state(model, tx)

    def steps():
        nonlocal state
        out = []
        for _ in range(3):
            state, m = dvae_train.dvae_train_step(model, tx, sched, state,
                                                  xyz, gen)
            out.append(m["loss"].item())
        return out

    t0 = time.perf_counter()
    losses, launches, wrapper = traced_run(torch, "the dVAE's train steps",
                                           steps, ("fps", "knn"))
    secs = time.perf_counter() - t0
    if not all(map(math.isfinite, losses)):
        fail(f"dVAE losses {losses}")
    # the count from the wrappers: late in a long process, a trace has
    # been seen to drop a few of a run's kernels (here 2 of 30 once)
    if (wrapper["fps"], wrapper["knn"]) != (3, 3 * 9) or not (
            launches["fps"] and launches["knn"]):
        fail(f"dVAE launches {wrapper} (traced {launches}): expected fps "
             f"3 and knn 27 (the grouping and 2 × 4 graph layers a step)")
    print(f"dVAE train steps: losses {losses}, launches fps "
          f"{wrapper['fps']}, knn {wrapper['knn']} (traced {launches['fps']}"
          f", {launches['knn']}); {secs:.2f} s traced")
    return wrapper, {"losses": losses, "grad_rel_err": worst,
                     "traced_launches": {"fps": launches["fps"],
                                         "knn": launches["knn"]}}


# ---- phase 11: data parallelism and the cross-class analysis -------------

#: The distributed streams' tolerances (tests/test_parallel.py's): under
#: psum at world 2 against one process at batch 2, the means within rtol
#: 1e-3 and the soft counts within rtol 1e-4 (atol 1e-5 both).
PSUM_MU_RTOL, PSUM_COUNT_RTOL, PSUM_ATOL = 1e-3, 1e-4, 1e-5
#: The 15-corruption sweep over two ranks: 16 streams (15 does not divide
#: over 2), 2 clouds a stream.
DIST_SWEEP = (16, 2)
#: The data-parallel train step at world 2 (depth 2, global batch 16)
#: against one process on the same batch, fp32: the loss and the
#: gradient norm within rtol 1e-5 (the same sums in other orders, two
#: half batches through the kernels).  The parameters after two steps
#: (lr 0 at the first under warmup, DP_LR at the second): Adam moves a
#: coordinate by lr·m̂/√v̂, |m̂/√v̂| ≤ 1.05 at these two steps, whatever
#: the size of its gradient, so a coordinate whose gradient is at the
#: level of its rounding noise (the k LayerNorm's bias has a gradient of
#: 0 in exact arithmetic) can land anywhere within 2.1·lr of the other
#: run's, and no bound on the largest difference can fail.  What binds:
#: the loss, the gradient norm, the ranks bitwise equal, and 99% of the
#: coordinates within DP_PARAM_ATOL (a gradient not averaged over the
#: ranks moves most coordinates by a sizeable fraction of lr); the
#: largest difference is printed (0.575·lr on an H100 80GB HBM3 at
#: 700 W, this script's run).
DP_LOSS_RTOL, DP_LR = 1e-5, 1e-4
DP_PARAM_ATOL = 1e-2 * DP_LR
#: The cross-class analysis, card against CPU: bf16 at full depth, the
#: centroids and distances within the extraction's MAP_ATOL; the t-SNE
#: (fp64, the same init) within 1e-6 of the embedding's scale.
TSNE_REL = 1e-6


def free_port() -> int:
    """A free TCP port on the loopback interface (a rendezvous or an HTTP
    address), chosen at random below the kernel's ephemeral range where
    there is room.  The kernel hands out the ports of that range by
    itself, to gloo's and NCCL's listeners and to every outgoing
    connection, so a port taken from it could go to another process of
    this run before its own process binds it; a client would then wait
    on a listener that never answers."""
    import random
    import socket

    try:
        low = int(Path("/proc/sys/net/ipv4/ip_local_port_range")
                  .read_text().split()[0])
    except (OSError, ValueError, IndexError):
        low = 0
    pick = random.SystemRandom()
    for _ in range(200 if low >= 12000 else 0):
        port = pick.randrange(low - 10000, low)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dist_inputs(torch) -> dict:
    """The distributed phases' inputs, numpy-seeded so that every process
    reads the same bits: a 16-cloud ModelNet40-like stream (1024 points on
    spheres, batch 1), the DIST_SWEEP streams (the last a repeat of the
    first, as the 15 corruptions are padded to 16), and one global batch of 16
    10,000-point clouds with 1024-d embeddings (a third of the image rows
    masked out)."""
    import numpy as np

    rng = np.random.default_rng(20)

    def spheres(*lead, n=1024):
        x = rng.standard_normal((*lead, n, 3)).astype(np.float32)
        return 0.5 * x / np.linalg.norm(x, axis=-1, keepdims=True)

    pcs = spheres(16, 1)
    C, T = DIST_SWEEP
    sweep = spheres(C, T, 1)
    sweep_targets = rng.integers(0, 40, (C, T, 1))
    # 15 corruption streams and one repeated
    sweep[C - 1], sweep_targets[C - 1] = sweep[0], sweep_targets[0]
    cloud = spheres(16, n=10000) * rng.uniform(0.6, 1.4, (16, 1, 3)).astype(
        np.float32)
    batch = {"pc": np.concatenate([cloud, np.broadcast_to(
                 rng.uniform(0, 1, (16, 1, 3)), cloud.shape)], -1)
                 .astype(np.float32),
             "text_embed": rng.standard_normal((16, 1024)).astype(np.float32),
             "image_embed": rng.standard_normal((16, 1024))
             .astype(np.float32),
             "mask": (np.arange(16) % 3 != 2).astype(np.float32)}
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return {"stream": (t(pcs), torch.ones(16, 1, 1024, 3),
                       t(rng.integers(0, 40, (16, 1)))),
            "sweep": (t(sweep), torch.ones(C, T, 1, 1024, 3),
                      t(sweep_targets)),
            "batch": {k: t(v) for k, v in batch.items()}}


def half_met(torch, logits):
    """Targets that a run's predictions meet on every other cloud: the
    argmax of its final logits (..., K) on the even clouds, the next class
    on the odd ones, so that its acc@1 is 50% and a run that predicts
    otherwise shows it."""
    pred = logits.argmax(-1).cpu()
    odd = torch.arange(pred.numel()).reshape(pred.shape) % 2 == 1
    return torch.where(odd, (pred + 1) % logits.shape[-1], pred)


def engine_tensors(state) -> dict:
    """An EngineState's tensors by name, on the CPU."""
    out = {f"method.{n}": getattr(state.method_state, n).cpu()
           for n in state.method_state._fields}
    if state.res_state is not None:
        out.update({f"res.{n}": getattr(state.res_state, n).cpu()
                    for n in state.res_state._fields})
    return out


def stream_cfg(noise: bool = True, dtype: str = "bfloat16"):
    """Uni3D-L at published width and depth in `dtype`, MODE-DOTA with
    residual learning (the defaults); without noise: noise_std 0 and
    residual learning off, the configuration of tests/test_parallel.py's
    psum check (the residuals' Adam steps turn the last-bit differences
    of two summation orders into steps of ±lr, which the PSUM_*
    tolerances do not cover)."""
    from uni_adapter_torch.config import Config, DotaConfig, ModelConfig

    return Config(model=ModelConfig(compute_dtype=dtype),
                  dota=DotaConfig() if noise else DotaConfig(
                      noise_std=0.0, res_learning=False))


def allreduce_share(torch, run) -> dict:
    """run() under a CPU and CUDA trace: the wall ms of the run, the host
    ms inside the outermost all-reduce events (gloo's or NCCL's), and
    the device ms of NCCL's kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    def is_ar(name: str) -> bool:
        return "allreduce" in name.lower() or "all_reduce" in name.lower()

    cuda = torch.autograd.DeviceType.CUDA
    device = sum(ev.duration_ns() / 1e6
                 for ev in prof.profiler.kineto_results.events()
                 if ev.device_type() == cuda and "nccl" in ev.name().lower())
    host = 0.0
    for ev in prof.events():
        if ev.device_type == cuda or not is_ar(ev.name):
            continue
        parent = ev.cpu_parent
        while parent is not None and not is_ar(parent.name):
            parent = parent.cpu_parent
        if parent is None:
            host += ev.cpu_time_total / 1e3
    return {"wall_ms": wall, "allreduce_host_ms": host,
            "allreduce_share": host / wall, "nccl_device_ms": device}


def grad_norm_recorder(train) -> tuple:
    """Wrap `train.apply_grads` so that each call records the global norm
    of the gradients it applies; returns (norms, restore)."""
    import torch

    norms, apply = [], train.apply_grads

    def recorded(state, tx, grads, decay):
        norms.append(float(torch.sqrt(sum(torch.sum(g * g)
                                          for g in grads.values()))))
        return apply(state, tx, grads, decay)

    train.apply_grads = recorded
    return norms, lambda: setattr(train, "apply_grads", apply)


def dp_depth2(torch, device, batch, rows=None, world=None) -> dict:
    """Two steps of Uni3D (width 1024, depth 2, fp32, seed 0) on `batch`:
    `train_step` in one process, or `make_dp_train_step` over `world` on
    this rank's `rows`.  Returns losses, gradient norms, ms a step and
    the parameters (CPU)."""
    from uni_adapter_torch import train
    from uni_adapter_torch.config import ModelConfig
    from uni_adapter_torch.models.uni3d import create_uni3d

    model = create_uni3d(ModelConfig(eva_depth=2, compute_dtype="float32"),
                         device, torch.float32, seed=0, trainable=True)
    tx = train.make_optimizer(lr=DP_LR, total_steps=4, warmup_steps=1)
    state = train.init_train_state(model, tx)
    b = {k: v[rows if rows is not None else slice(None)].to(device)
         for k, v in batch.items()}
    args = (b["pc"], b["text_embed"], b["image_embed"], b["mask"])
    if world is None:
        step = lambda st: train.train_step(model, tx, st, *args)  # noqa: E731
    else:
        dp = train.make_dp_train_step(model, tx, world)
        step = lambda st: dp(st, *args)  # noqa: E731
    norms, restore = grad_norm_recorder(train)
    losses, ms = [], []
    try:
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss"]))
    finally:
        restore()
    return {"losses": losses, "grad_norms": norms, "ms": ms,
            "params": {n: p.detach().cpu() for n, p in state.params.items()},
            "logit_scale": float(state.logit_scale)}


def dist_rank(rank: int, world: int, tmp: str, mode: str, port: int) -> None:
    """One rank of the world-2 phases, started by `run_dist_world`: joins
    the group through `parallel/bootstrap.py` (mode 'gloo': every rank
    sees card 0 alone, so the ranks share it over gloo; 'nccl': a card a
    rank), runs the three stream modes, the sweep and the DP train step,
    and writes its results to tmp/rank{rank}_{mode}.pt."""
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if mode == "gloo":
        os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    import torch
    import torch.distributed as dist

    from uni_adapter_torch import engine
    from uni_adapter_torch.anchors import load_precomputed
    from uni_adapter_torch.cli.tta import set_numerics
    from uni_adapter_torch.models.loader import build_backbone
    from uni_adapter_torch.parallel import mesh as pmesh
    from uni_adapter_torch.parallel.bootstrap import init_distributed_device

    boot = init_distributed_device("cuda")
    set_numerics()
    try:
        dev, world_ = boot["device"], pmesh.make_mesh()
        inputs = torch.load(Path(tmp) / "inputs.pt", weights_only=False)
        out = {"backend": boot["backend"], "device": str(dev)}
        text = load_precomputed("large", "modelnet").to(dev)
        cfg, cfg32 = stream_cfg(), stream_cfg(False, "float32")
        model, _, _ = build_backbone("uni3d", cfg.model, dev, seed=0)
        model32, _, _ = build_backbone("uni3d", cfg32.model, dev, seed=0)
        for mode_name, run, c, m in (
                ("sharded", pmesh.run_stream_sharded, cfg, model),
                ("psum", pmesh.run_stream_psum, stream_cfg(False), model),
                ("psum_fp32", pmesh.run_stream_psum, cfg32, model32)):
            counters = zeroed_counters()
            scan_fn = engine.make_scan_fn(
                c, m, axis_name=None if mode_name == "sharded"
                else world_.group)
            state, summary = run(c, m, text, *inputs["stream"], seed=42,
                                 scan_fn=scan_fn)
            out[mode_name] = {
                "state": engine_tensors(state), "summary": summary,
                "step_ms": list(scan_fn.step_ms),
                "launches": {k: counters[k].launches for k in
                             ("fps", "knn", "eva_attn_block")}}
            if mode_name == "psum":
                out["psum"]["trace"] = allreduce_share(torch, lambda: run(
                    c, model, text, *inputs["stream"], seed=42,
                    scan_fn=scan_fn))
        scan_fn = engine.make_scan_fn(cfg, model)
        state, summary = pmesh.run_streams_sharded(
            cfg, model, text, *inputs["sweep"], seed=42, scan_fn=scan_fn)
        out["streams"] = {"state": engine_tensors(state), "summary": summary,
                          "step_ms": list(scan_fn.step_ms)}
        del model, model32
        torch.cuda.empty_cache()
        half = 16 // world
        out["dp"] = dp_depth2(torch, dev, inputs["batch"],
                              slice(rank * half, (rank + 1) * half), world_)
        torch.save(out, Path(tmp) / f"rank{rank}_{mode}.pt")
    finally:
        dist.barrier()
        dist.destroy_process_group()


def run_dist_world(tmp: Path, mode: str) -> list:
    """The world-2 phases on two spawned processes (`dist_rank`); returns
    each rank's results."""
    import torch
    import torch.multiprocessing as mp

    port = free_port()
    t0 = time.perf_counter()
    mp.start_processes(dist_rank, args=(2, str(tmp), mode, port), nprocs=2,
                       join=True, start_method="spawn")
    print(f"dist world 2 ({mode}): both ranks done in "
          f"{time.perf_counter() - t0:.1f} s")
    return [torch.load(tmp / f"rank{r}_{mode}.pt", weights_only=False)
            for r in range(2)]


def states_equal(a: dict, b: dict) -> bool:
    import torch

    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def max_abs_diff(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def check_psum_close(what: str, got: dict, want: dict) -> None:
    """Means and soft counts of a psum run against one process at the
    global batch, PSUM_* tolerances."""
    import torch

    for name, rtol in (("method.mu", PSUM_MU_RTOL),
                       ("method.c", PSUM_COUNT_RTOL)):
        g, w = got[name].float(), want[name].float()
        if not torch.allclose(g, w, rtol=rtol, atol=PSUM_ATOL):
            fail(f"{what}: {name} max |Δ| {(g - w).abs().max().item():.3g} "
                 f"outside rtol {rtol}, atol {PSUM_ATOL}")


def run_dist_streams(tmp: Path, card: str, inputs: dict) -> tuple:
    """Phase 11a: the stream modes over torch.distributed, Uni3D-L bf16,
    MODE-DOTA with residuals, 16 clouds, captured.

    (a) world 1 over NCCL (this process): `run_stream_sharded` and
    `run_stream_psum` (the step in segments with the all-reduces between
    their replays) bitwise equal to `run_stream_scan`; ms a step of each;
    the psum run traced for its launches and for its all-reduces' share.
    (b) world 2, two processes sharing the card over gloo: 'sharded'
    bitwise equal to the two shards run one by one here (seeds 42, 43);
    'psum' (noise 0, residuals off) in fp32 within PSUM_* of one process
    at batch 2 with acc@1 equal (in bf16 its distance and acc@1 printed:
    cuBLAS's bf16 GEMMs are not batch-invariant), both ranks' states
    bitwise equal; `run_streams_sharded` on the DIST_SWEEP streams: every
    stream's acc@1 equal to `run_streams_scan`'s and each rank's states to
    its streams'.  The targets are met on half the clouds (`half_met`),
    so no acc@1 compared is 0 by chance.  (c) with two cards or more,
    (b) again over NCCL; with one, a line says so.  The world-2 ranks
    also take two DP train steps (`dp_depth2`), which `run_dp_pretraining`
    checks.  Returns (the world-1 psum run's launches, summary, {mode:
    each rank's DP results})."""
    import torch
    import torch.distributed as dist

    from uni_adapter_torch import engine
    from uni_adapter_torch.anchors import load_precomputed
    from uni_adapter_torch.models.loader import build_backbone
    from uni_adapter_torch.parallel import mesh as pmesh

    t_phase = time.perf_counter()
    text = load_precomputed("large", "modelnet").cuda()
    cfg, cfg32 = stream_cfg(), stream_cfg(False, "float32")
    model, _, _ = build_backbone("uni3d", cfg.model, "cuda", seed=0)
    model32, _, _ = build_backbone("uni3d", cfg32.model, "cuda", seed=0)
    ms = {}

    # the targets, met on half the clouds by the fp32 run at batch 2
    # (psum's reference) and by the 16 streams run together, so that
    # every acc@1 comparison below can fail
    batch2_runs = {dtype: (c, m, engine.make_scan_fn(c, m)) for dtype, c, m
                   in (("bfloat16", stream_cfg(False), model),
                       ("float32", cfg32, model32))}
    in_pairs = lambda s: tuple(  # noqa: E731
        a.reshape(8, 2, *a.shape[2:]) for a in s)
    _, outs = engine.run_stream_scan(cfg32, model32, text,
                                     *in_pairs(inputs["stream"]), seed=42,
                                     scan_fn=batch2_runs["float32"][2])
    inputs["stream"] = (*inputs["stream"][:2],
                        half_met(torch, outs.final_logits).reshape(16, 1))
    sweep_fn = engine.make_scan_fn(cfg, model)
    _, outs = engine.run_streams_scan(cfg, model, text, *inputs["sweep"],
                                      seed=42, scan_fn=sweep_fn)
    inputs["sweep"] = (*inputs["sweep"][:2], half_met(
        torch, outs.final_logits).transpose(0, 1).contiguous())
    torch.save(inputs, tmp / "inputs.pt")
    stream = inputs["stream"]

    plain_fn = engine.make_scan_fn(cfg, model)
    state_p, outs_p = engine.run_stream_scan(cfg, model, text, *stream,
                                             seed=42, scan_fn=plain_fn)
    want = engine.summarize(outs_p, 16)
    ms["plain"] = statistics.median(plain_fn.step_ms[1:])
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        world = pmesh.make_mesh()
        for name, run in (("sharded", pmesh.run_stream_sharded),
                          ("psum", pmesh.run_stream_psum)):
            scan_fn = engine.make_scan_fn(
                cfg, model, axis_name=world.group if name == "psum" else None)
            go = lambda: run(cfg, model, text, *stream, seed=42,  # noqa: E731
                             scan_fn=scan_fn)
            if name == "psum":
                (state, summary), launches, wrapper = traced_run(
                    torch, "the psum stream (world 1, NCCL)", go,
                    ("fps", "knn", "eva_attn_block"))
                trace1 = allreduce_share(torch, go)
            else:
                state, summary = go()
            ms[f"{name}_world1"] = statistics.median(scan_fn.step_ms[1:])
            same = states_equal(engine_tensors(state),
                                engine_tensors(state_p))
            accs = [summary[k] for k in ("acc1", "acc3", "acc5")]
            print(f"dist {name} world 1 (NCCL): final state bitwise equal to "
                  f"run_stream_scan's: {same}; acc@1/3/5 {accs} (scan "
                  f"{[want[k] for k in ('acc1', 'acc3', 'acc5')]})")
            if not same or accs != [want[k] for k in ("acc1", "acc3",
                                                      "acc5")]:
                fail(f"dist {name} at world 1 differs from run_stream_scan")
        print(f"dist psum world 1 launches (traced): {launches}; wrappers "
              f"{ {k: wrapper[k] for k in ('fps', 'knn', 'eva_attn_block')} }")
        print(f"dist psum world 1: all-reduces {trace1['allreduce_host_ms']:.2f}"
              f" ms of {trace1['wall_ms']:.1f} ms host time over 16 steps "
              f"({trace1['allreduce_share']:.2%}); NCCL kernels "
              f"{trace1['nccl_device_ms']:.3f} device ms")
    finally:
        dist.destroy_process_group()

    # the references of world 2: the shards one by one, batch 2, the sweep
    shards, correct = [], 0
    for r in range(2):
        st, outs = engine.run_stream_scan(
            cfg, model, text, *(a[8 * r:8 * r + 8] for a in stream),
            seed=42 + r, scan_fn=plain_fn)
        shards.append(engine_tensors(st))
        correct = correct + outs.correct.sum(0)
    shards_acc1 = 100.0 * correct.tolist()[0] / 16
    batch2, batch2_acc = {}, {}
    for dtype, (c0, m0, b2_fn) in batch2_runs.items():
        st, outs = engine.run_stream_scan(c0, m0, text, *in_pairs(stream),
                                          seed=42, scan_fn=b2_fn)
        batch2[dtype] = engine_tensors(st)
        batch2_acc[dtype] = engine.summarize(outs, 16)["acc1"]
        ms[f"plain_batch2_{dtype}"] = statistics.median(b2_fn.step_ms[1:])
    del batch2_runs, model32, m0, b2_fn
    # the sweep: each rank's 8 streams as one stack (the rank's shapes),
    # and the 16 together
    C, T = DIST_SWEEP
    per = C // 2
    sweep_parts = [engine_tensors(engine.run_streams_scan(
        cfg, model, text, *(a[r * per:(r + 1) * per] for a in
                            inputs["sweep"]), seed=42 + r * per,
        scan_fn=sweep_fn)[0]) for r in range(2)]
    st, outs = engine.run_streams_scan(cfg, model, text, *inputs["sweep"],
                                       seed=42, scan_fn=sweep_fn)
    sweep_state = engine_tensors(st)
    sweep_acc = [s["acc1"] for s in engine.summarize_streams(outs, T)]
    ms["plain_sweep16"] = statistics.median(sweep_fn.step_ms[1:])
    runs = {"gloo": run_dist_world(tmp, "gloo")}
    if torch.cuda.device_count() >= 2:
        runs["nccl"] = run_dist_world(tmp, "nccl")
    else:
        print("dist world 2 over NCCL: not run, this machine has one card "
              "(NCCL needs a card a rank; the two ranks shared it over gloo)")
    summary = {"ms_a_step": ms, "trace_world1": trace1}
    for mode, ranks in runs.items():
        backends = {r["backend"] for r in ranks}
        if backends != {mode}:
            fail(f"dist world 2 ({mode}): the bootstrap chose {backends}")
        for r, res in enumerate(ranks):
            if not states_equal(res["sharded"]["state"], shards[r]):
                fail(f"dist sharded world 2 ({mode}), rank {r}: the final "
                     f"state differs from shard {r} run alone, max |Δ| "
                     f"{max_abs_diff(res['sharded']['state'], shards[r]):.3g}")
        for r, res in enumerate(ranks):
            if res["sharded"]["summary"]["acc1"] != shards_acc1:
                fail(f"dist sharded world 2 ({mode}), rank {r}: acc@1 "
                     f"{res['sharded']['summary']['acc1']} against the "
                     f"shards' {shards_acc1}")
        for name in ("psum", "psum_fp32"):
            if not states_equal(ranks[0][name]["state"],
                                ranks[1][name]["state"]):
                fail(f"dist {name} world 2 ({mode}): the ranks' states "
                     f"differ")
        check_psum_close(f"dist psum world 2 ({mode}), fp32",
                         ranks[0]["psum_fp32"]["state"], batch2["float32"])
        psum_acc = {"bfloat16": ranks[0]["psum"]["summary"]["acc1"],
                    "float32": ranks[0]["psum_fp32"]["summary"]["acc1"]}
        if psum_acc["float32"] != batch2_acc["float32"]:
            fail(f"dist psum_fp32 world 2 ({mode}): acc@1 "
                 f"{psum_acc['float32']} against batch 2's "
                 f"{batch2_acc['float32']}")
        psum_diff = {dtype: max_abs_diff(
            {k: ranks[0][name]["state"][k] for k in ("method.mu",
                                                     "method.c")},
            {k: batch2[dtype][k] for k in ("method.mu", "method.c")})
            for name, dtype in (("psum", "bfloat16"),
                                ("psum_fp32", "float32"))}
        sweep_same, sweep_diff = [], 0.0
        for r, res in enumerate(ranks):
            if res["streams"]["summary"]["acc1_per_stream"] != sweep_acc:
                fail(f"dist streams world 2 ({mode}), rank {r}: acc@1 per "
                     f"stream {res['streams']['summary']['acc1_per_stream']} "
                     f"against run_streams_scan's {sweep_acc}")
            if not states_equal(res["streams"]["state"], sweep_parts[r]):
                fail(f"dist streams world 2 ({mode}), rank {r}: its streams' "
                     f"states differ from the same 8 streams run here")
            mine = {k: v[r * per:(r + 1) * per] for k, v in
                    sweep_state.items() if v.dim() > 0 and v.shape[0] == C}
            sweep_same.append(states_equal(
                {k: res["streams"]["state"][k] for k in mine}, mine))
            sweep_diff = max(sweep_diff, max_abs_diff(
                {k: res["streams"]["state"][k] for k in mine}, mine))
        ms[f"sharded_world2_{mode}"] = statistics.median(
            ranks[0]["sharded"]["step_ms"][1:])
        ms[f"psum_world2_{mode}"] = statistics.median(
            ranks[0]["psum"]["step_ms"][1:])
        ms[f"sweep16_world2_{mode}"] = statistics.median(
            ranks[0]["streams"]["step_ms"][1:])
        tr = ranks[0]["psum"]["trace"]
        summary[f"trace_world2_{mode}"] = tr
        print(f"dist world 2 ({mode}): sharded bitwise equal to the shards "
              f"run alone (seeds 42, 43) on both ranks; psum (noise 0, "
              f"residuals off), fp32: within rtol {PSUM_MU_RTOL} (means) / "
              f"{PSUM_COUNT_RTOL} (counts) of one process at batch 2, max "
              f"|Δ| {psum_diff['float32']:.3g}; bf16: max |Δ| "
              f"{psum_diff['bfloat16']:.3g} (not held: cuBLAS's bf16 GEMMs "
              f"round a batch of 2 and of 4 clouds differently); fp32 acc@1 "
              f"equal (psum {psum_acc}, batch 2 {batch2_acc}), ranks bitwise"
              f" equal; streams: each rank's "
              f"8 streams bitwise equal to them run here as one stack, all 16"
              f" streams' acc@1 equal to run_streams_scan's on the 16 (states"
              f" bitwise {sweep_same}, max |Δ| {sweep_diff:.3g})")
        print(f"dist world 2 ({mode}) launches a rank: "
              + "; ".join(f"{m} {ranks[0][m]['launches']}"
                          for m in ("sharded", "psum")))
        print(f"dist world 2 ({mode}) psum: all-reduces "
              f"{tr['allreduce_host_ms']:.1f} ms of {tr['wall_ms']:.1f} ms "
              f"host time over 8 steps ({tr['allreduce_share']:.2%})")
        summary[f"launches_world2_{mode}"] = {
            m: ranks[0][m]["launches"] for m in ("sharded", "psum")}
    print(f"dist ms a step ({card}): " + ", ".join(
        f"{k} {v:.2f}" for k, v in ms.items()))
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"phase dist streams: {summary['seconds']:.1f} s")
    return launches, summary, {mode: [r["dp"] for r in ranks]
                               for mode, ranks in runs.items()}


def run_dp_pretraining(tmp: Path, card: str, inputs: dict,
                       dp_ranks: dict) -> tuple:
    """Phase 11b: the data-parallel train step on the card.

    (a) world 1 over NCCL: `make_dp_train_step` bitwise equal to
    `train_step` over 2 steps, Uni3D-L fp32 at full width and depth, batch
    16 (10,000-point clouds, a third of the image rows masked), traced for
    its launches.  (b) world 2 sharing the card over gloo (the ranks of
    `run_dist_streams`, depth 2, global batch 16): the loss and the
    gradient norm within DP_LOSS_RTOL of one process on the same batch,
    99% of the parameters after 2 steps within DP_PARAM_ATOL, the ranks
    bitwise equal; with two cards or more the same over NCCL.  (c) a two-rank
    `python -m torch.distributed.run -m uni_adapter_torch.cli.pretrain`
    (depth 2, 1024-point clouds) for 2 steps, then `--resume` to 4: rank 0 wrote the
    checkpoint, both ranks resumed from it (`start_dp_cli`, which the
    caller starts with the other phases' launches: `run_clis`).  Returns
    (the world-1 DP run's launches, summary)."""
    import torch
    import torch.distributed as dist

    from uni_adapter_torch import train
    from uni_adapter_torch.config import ModelConfig
    from uni_adapter_torch.models.uni3d import create_uni3d
    from uni_adapter_torch.parallel import mesh as pmesh

    t_phase = time.perf_counter()
    batch = {k: v.cuda() for k, v in inputs["batch"].items()}
    args = (batch["pc"], batch["text_embed"], batch["image_embed"],
            batch["mask"])
    cfg = ModelConfig(eva_depth=PRETRAIN_DEPTH, compute_dtype="float32")

    def fresh():
        model = create_uni3d(cfg, "cuda", torch.float32, seed=0,
                             trainable=True)
        tx = train.make_optimizer(lr=1e-4, total_steps=4, warmup_steps=1)
        return model, tx, train.init_train_state(model, tx)

    model, tx, state = fresh()
    ms = {"train_step": []}
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = train.train_step(model, tx, state, *args)
        torch.cuda.synchronize()
        ms["train_step"].append((time.perf_counter() - t0) * 1e3)
    want = train.TrainState({n: p.detach().clone() for n, p in
                             state.params.items()},
                            state.logit_scale.clone(), state.opt_state,
                            state.step)
    del model, state
    torch.cuda.empty_cache()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        model, tx, state = fresh()
        dp = train.make_dp_train_step(model, tx, pmesh.make_mesh())
        holder, times = [state], []

        def two_steps():
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                holder[0] = dp(holder[0], *args)[0]
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)

        _, launches, wrapper = traced_run(
            torch, "the DP train step (world 1, NCCL)", two_steps,
            ("fps_grid", "knn_gather", "eva_attn_block_fp32", "attn_f32_tc",
             "eva_attn_block_bwd"))
        ms["dp_world1"] = times
        assert_states_equal("DP train step at world 1 (NCCL) against "
                            "train_step, 2 steps, Uni3D-L fp32 depth 24",
                            holder[0], want)
        got = {k: wrapper[k] for k in PRETRAIN_PER_STEP}
        if got != {k: 2 * n for k, n in PRETRAIN_PER_STEP.items()}:
            fail(f"DP train step launches {got}, expected twice "
                 f"{PRETRAIN_PER_STEP}")
        print(f"DP train step world 1 launches (traced): "
              f"{ {k: launches[k] for k in PRETRAIN_PER_STEP} }; wrappers "
              f"{got}")
    finally:
        dist.destroy_process_group()
    del model, holder, want
    torch.cuda.empty_cache()

    ref = dp_depth2(torch, "cuda", inputs["batch"])
    ms["train_step_depth2"] = ref["ms"]
    summary = {"ms": ms}
    for mode, ranks in dp_ranks.items():
        for r, res in enumerate(ranks):
            for key in ("losses", "grad_norms"):
                for g, w in zip(res[key], ref[key]):
                    if abs(g - w) > DP_LOSS_RTOL * abs(w):
                        fail(f"DP world 2 ({mode}), rank {r}: {key} {res[key]}"
                             f" against one process's {ref[key]}")
            for name, p in res["params"].items():
                if not torch.equal(p, ranks[0]["params"][name]):
                    fail(f"DP world 2 ({mode}): the ranks' {name} differ")
        d = torch.cat([(p - ref["params"][n]).abs().flatten()
                       for n, p in ranks[0]["params"].items()])
        worst, above = float(d.max()), float((d > DP_PARAM_ATOL)
                                             .float().mean())
        tiny = float((d > 1e-4 * DP_LR).float().mean())
        print(f"DP world 2 ({mode}, depth 2, global batch 16): losses "
              f"{ranks[0]['losses']} (one process {ref['losses']}), gradient "
              f"norms {ranks[0]['grad_norms']} ({ref['grad_norms']}); "
              f"parameters after 2 steps ({d.numel()} coordinates): max |Δ| "
              f"{worst:.3g} ({worst / DP_LR:.3g}·lr), {above:.3%} above "
              f"{DP_PARAM_ATOL:.3g} (limit 1%), {tiny:.3%} above "
              f"{1e-4 * DP_LR:.3g}; ranks bitwise equal")
        if above > 0.01:
            fail(f"DP world 2 ({mode}): the parameters after two steps are "
                 f"not within the stated tolerance of one process's")
        ms[f"dp_world2_{mode}"] = ranks[0]["ms"]
        summary[f"world2_{mode}"] = {"losses": ranks[0]["losses"],
                                     "grad_norms": ranks[0]["grad_norms"],
                                     "param_max_diff": worst,
                                     "share_above_param_atol": above}
    summary["world1_depth2"] = {"losses": ref["losses"],
                                "grad_norms": ref["grad_norms"]}

    print(f"DP ms a step ({card}): " + "; ".join(
        f"{k} {[round(x, 1) for x in v]}" for k, v in ms.items()))
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"phase DP pretraining: {summary['seconds']:.1f} s")
    return launches, summary


def start_dp_cli(tmp: Path) -> dict:
    """Phase 11b (c) started: a two-rank `python -m torch.distributed.run
    -m uni_adapter_torch.cli.pretrain` (depth 2, 1024-point clouds) for 2
    steps, then `--resume` to 4, one after the other on a thread of their
    own.  `finish_dp_cli` waits for them and checks them."""
    import threading

    out = tmp / "pretrain_dp"
    cli = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "uni_adapter_torch.cli.pretrain",
           *[a if a != str(PRETRAIN_DEPTH) else "2" for a in PRETRAIN_ARGS],
           *write_corpus(tmp / "corpus_dp", n_points=1024), "--out",
           str(out)]
    repo = Path(__file__).resolve().parent
    runs = []

    def launch() -> None:
        for extra in (["--steps", "2", "--ckpt-every", "2"],
                      ["--steps", "4", "--resume"]):
            t0 = time.perf_counter()
            proc = run_cmd(cli + extra, cwd=repo, timeout=600)
            runs.append((proc, time.perf_counter() - t0))
            if proc.returncode != 0:
                return

    thread = threading.Thread(target=launch, daemon=True)
    thread.start()
    return {"out": out, "runs": runs, "thread": thread}


def finish_dp_cli(started: dict, torch) -> list:
    """Wait for `start_dp_cli`'s launches: each must exit 0, rank 0 must
    have written the checkpoint and both ranks resumed from it, with 4
    finite losses.  Returns each launch's seconds."""
    started["thread"].join()
    runs, out = started["runs"], started["out"]
    for proc, _ in runs:
        if proc.returncode != 0:
            fail(f"the two-rank pretraining run exited {proc.returncode}:\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    if len(runs) != 2:
        fail(f"the two-rank pretraining runs: {len(runs)} of 2 ended (a "
             f"launch overran its 600 s)")
    runs_s = [secs for _, secs in runs]
    log = (out / "pretrain.log").read_text()
    losses = logged_losses(out / "pretrain.log")
    # a card a rank takes NCCL; ranks that share one card, gloo
    backend, where = (("nccl", "a card each") if torch.cuda.device_count()
                      >= 2 else ("gloo", "sharing the card"))
    if ("resumed at train step 2" not in log or f"backend {backend}" not in
            log or len(losses) != 4 or not all(map(math.isfinite, losses))):
        fail(f"the two-rank pretraining run: losses {losses}, log tail "
             f"{log[-1500:]}")
    print(f"DP pretraining CLI, 2 ranks {where} over {backend} (depth 2,"
          f" batch 16): 2 steps + rank 0's checkpoint in {runs_s[0]:.1f} s, "
          f"both ranks resumed to step 4 in {runs_s[1]:.1f} s; losses "
          f"{losses}")
    return runs_s


def run_cross_class(tmp: Path, card: str) -> tuple:
    """Phase 11c: `python -m uni_adapter_torch.cli.cross_class` on the
    synthetic class set, Uni3D-L bf16 at full width and depth, severities
    1 and 2 (the figures only where matplotlib imports), traced: FPS, kNN
    and the (B, H, N, hd) attention launched, nothing else of the port's.
    Then the clean centroids of three classes (a cloud each) and their
    distance matrices on the card against the same model on the CPU, within
    MAP_ATOL, and the severity-1 t-SNE on the card against its CPU run
    from the same PCA init, within TSNE_REL of the embedding's scale.
    Returns (launches, summary)."""
    import numpy as np
    import torch

    from uni_adapter_torch.analysis import cross_class as X
    from uni_adapter_torch.cli import cross_class as cli
    from uni_adapter_torch.config import ModelConfig
    from uni_adapter_torch.models.loader import build_backbone
    from uni_adapter_torch.utils import tsne

    t_phase = time.perf_counter()
    out = tmp / "cross_class"
    t0 = time.perf_counter()
    res, launches, wrapper = traced_run(
        torch, "the cross-class analysis", lambda: cli.main(
            ["--out", str(out), "--device", "cuda", "--severities", "1", "2",
             "--max-per-class", "2"]), ("fps", "knn", "attention_heads"))
    run_s = time.perf_counter() - t0
    files = sorted(p.name for p in out.iterdir())
    need = {"centroids_clean.npy", "centroids_s1.npy", "centroids_s2.npy",
            "tsne_s1.npy", "tsne_s2.npy", "analysis.json", "analysis.log"}
    if not need <= set(files):
        fail(f"cross-class: files {files}")
    clean = res["clean"]
    embs = [res["severities"][s][3] for s in (1, 2)]
    if clean.shape != (6, 512) or not np.isfinite(clean).all() or any(
            e.shape != (6, 2, 2) or not np.isfinite(e).all() for e in embs):
        fail(f"cross-class: centroids {clean.shape}, embeddings "
             f"{[e.shape for e in embs]}")
    drawn = ("figures drawn" if res["figures"] else
             "matplotlib does not import here: figures not drawn")
    print(f"cross-class (Uni3D-L bf16, depth 24): {len(files)} files; "
          f"{drawn}; {run_s:.1f} s; launches (traced) "
          f"{ {k: launches[k] for k in ('fps', 'knn', 'attention_heads')} }, "
          f"wrappers { {k: wrapper[k] for k in ('fps', 'knn', 'attention_heads')} }")

    pcs, labels = X._subsample_per_class(*cli.synthetic_class_set(), 1)
    pcs, labels = pcs[labels < 3], labels[labels < 3]
    cents = {}
    for dev in ("cuda", "cpu"):
        model, g, m = build_backbone("uni3d", ModelConfig(), dev,
                                     seed=cli.WEIGHT_SEED)
        an = X.CrossClassAttentionAnalyzer(
            model, [f"class_{i}" for i in range(3)], num_group=g,
            group_size=m)
        t0 = time.perf_counter()
        cents[dev] = an.class_centroids(pcs, labels)
        print(f"cross-class clean centroids (3 clouds) on the {dev}: "
              f"{time.perf_counter() - t0:.1f} s")
        del model
    cent_err = float(np.abs(cents["cuda"] - cents["cpu"]).max())
    dists = [X._cosine_distance_matrix(cents[d]) for d in ("cuda", "cpu")]
    dist_err = float(np.abs(dists[0] - dists[1]).max())
    print(f"cross-class card vs CPU: centroids max |Δ| {cent_err:.3g}, "
          f"distances {dist_err:.3g} (tolerance {MAP_ATOL})")
    if cent_err > MAP_ATOL or dist_err > MAP_ATOL:
        fail("cross-class: the card's centroids or distances differ from "
             "the CPU's")
    joint = np.concatenate([clean, res["severities"][1][0]], 0)
    x = torch.from_numpy(joint)
    init = tsne.pca_init(x)
    emb = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        r = tsne.tsne(x.to(dev), perplexity=5, init=init.to(dev))
        emb[dev] = r["embedding"].cpu()
        print(f"t-SNE on the {dev}: {time.perf_counter() - t0:.2f} s, "
              f"{r['n_iter'] + 1} iterations, KL {r['kl_divergence']:.6f}")
    scale = float(emb["cpu"].abs().max())
    tsne_err = float((emb["cuda"] - emb["cpu"]).abs().max())
    print(f"t-SNE card vs CPU from the same init: max |Δ| {tsne_err:.3g} of "
          f"scale {scale:.3g} (tolerance {TSNE_REL} of the scale)")
    if tsne_err > TSNE_REL * scale:
        fail("cross-class: the t-SNE on the card differs from the CPU's")
    summary = {"run_s": run_s, "centroid_err": cent_err,
               "distance_err": dist_err, "tsne_err": tsne_err,
               "tsne_scale": scale,
               "seconds": time.perf_counter() - t_phase}
    print(f"phase cross-class: {summary['seconds']:.1f} s")
    return launches, summary


# ---- phase 12: class-sharded adaptation (parallel/ep.py) ------------------

#: tests/test_ep.py's tolerances: with residuals off the mixture within
#: rtol 1e-5, atol 1e-7 of the run it is held to.  The sharded residual
#: gradient within 1e-5 of the replicated gradient's largest entry
#: (tests/test_ep.py's 1e-5, taken relative: at K 1156 the entries are
#: about 1e-4, so an absolute 1e-5 would pass a gradient a tenth off),
#: which the gradient with its dx sum skipped must fail.  With residuals
#: on the trajectory is held as ROADMAP's "Trajectories" holds it: that
#: one gradient, and acc@1 equal; its distance from the plain scan is
#: printed beside tests/test_ep.py's envelope (residuals atol 1e-2, means
#: rtol 1e-3, atol 1e-4), which 16 steps at K 1156 on the card exceed in
#: a few elements (Adam moves an element whose gradient is near zero by
#: ±lr on a last-bit difference, 160 times; the medians stay near 1e-6),
#: and beside the distance of the plain scan with the classes permuted
#: (the same arithmetic, its sums over the classes in another order).
#: `shard_encoder` in fp32: atol 1e-6, since each rank encodes one cloud
#: where one process encodes two, and cuBLAS's fp32 GEMMs are not
#: batch-invariant in the last bits (the features of the two ways are
#: printed, in bf16 and fp32).
EP_RTOL, EP_ATOL = 1e-5, 1e-7
EP_RES_ATOL, EP_MU_RTOL, EP_MU_ATOL = 1e-2, 1e-3, 1e-4
EP_GRAD_REL = 1e-5
EP_SE_ATOL = 1e-6
#: tests/test_ep_{dota,gmm,adaptive,cache}.py's (rtol, atol) of the state
#: (plain DOTA's Λ, an ill-conditioned inverse, at rtol 2e-3, atol 1).
EP_METHOD_TOL = {"dota": (1e-4, 1e-5), "gmm": (1e-5, 1e-6),
                 "adaptive": (1e-4, 1e-5), "cache": (1e-5, 1e-6)}
EP_LAM_TOL = (2e-3, 1.0)
#: The K = 15 methods (ScanObjectNN's class count, padded to 16 over two
#: ranks): name -> DotaConfig overrides, cache overrides, shard_encoder.
EP_METHODS = {
    "mode_se": (dict(res_learning=False), {}, True),
    "mode_se_fp32": (dict(res_learning=False), {}, True),
    "dota": (dict(use_dota=True, use_mode_dota=False), {}, False),
    "gmm": (dict(use_gmm_dota=True, use_mode_dota=False), {}, False),
    "adaptive": (dict(use_adaptive_dota=True, use_mode_dota=False), {},
                 False),
    "cache_dense": (dict(use_mode_dota=False),
                    dict(graph_mode="dense", shot_capacity=3), False),
    "cache_prototype": (dict(use_mode_dota=False),
                        dict(graph_mode="prototype", shot_capacity=3),
                        False)}
#: The fields held per method, and those held exactly.
EP_FIELDS = {"mode": (("mu", "var", "pi", "c", "class_counts"), ("t",)),
             "dota": (("mu", "c", "sigma", "cum_soft_labels"),
                      ("prior_step",)),
             "gmm": (("mu", "sigma", "sigma_reg", "pi", "C", "class_counts"),
                     ("total_samples",)),
             "adaptive": (("mu", "var", "pi", "c", "class_counts"),
                          ("mask", "t", "fit_calls")),
             "cache": (("feats", "conf", "probs"), ("valid", "counts"))}
#: The EP kernels: rows 1, 2, 3, 6, 8 of PERF.md's table.
EP_KERNELS = ("fps", "knn", "eva_attn_block", "knn_gather", "fps_grid")


def ep_cfg(dota: dict = None, cache: dict = None, depth: int = 24,
           dataset: str = "modelnet", dtype: str = "bfloat16"):
    """Uni3D-L in `dtype` at depth `depth`, the DotaConfig defaults
    (MODE-DOTA with residuals at 'high') with `dota` over them."""
    from uni_adapter_torch.config import (CacheConfig, Config, DataConfig,
                                          DotaConfig, ModelConfig)

    return Config(model=ModelConfig(eva_depth=depth, compute_dtype=dtype),
                  dota=DotaConfig(**(dota or {})),
                  cache=CacheConfig(**(cache or {})),
                  data=DataConfig(dataset_name=dataset)).resolve()


def ep_method_cfg(name: str):
    """The configuration of an EP_METHODS entry: ScanObjectNN's table,
    fp32 where the name says so."""
    dota, cache, _ = EP_METHODS[name]
    return ep_cfg(dota, cache, dataset="scanobjectnn",
                  dtype="float32" if name.endswith("fp32") else "bfloat16")


def ep_kind(name: str) -> str:
    return ("mode" if name.startswith("mode") else
            "cache" if name.startswith("cache") else name)


def ep_inputs(torch, tmp: Path) -> dict:
    """Phase 12's streams and banks, numpy-seeded: 16 Objaverse-LVIS-like
    clouds of 10,000 points with a seeded (1156, 1024) bank, 16
    ScanObjectNN-like clouds of 1024 points with a seeded (15, 1024) bank,
    4 streams of 4 1024-point clouds for DP × EP (ModelNet40's bank)."""
    import numpy as np

    rng = np.random.default_rng(21)

    def spheres(*lead, n=1024):
        x = rng.standard_normal((*lead, n, 3)).astype(np.float32)
        x = 0.5 * x / np.linalg.norm(x, axis=-1, keepdims=True)
        return x * rng.uniform(0.6, 1.4, (*lead, 1, 3)).astype(np.float32)

    def bank(k):
        b = rng.standard_normal((k, 1024)).astype(np.float32)
        return torch.from_numpy(b / np.linalg.norm(b, axis=1, keepdims=True))

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    lvis, sonn, sweep = spheres(16, 1, n=10000), spheres(16, 1), \
        spheres(4, 4, 1)
    return {"lvis": (t(lvis), torch.ones(16, 1, 10000, 3),
                     torch.zeros(16, 1, dtype=torch.int64)),
            "sonn": (t(sonn), torch.ones(16, 1, 1024, 3),
                     torch.zeros(16, 1, dtype=torch.int64)),
            "sweep": (t(sweep), torch.ones(4, 4, 1, 1024, 3),
                      torch.zeros(4, 4, 1, dtype=torch.int64)),
            "bank_lvis": bank(1156), "bank_sonn": bank(15)}


def ep_state(state) -> dict:
    """A carry's tensors by field name ('res.residuals' for the
    residuals), on the CPU."""
    out = {n: getattr(state.method_state, n).cpu()
           for n in state.method_state._fields}
    if state.res_state is not None:
        out.update({f"res.{n}": getattr(state.res_state, n).cpu()
                    for n in state.res_state._fields})
    return out


def ep_diff(got: dict, want: dict, names) -> float:
    return max(float((got[n].double() - want[n].double()).abs().max())
               for n in names)


def ep_check(what: str, got: dict, want: dict, kind: str,
             tol=None, report=fail) -> float:
    """`got` within the method's tolerance of `want` (its exact fields
    equal), each miss passed to `report`; returns the largest
    difference."""
    import torch

    close, exact = EP_FIELDS[kind]
    rtol, atol = tol or EP_METHOD_TOL.get(kind, (EP_RTOL, EP_ATOL))
    for n in exact:
        if not torch.equal(got[n], want[n]):
            report(f"{what}: {n} differs")
    for n in close:
        if not torch.allclose(got[n], want[n], rtol=rtol, atol=atol):
            report(f"{what}: {n} max |Δ| {ep_diff(got, want, [n]):.3g} outside"
                 f" rtol {rtol}, atol {atol}")
    if kind == "dota" and not torch.allclose(got["lam"], want["lam"],
                                             rtol=EP_LAM_TOL[0],
                                             atol=EP_LAM_TOL[1]):
        report(f"{what}: lam outside rtol {EP_LAM_TOL[0]}, atol "
             f"{EP_LAM_TOL[1]}")
    return ep_diff(got, want, close)


def ep_segments(scan_fn) -> dict:
    """The captured segments of each program of a scan (by residual
    gate; the cache's head, iteration and tail)."""
    out = {}
    for runner in scan_fn.runners.values():
        for gate, program in runner.programs.items():
            out[str(gate)] = [len(getattr(p, "segments", [p]))
                              for p in program]
    return out


def ep_peak(torch, run):
    """run()'s result and the device memory it peaked at (GB) above what
    was allocated when it started."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e9, \
        torch.cuda.max_memory_allocated() / 1e9


def ep_rank(rank: int, world: int, tmp: str, port: int, mode: str) -> None:
    """One rank of phase 12's worlds of 2 and 4, started by
    `run_ep_world`: mode 'gloo', every rank on card 0 (the bootstrap
    picks gloo), or 'nccl', a card a rank; writes
    tmp/ep_rank{rank}_w{world}_{mode}.pt."""
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if mode == "gloo":
        os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    import torch
    import torch.distributed as dist

    from uni_adapter_torch import engine
    from uni_adapter_torch.anchors import load_precomputed
    from uni_adapter_torch.cli.tta import set_numerics
    from uni_adapter_torch.models.loader import build_backbone
    from uni_adapter_torch.parallel import collectives, ep, mesh as pmesh
    from uni_adapter_torch.parallel.bootstrap import init_distributed_device

    boot = init_distributed_device("cuda")
    set_numerics()
    try:
        inp = torch.load(Path(tmp) / "ep_inputs.pt", weights_only=False)
        out = {"backend": boot["backend"]}
        world_ = pmesh.make_mesh()
        if world == 4:
            cfg = ep_cfg(dict(res_learning=False), depth=2)
            model, _, _ = build_backbone("uni3d", cfg.model, "cuda", seed=0)
            text = load_precomputed("large", "modelnet").cuda()
            grid = ep.make_grid(2)
            state, summary = ep.run_streams_ep(cfg, model, text,
                                               *inp["sweep"], grid=grid,
                                               seed=42)
            out["dp_ep"] = {"summary": summary, "state": ep_state(state)}
            torch.save(out, Path(tmp) / f"ep_rank{rank}_w{world}_{mode}.pt")
            return
        model, _, _ = build_backbone("uni3d", ep_cfg().model, "cuda", seed=0)
        lvis = [a.cuda() for a in inp["lvis"]]
        sonn = [a.cuda() for a in inp["sonn"]]
        blvis, bsonn = inp["bank_lvis"].cuda(), inp["bank_sonn"].cuda()
        for name, dota in (("lvis_off", dict(res_learning=False)),
                           ("lvis_on", dict(residual_precision="high")),
                           ("lvis_highest",
                            dict(residual_precision="highest"))):
            cfg = ep_cfg(dota, dataset="objaverse_lvis")
            shard = ep.class_shard(world_, 1156)
            scan_fn = ep.make_ep_scan_fn(cfg, model, shard)
            counters = zeroed_counters()
            (state, summary), peak, _ = ep_peak(torch, lambda: ep.run_stream_ep(
                cfg, model, blvis, *lvis[:2], inp["targets"]["lvis"],
                seed=42, scan_fn=scan_fn))
            out[name] = {"state": ep_state(state), "summary": summary,
                         "ms": list(scan_fn.step_ms), "peak_gb": peak,
                         "segments": ep_segments(scan_fn),
                         "launches": {k: counters[k].launches
                                      for k in EP_KERNELS}}
        # one gradient of the sharded residual loop at K = 1156 ('highest')
        g = inp["grad"]
        shard = ep.class_shard(world_, 1156)
        rows = slice(shard.offset, shard.offset + shard.k_local)
        from uni_adapter_torch.adapt import mode_dota, residual
        mix = mode_dota.ModeDotaState(*(t.cuda()[rows] if t.dim() else
                                        t.cuda() for t in g["mixture"]))
        terms = residual.frozen_mixture_terms(mix, g["epsilon"])
        text_l = ep.pad_classes(blvis, shard.n)[0][rows]
        grads = engine.drive(ep.residual_gradient_sharded(
            g["residuals"].cuda()[rows], text_l, terms, shard, "highest"),
            shard.group)
        out["grad"] = grads.cpu()
        # the planted fault: the same parts with the dx sum not issued
        parts = ep.residual_gradient_sharded(
            g["residuals"].cuda()[rows], text_l, terms, shard, "highest")
        try:
            while True:
                req = next(parts)
                if req.kind != "sum":
                    collectives.issue(req, shard.group)
        except StopIteration as done:
            out["grad_fault"] = done.value.cpu()
        # the K = 15 methods on 1024-point clouds, and plain DOTA at 1156
        model32, _, _ = build_backbone(
            "uni3d", ep_cfg(dtype="float32").model, "cuda", seed=0)
        for name, (dota, cache, se) in EP_METHODS.items():
            cfg = ep_method_cfg(name)
            shard = ep.class_shard(world_, 15)
            m = model32 if cfg.model.compute_dtype == "float32" else model
            scan_fn = ep.make_ep_scan_fn(cfg, m, shard, se)
            counters = zeroed_counters()
            state, summary = ep.run_stream_ep(
                cfg, m, bsonn, *sonn[:2], inp["targets"][name], seed=42,
                shard_encoder=se, scan_fn=scan_fn)
            out[name] = {"state": ep_state(state), "summary": summary,
                         "ms": list(scan_fn.step_ms),
                         "segments": ep_segments(scan_fn),
                         "launches": {k: counters[k].launches
                                      for k in EP_KERNELS}}
        del model32
        torch.cuda.empty_cache()
        # plain DOTA at K = 1156: the steps' peak memory (the carry's block
        # and the scan's copy of it), then the gather of the full carry
        cfg = ep_cfg(dict(use_dota=True, use_mode_dota=False),
                     dataset="objaverse_lvis")
        shard = ep.class_shard(world_, 1156)
        scan_fn = ep.make_ep_scan_fn(cfg, model, shard)
        rows = slice(shard.offset, shard.offset + shard.k_local)
        st0 = ep.local_padded_state(cfg, blvis, shard, 42)
        (state, outs), peak, top = ep_peak(torch, lambda: scan_fn(
            ep.pad_classes(blvis, shard.n)[0][rows], st0, *sonn[:2],
            inp["targets"]["dota_lvis"].cuda()))
        del st0
        state = ep.gather_state(state, shard)
        out["dota_lvis"] = {"mu": state.method_state.mu.cpu(),
                            "acc1": 100.0 * outs.correct.sum(0)[0].item() / 16,
                            "ms": list(scan_fn.step_ms), "peak_gb": peak,
                            "top_gb": top}
        del state, scan_fn
        torch.cuda.empty_cache()
        out["serve"] = ep_serve_rank(torch, model, bsonn, sonn[0].cpu(),
                                     Path(tmp))
        torch.save(out, Path(tmp) / f"ep_rank{rank}_w{world}_{mode}.pt")
    finally:
        dist.barrier()
        dist.destroy_process_group()


def ep_serve_rank(torch, model, text, clouds, tmp: Path) -> dict:
    """`TTAServer(dist_mode='ep')` in a world of two: rank 0 serves two
    clients 4 ticks (a 16-cloud stream's first and second 4 clouds), a
    snapshot of one restored as a third client, one more tick; rank 1
    follows.  Then each client's stream through `run_stream_ep` (its
    logits).  Returns rank 0's ticks and the streams' logits."""
    from uni_adapter_torch import serve
    from uni_adapter_torch.parallel import ep

    cfg = ep_cfg(dict(res_learning=False), dataset="scanobjectnn")
    streams = [clouds[:5].numpy(), clouds[5:10].numpy()]
    srv = serve.TTAServer(cfg, model, text, seed=42, dist_mode="ep")
    out = {}
    if srv.primary:
        for cid in ("a", "b"):
            srv.register(cid)
        ticks = [srv.submit([(c, s[t], None) for c, s in
                             zip(("a", "b"), streams)]) for t in range(4)]
        path = str(tmp / "ep_snapshot")
        srv.snapshot("a", path)
        srv.restore("c", path)
        ticks.append(srv.submit([("a", streams[0][4], None),
                                 ("c", streams[0][4], None)]))
        srv.stop()
        out["ticks"] = ticks
    else:
        serve.follow(srv)
    for i, s in enumerate(streams):
        pcs = torch.from_numpy(s).cuda()
        _, _, outs = ep.run_stream_ep(
            cfg, model, text, pcs, torch.ones_like(pcs),
            torch.zeros(pcs.shape[:2], dtype=torch.int64, device="cuda"),
            seed=42 + i, return_outputs=True)
        out[f"stream{i}"] = outs.final_logits.cpu()
    return out


def run_ep_world(tmp: Path, world: int, mode: str = "gloo") -> list:
    """Phase 12's world of `world` ranks (`ep_rank`): over gloo on card 0,
    or over NCCL, a card a rank."""
    import torch
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    mp.start_processes(ep_rank, args=(world, str(tmp), free_port(), mode),
                       nprocs=world, join=True, start_method="spawn")
    print(f"ep world {world} ({mode}): all ranks done in "
          f"{time.perf_counter() - t0:.1f} s")
    return [torch.load(tmp / f"ep_rank{r}_w{world}_{mode}.pt",
                       weights_only=False) for r in range(world)]


def run_ep_cli(tmp: Path, torch) -> dict:
    """(d) the CLI and the HTTP server at world 2 over gloo on card 0
    (`start_ep_cli`, then `finish_ep_cli`):
    `python -m torch.distributed.run --nproc-per-node 2 -m
    uni_adapter_torch.cli.tta --dist-mode ep` with `--continual true` and
    with `--vmap-corruptions true` (15 corruptions of 2 clouds, Uni3D-L
    width, depth 2, residuals off), each results.json equal to the same
    run in this process without EP; then `cli.serve --dist-mode ep` on
    two ranks (rank 0 the HTTP front end), one client posting 3 clouds
    whose logits equal a replicated server's here, rank 0 interrupted,
    both ranks exiting 0."""
    return finish_ep_cli(start_ep_cli(tmp, torch))


def start_ep_cli(tmp: Path, torch) -> dict:
    """`run_ep_cli`'s data and labels written, its launches and servers
    started; what `finish_ep_cli` needs returned."""
    import os

    import numpy as np

    from uni_adapter_torch.config import CORRUPTIONS
    from uni_adapter_torch.models.loader import build_backbone

    root = tmp / "ep_cli_data"
    write_stream(root, 1024, 40, 2, CORRUPTIONS)
    common = ["--root", str(root), "--corruption", "all", "--eva-depth",
              "2", "--dota-res-learning", "false",
              "--precomputed-text-features", "large", "--name", "run"]
    # the labels: met by the sweep's first stream on its first cloud only
    # (the clouds the CLI reads, its weights: seed 42)
    from uni_adapter_torch import engine
    from uni_adapter_torch.anchors import load_precomputed
    from uni_adapter_torch.data.datasets import load_tta_dataset

    cfg = dataclasses.replace(ep_cfg(dict(res_learning=False), depth=2),
                              data=dataclasses.replace(
                                  ep_cfg().data, root=str(root)))
    stacks = [load_tta_dataset(dataclasses.replace(cfg, data=dataclasses
              .replace(cfg.data, corruption=c))).as_arrays(
                  1, npoints=1024, seed=42) for c in CORRUPTIONS]
    pcs, rgbs, tgts = (np.stack([s[i] for s in stacks]) for i in range(3))
    model, _, _ = build_backbone("uni3d", cfg.model, "cuda", seed=42)
    text40 = load_precomputed("large", "modelnet").cuda()
    _, outs = engine.run_streams_scan(cfg, model, text40, pcs, rgbs, tgts,
                                      seed=42)
    np.save(root / "label.npy", half_met(torch, outs.final_logits[:, 0, 0])
            .numpy().astype(np.int64))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0",
               PYTHONPATH=str(Path(__file__).resolve().parent))
    runs = (("continual", ["--continual", "true"]),
            ("vmap", ["--vmap-corruptions", "true"]))
    # every launch started first, this process's runs made meanwhile
    clis = {name: start_tta_cli(env, [*common, *flags, "--dist-mode", "ep",
                                      "--output-dir",
                                      str(tmp / f"ep_cli_{name}")],
                                tmp / f"ep_cli_{name}.log")
            for name, flags in runs}
    port = free_port()
    procs = start_servers(env, [
        "--port", str(port), "--gather-ms", "0", "--eva-depth", "2",
        "--dota-res-learning", "false", "--precomputed-text-features",
        "large", "--dist-mode", "ep", "--output-dir", str(tmp / "ep_serve")],
        tmp, "ep")
    return {"tmp": tmp, "root": root, "common": common, "runs": runs,
            "cfg": cfg, "model": model, "text40": text40, "clis": clis,
            "port": port, "procs": procs}


def finish_ep_cli(started: dict) -> dict:
    """`run_ep_cli`'s runs in this process, then its launches and servers
    (`start_ep_cli`) waited for and held to them."""
    import numpy as np

    from uni_adapter_torch.cli import tta
    from uni_adapter_torch.serve import TTAServer

    tmp, root, common, runs, cfg, model, text40, clis, port, procs = (
        started[k] for k in ("tmp", "root", "common", "runs", "cfg",
                             "model", "text40", "clis", "port", "procs"))
    wants = {name: tta.main([*common, *flags, "--output-dir",
                             str(tmp / f"ep_cli_{name}_base")])
             for name, flags in runs}
    clouds = np.load(root / "data_uniform_5.npy")
    clouds = np.concatenate([clouds, clouds[:1]])[:, None]
    ref = TTAServer(cfg, model, text40, seed=42)
    ref.register("x")
    want = [ref.submit([("x", c, None)])["x"] for c in clouds]
    out, secs = {}, {}
    for name, _ in runs:
        secs[name] = finish_process(f"ep CLI ({name})", clis[name],
                                    tmp / f"ep_cli_{name}.log")
        got = json.loads((tmp / f"ep_cli_{name}" / "run" / "results.json")
                         .read_text())
        if got != wants[name]["acc1"]:
            fail(f"ep CLI ({name}): results.json {got} against the run "
                 f"without EP {wants[name]['acc1']}")
        log = (tmp / f"ep_cli_{name}" / "run" / "out.log").read_text()
        if "dist mode ep" not in log:
            fail(f"ep CLI ({name}): out.log does not say it ran ep")
        out[name] = got
    # the HTTP server on two ranks
    logits, health = serve_requests("ep serve CLI", procs, port, clouds, tmp,
                                    "ep")
    diff = max(float(np.abs(a - b).max()) for a, b in zip(logits, want))
    if diff > 1e-3 or health["clients"] != 1 or health["sizes"] != [1]:
        fail(f"ep serve CLI: logits max |Δ| {diff:.3g} against a replicated "
             f"server, healthz {health}")
    print(f"ep CLI: --continual and --vmap-corruptions at world 2 wrote the "
          f"runs' results.json without EP ({secs['continual']:.1f} s, "
          f"{secs['vmap']:.1f} s with the launch); cli.serve --dist-mode ep:"
          f" 3 requests over HTTP, logits max |Δ| {diff:.3g} against a "
          f"replicated server, both ranks exited 0")
    return {"cli_s": secs, "serve_logits_max_abs_diff": diff}


def run_ep(tmp: Path, card: str, cli: bool = True) -> tuple:
    """Phase 12: class-sharded adaptation (`parallel/ep.py`).

    (a) world 1 over NCCL in this process: Uni3D-L bf16, full depth,
    16 10,000-point clouds, the seeded (1156, 1024) bank, MODE-DOTA,
    captured: with residuals off `run_stream_ep`'s state bitwise equal to
    `run_stream_scan`'s, acc@1 equal; with residuals on ('high') within
    the residual envelope; traced: FPS (fps_grid), kNN (knn_gather) and the
    block, no other kernel.  (b) world 2, two processes sharing the card
    over gloo: the same runs held to (a)'s plain scans (residuals off at
    EP_RTOL with acc@1 equal; on, at 'high' and 'highest', acc@1 equal,
    the distance printed beside tests/test_ep.py's envelope), one
    gradient of the sharded residual loop against the replicated one
    (EP_GRAD_REL; the dx sum skipped must fail it), each method at K = 15 (1024-point clouds, full depth;
    MODE-DOTA with `shard_encoder` in bf16 printed, in fp32 held) against
    its plain scan here, plain DOTA at K = 1156 with each rank's peak memory beside
    this process's, and `TTAServer(dist_mode='ep')` (two clients, a
    snapshot restored as a third) against each client's stream through
    `run_stream_ep`.  (c) world 4 over gloo: `run_streams_ep` on a 2 × 2
    grid, 4 streams of 4 clouds, depth 2, every stream's acc@1 equal to
    `run_streams_scan` here.  (d) the CLI and the HTTP server at world 2
    (`run_ep_cli`; left to the caller without `cli`).  With two cards or
    more, (b)'s checks run again over
    NCCL, a card a rank (the K 15 methods, K 1156 with residuals off and
    on, the gradient and its planted fault, plain DOTA's means).  Targets are met on half the clouds
    by the reference runs (`half_met`).  Prints ms a step, peak memory,
    segments and launches; returns (the traced world-1 run's launches,
    summary)."""
    import torch
    import torch.distributed as dist

    from uni_adapter_torch import engine
    from uni_adapter_torch.adapt import residual
    from uni_adapter_torch.anchors import load_precomputed
    from uni_adapter_torch.models.loader import build_backbone
    from uni_adapter_torch.parallel import ep
    from uni_adapter_torch.parallel import mesh as pmesh

    t_phase = time.perf_counter()
    times, problems = {}, []

    def bad(msg: str) -> None:
        print(f"ep check failed: {msg}")
        problems.append(msg)

    inp = ep_inputs(torch, tmp)
    model, _, _ = build_backbone("uni3d", ep_cfg().model, "cuda", seed=0)
    lvis = [a.cuda() for a in inp["lvis"]]
    sonn = [a.cuda() for a in inp["sonn"]]
    blvis, bsonn = inp["bank_lvis"].cuda(), inp["bank_sonn"].cuda()
    ms, targets, refs = {}, {}, {}

    # the plain scans (world 1, no process group): the references
    t0 = time.perf_counter()
    cfgs = {"lvis_off": ep_cfg(dict(res_learning=False),
                               dataset="objaverse_lvis"),
            "lvis_on": ep_cfg(dict(residual_precision="high"),
                              dataset="objaverse_lvis")}
    highest = ep_cfg(dict(residual_precision="highest"),
                     dataset="objaverse_lvis")
    for name, cfg in (*cfgs.items(), ("lvis_highest", highest)):
        scan_fn = engine.make_scan_fn(cfg, model)
        if name == "lvis_off":
            _, outs = engine.run_stream_scan(cfg, model, blvis, *lvis,
                                             seed=42, scan_fn=scan_fn)
            targets["lvis"] = half_met(torch, outs.final_logits).cuda()
        (state, outs), peak, _ = ep_peak(torch, lambda: engine.run_stream_scan(
            cfg, model, blvis, *lvis[:2], targets["lvis"], seed=42,
            scan_fn=scan_fn))
        refs[name] = (ep_state(state), engine.summarize(outs, 16), peak)
        ms[f"plain_{name}"] = statistics.median(scan_fn.step_ms[1:])
    # the witness of the residual drift's cause: the plain scan with the
    # classes permuted (bank rows and targets), its state permuted back
    perm = torch.randperm(1156, generator=torch.Generator().manual_seed(5))
    inv = torch.argsort(perm)
    drift = {}
    for name, cfg in (("high", cfgs["lvis_on"]), ("highest", highest)):
        state, _ = engine.run_stream_scan(
            cfg, model, blvis[perm.cuda()], *lvis[:2],
            inv.cuda()[targets["lvis"]], seed=42)
        st = {n: t[inv] if t.dim() else t
              for n, t in ep_state(state).items()}
        want = refs["lvis_on" if name == "high" else "lvis_highest"][0]
        drift[name] = {n: ep_diff(st, want, [n])
                       for n in ("res.residuals", "mu")}
    model32, _, _ = build_backbone("uni3d", ep_cfg(dtype="float32").model,
                                   "cuda", seed=0)
    for name in EP_METHODS:
        cfg = ep_method_cfg(name)
        m = model32 if cfg.model.compute_dtype == "float32" else model
        scan_fn = engine.make_scan_fn(cfg, m)
        _, outs = engine.run_stream_scan(cfg, m, bsonn, *sonn, seed=42,
                                         scan_fn=scan_fn)
        targets[name] = half_met(torch, outs.final_logits).cuda()
        state, outs = engine.run_stream_scan(cfg, m, bsonn, *sonn[:2],
                                             targets[name], seed=42,
                                             scan_fn=scan_fn)
        refs[name] = (ep_state(state), engine.summarize(outs, 16), None)
        ms[f"plain_{name}"] = statistics.median(scan_fn.step_ms[1:])
    # shard_encoder's split: each rank encodes one of MODE-DOTA's two
    # fused rows (a cloud and its noisy copy) where one process encodes
    # both
    pc = sonn[0][0]
    pcs2 = torch.cat([pc, pc + 0.05 * torch.randn(
        pc.shape, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(4))])
    rgbs2 = torch.ones_like(pcs2)
    enc_split = {}
    with torch.no_grad():
        for dtype, m in (("bfloat16", model), ("float32", model32)):
            encode = engine.encode_with("uni3d", m)
            both = encode(pcs2, rgbs2).float()
            alone = torch.cat([encode(pcs2[i:i + 1], rgbs2[i:i + 1])
                               for i in range(2)]).float()
            enc_split[dtype] = (float((both - alone).abs().max()),
                                float(both.abs().max()))
    del model32, scan_fn
    torch.cuda.empty_cache()
    cfg = ep_cfg(dict(use_dota=True, use_mode_dota=False),
                 dataset="objaverse_lvis")
    scan_fn = engine.make_scan_fn(cfg, model)
    _, outs = engine.run_stream_scan(cfg, model, blvis, *sonn, seed=42,
                                     scan_fn=scan_fn)
    targets["dota_lvis"] = half_met(torch, outs.final_logits).cuda()
    del scan_fn, outs
    torch.cuda.empty_cache()
    # the steps' peak memory: a fresh scan (its copy of the carry) from an
    # init made before
    scan_fn = engine.make_scan_fn(cfg, model)
    st0 = engine.init_state(cfg, blvis, 42)
    (state, outs), peak, top = ep_peak(torch, lambda: scan_fn(
        blvis, st0, *sonn[:2], targets["dota_lvis"]))
    refs["dota_lvis"] = (state.method_state.mu.cpu(),
                         engine.summarize(outs, 16), (peak, top))
    ms["plain_dota_lvis"] = statistics.median(scan_fn.step_ms[1:])
    del state, st0, scan_fn
    torch.cuda.empty_cache()
    # (c)'s reference: 4 streams of 4 clouds at depth 2, ModelNet40's bank
    cfg2 = ep_cfg(dict(res_learning=False), depth=2)
    m2, _, _ = build_backbone("uni3d", cfg2.model, "cuda", seed=0)
    text40 = load_precomputed("large", "modelnet").cuda()
    sweep = [a.cuda() for a in inp["sweep"]]
    _, outs = engine.run_streams_scan(cfg2, m2, text40, *sweep, seed=42)
    inp["sweep"] = (*inp["sweep"][:2], half_met(
        torch, outs.final_logits).transpose(0, 1).contiguous())
    _, outs = engine.run_streams_scan(cfg2, m2, text40, *inp["sweep"],
                                      seed=42)
    want_dp = [s["acc1"] for s in engine.summarize_streams(outs, 4)]
    del m2, outs
    # the residual gradient's reference: the res-on run's mixture, a
    # seeded residual
    on = refs["lvis_on"][0]
    mixture = tuple(on[n].cuda() for n in ("mu", "var", "pi", "c",
                                           "class_counts", "t"))
    gen = torch.Generator(device="cuda").manual_seed(3)
    res0 = 1e-3 * torch.randn(1156, 1024, device="cuda", generator=gen)
    from uni_adapter_torch.adapt import mode_dota
    terms = residual.frozen_mixture_terms(mode_dota.ModeDotaState(*mixture),
                                          cfgs["lvis_on"].dota.epsilon)
    with torch.enable_grad():
        r = res0.clone().requires_grad_(True)
        loss = residual._loss_from_terms(residual._normalize_rows(blvis + r),
                                         terms, "highest")
        (grad_ref,) = torch.autograd.grad(loss, r)
    times["references"] = time.perf_counter() - t0

    # (a) world 1 over NCCL
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    a = {}
    try:
        shard = ep.class_shard(pmesh.make_mesh(), 1156)
        for name, cfg in cfgs.items():
            scan_fn = ep.make_ep_scan_fn(cfg, model, shard)
            go = lambda: ep.run_stream_ep(  # noqa: E731
                cfg, model, blvis, *lvis[:2], targets["lvis"], seed=42,
                scan_fn=scan_fn)
            if name == "lvis_off":
                (state, summary), launches, wrapper = traced_run(
                    torch, "the EP stream (world 1, NCCL)", go,
                    ("fps_grid", "knn_gather", "eva_attn_block"))
                peak = None
            else:
                (state, summary), peak, _ = ep_peak(torch, go)
            a[name] = (ep_state(state), summary, peak,
                       ep_segments(scan_fn))
            ms[f"ep_world1_{name}"] = statistics.median(scan_fn.step_ms[1:])
    finally:
        dist.destroy_process_group()
    want, want_sum, _ = refs["lvis_off"]
    got, got_sum, _, seg = a["lvis_off"]
    same = all(torch.equal(got[k], want[k]) for k in want)
    if got_sum["acc1"] != want_sum["acc1"]:
        bad(f"ep world 1: acc@1 {got_sum['acc1']} against run_stream_scan's"
             f" {want_sum['acc1']}")
    d_off = ep_check("ep world 1, residuals off", got, want, "mode",
                     report=bad)
    print(f"ep world 1 (NCCL), K 1156, residuals off: state bitwise equal to "
          f"run_stream_scan's: {same} (max |Δ| {d_off:.3g}); acc@1 "
          f"{got_sum['acc1']} (scan {want_sum['acc1']}); segments a step "
          f"{seg}")
    if not same:
        bad("ep world 1: the state differs from run_stream_scan's")
    got, got_sum, peak_on, seg_on = a["lvis_on"]
    want, want_sum, peak_plain = refs["lvis_on"]
    ep_check("ep world 1, residuals on", got, want, "mode",
             (EP_MU_RTOL, EP_MU_ATOL), report=bad)
    d_res = ep_diff(got, want, ["res.residuals"])
    if d_res > EP_RES_ATOL:
        bad(f"ep world 1, residuals on: residuals max |Δ| {d_res:.3g}")
    print(f"ep world 1 (NCCL), K 1156, residuals on ('high'): residuals max "
          f"|Δ| {d_res:.3g} (≤ {EP_RES_ATOL}), acc@1 {got_sum['acc1']} "
          f"(scan {want_sum['acc1']}); peak {peak_on:.2f} GB (scan "
          f"{peak_plain:.2f}); segments a step {seg_on}")
    print(f"ep world 1 launches (traced): {launches}; wrappers "
          f"{ {k: wrapper[k] for k in EP_KERNELS} }")
    times["a"] = time.perf_counter() - t0

    # (b) and (c): the worlds of 2 and 4 over gloo
    t0 = time.perf_counter()
    torch.save({"lvis": inp["lvis"], "sonn": inp["sonn"],
                "sweep": inp["sweep"], "bank_lvis": inp["bank_lvis"],
                "bank_sonn": inp["bank_sonn"],
                "targets": {k: v.cpu() for k, v in targets.items()},
                "grad": {"mixture": tuple(t.cpu() for t in mixture),
                         "residuals": res0.cpu(),
                         "epsilon": cfgs["lvis_on"].dota.epsilon}},
               tmp / "ep_inputs.pt")
    del model
    torch.cuda.empty_cache()
    ranks = run_ep_world(tmp, 2)
    times["b"] = time.perf_counter() - t0
    summary = {"ms_a_step": ms, "segments": {}, "peak_gb": {},
               "launches": {}, "permuted_drift": drift,
               "encoder_split": enc_split}
    for r, res in enumerate(ranks):
        if res["backend"] != "gloo":
            bad(f"ep world 2: rank {r} runs {res['backend']}, not gloo")
        got = res["lvis_off"]
        d = ep_check(f"ep world 2 rank {r}, K 1156, residuals off",
                     got["state"], refs["lvis_off"][0], "mode", report=bad)
        if got["summary"]["acc1"] != refs["lvis_off"][1]["acc1"]:
            bad(f"ep world 2 rank {r}: acc@1 {got['summary']['acc1']} "
                 f"against {refs['lvis_off'][1]['acc1']}")
        print(f"ep world 2 rank {r} (gloo), K 1156: residuals off within "
              f"rtol {EP_RTOL}, atol {EP_ATOL} of the plain scan (max |Δ| "
              f"{d:.3g}), acc@1 {got['summary']['acc1']}; launches "
              f"{got['launches']}")
        for name in ("lvis_highest", "lvis_on"):
            got_on, (want_on, want_sum, _) = res[name], refs[name]
            d_res = ep_diff(got_on["state"], want_on, ["res.residuals"])
            d_mu = ep_diff(got_on["state"], want_on, ["mu"])
            acc = (got_on["summary"]["acc1"], want_sum["acc1"])
            dist_ = {}
            for n in ("res.residuals", "mu", "c"):
                dd = (got_on["state"][n] - want_on[n]).abs().flatten()
                dist_[n] = (dd.median().item(), dd.quantile(0.9).item()
                            if dd.numel() <= 16_000_000 else None)
            within = (d_res <= EP_RES_ATOL and torch.allclose(
                got_on["state"]["mu"], want_on["mu"], rtol=EP_MU_RTOL,
                atol=EP_MU_ATOL))
            print(f"ep world 2 rank {r}, K 1156, residuals on ({name}): "
                  f"residuals max |Δ| {d_res:.3g}, means max |Δ| {d_mu:.3g}"
                  f" (tests/test_ep.py's envelope: {within}), acc@1 "
                  f"{acc[0]} (scan {acc[1]}); |Δ| median / 90th pct "
                  f"{dist_}; peak {got_on['peak_gb']:.2f} GB; segments "
                  f"{got_on['segments']}")
            if acc[0] != acc[1]:
                bad(f"ep world 2 rank {r}, residuals on ({name}): acc@1 "
                    f"{acc[0]} against the plain scan's {acc[1]}")
    g_max = float(grad_ref.abs().max())

    def check_gradient(ranks: list, tag: str) -> dict:
        d_grad, d_fault = (float((torch.cat([res[k] for res in ranks])[:1156]
                                  - grad_ref.cpu()).abs().max())
                           for k in ("grad", "grad_fault"))
        if d_grad > EP_GRAD_REL * g_max:
            bad(f"ep world 2{tag}: the sharded residual gradient max |Δ| "
                f"{d_grad:.3g} > {EP_GRAD_REL} of |g| max {g_max:.3g}")
        if d_fault <= EP_GRAD_REL * g_max:
            bad(f"ep world 2{tag}: the gradient with its dx sum skipped "
                f"passes (max |Δ| {d_fault:.3g})")
        print(f"ep world 2{tag}: one gradient of the sharded residual loop at "
              f"K 1156 ('highest') max |Δ| {d_grad:.3g} from the replicated "
              f"one, {d_grad / g_max:.3g} of |g| max {g_max:.4g} (tolerance "
              f"{EP_GRAD_REL}); the planted fault (the dx sum skipped) max "
              f"|Δ| {d_fault:.3g}, {d_fault / g_max:.3g} of it")
        return {"max_abs": d_grad, "g_max": g_max, "fault_max_abs": d_fault}

    summary["gradient"] = check_gradient(ranks, "")
    print(f"ep witness: the plain scan with the classes permuted, K 1156, "
          f"residuals on, from the unpermuted scan: {drift}")
    print(f"ep witness: shard_encoder's split, two clouds encoded together "
          f"against each alone (features max |Δ|, |feature| max): "
          f"{enc_split}")
    for name in EP_METHODS:
        kind = ep_kind(name)
        for r, res in enumerate(ranks):
            got = res[name]
            # bf16 with the encoder's batch split: cuBLAS's bf16 GEMMs and
            # the block's attention shape change with the rows a rank
            # encodes (one cloud, not two), so the state is printed, not
            # held; fp32 holds it
            d = ep_check(f"ep world 2 rank {r}, {name}", got["state"],
                         refs[name][0], kind,
                         (EP_RTOL, EP_SE_ATOL) if name == "mode_se_fp32"
                         else None,
                         report=print if name == "mode_se" else bad)
            if got["summary"]["acc1"] != refs[name][1]["acc1"]:
                bad(f"ep world 2 rank {r}, {name}: acc@1 "
                     f"{got['summary']['acc1']} against "
                     f"{refs[name][1]['acc1']}")
        if kind == "cache" and float(got["state"]["counts"].max()) < 2:
            bad(f"ep world 2, {name}: the cache never merged")
        ms[f"ep_world2_{name}"] = statistics.median(got["ms"][1:])
        summary["segments"][name] = got["segments"]
        summary["launches"][name] = got["launches"]
        print(f"ep world 2, K 15 {name}: max |Δ| {d:.3g} from the plain "
              f"scan, acc@1 {got['summary']['acc1']}, pad rows "
              f"{got['summary']['padded_classes']}; segments "
              f"{got['segments']}; launches {got['launches']}")
    dl = [res["dota_lvis"] for res in ranks]
    d = max(float((x["mu"] - refs["dota_lvis"][0]).abs().max()) for x in dl)
    if not all(torch.allclose(x["mu"], refs["dota_lvis"][0], rtol=1e-4,
                              atol=1e-5) for x in dl):
        bad(f"ep world 2, plain DOTA at K 1156: means max |Δ| {d:.3g}")
    if any(x["acc1"] != refs["dota_lvis"][1]["acc1"] for x in dl):
        bad(f"ep world 2, plain DOTA at K 1156: acc@1 "
             f"{[x['acc1'] for x in dl]} against "
             f"{refs['dota_lvis'][1]['acc1']}")
    peak_plain, top_plain = refs["dota_lvis"][2]
    print(f"ep world 2, plain DOTA K 1156: means max |Δ| {d:.3g}; peak above "
          f"the start a rank {[round(x['peak_gb'], 3) for x in dl]} GB, "
          f"one process {peak_plain:.3f} GB ({card})")
    summary["peak_gb"] = {"dota_lvis_world1": peak_plain,
                          "dota_lvis_world2": [x["peak_gb"] for x in dl],
                          "mode_res_lvis_world1": refs["lvis_on"][2],
                          "mode_res_lvis_world2": [
                              res["lvis_on"]["peak_gb"] for res in ranks]}
    ms["ep_world2_lvis_off"] = statistics.median(
        ranks[0]["lvis_off"]["ms"][1:])
    ms["ep_world2_lvis_on"] = statistics.median(ranks[0]["lvis_on"]["ms"][1:])
    ms["ep_world2_dota_lvis"] = statistics.median(dl[0]["ms"][1:])
    summary["segments"]["lvis_off_world1"] = a["lvis_off"][3]
    summary["segments"]["lvis_on_world1"] = a["lvis_on"][3]
    summary["segments"]["lvis_on_world2"] = ranks[0]["lvis_on"]["segments"]
    summary["launches"]["lvis_world2"] = ranks[0]["lvis_off"]["launches"]
    sv = ranks[0]["serve"]
    worst = 0.0
    for t in range(4):
        for i, cid in enumerate("ab"):
            worst = max(worst, float(abs(torch.from_numpy(
                sv["ticks"][t][cid]) - sv[f"stream{i}"][t]).max()))
    last = sv["ticks"][4]
    if worst > 1e-3 or not (last["a"] == last["c"]).all():
        bad(f"ep serving: logits max |Δ| {worst:.3g} from the streams' "
             f"run_stream_ep, or the restored client differs")
    print(f"ep serving (world 2): two clients' logits max |Δ| {worst:.3g} "
          f"from their streams through run_stream_ep; the client restored "
          f"from a snapshot equal to its source's")

    if torch.cuda.device_count() >= 2:
        nccl = run_ep_world(tmp, 2, "nccl")
        for r, res in enumerate(nccl):
            if res["backend"] != "nccl":
                bad(f"ep world 2 (nccl): rank {r} runs {res['backend']}")
            for name in EP_METHODS:
                ep_check(f"ep world 2 (nccl) rank {r}, {name}",
                         res[name]["state"], refs[name][0], ep_kind(name),
                         (EP_RTOL, EP_SE_ATOL) if name == "mode_se_fp32"
                         else None,
                         report=print if name == "mode_se" else bad)
            # K 1156: MODE-DOTA as over gloo, plain DOTA's means
            ep_check(f"ep world 2 (nccl) rank {r}, K 1156, residuals off",
                     res["lvis_off"]["state"], refs["lvis_off"][0], "mode",
                     report=bad)
            for name in ("lvis_off", "lvis_on", "lvis_highest"):
                if res[name]["summary"]["acc1"] != refs[name][1]["acc1"]:
                    bad(f"ep world 2 (nccl) rank {r}, {name}: acc@1 "
                        f"{res[name]['summary']['acc1']} against "
                        f"{refs[name][1]['acc1']}")
            if not torch.allclose(res["dota_lvis"]["mu"], refs["dota_lvis"][0],
                                  rtol=1e-4, atol=1e-5):
                bad(f"ep world 2 (nccl) rank {r}, plain DOTA at K 1156: "
                    f"means outside rtol 1e-4, atol 1e-5")
        summary["gradient_nccl"] = check_gradient(nccl, " (nccl)")
        r0 = nccl[0]
        nms = {k: statistics.median(r0[k]["ms"][1:])
               for k in ("lvis_off", "lvis_on", "lvis_highest", "dota_lvis",
                         *EP_METHODS)}
        summary["ms_world2_nccl"] = nms
        print(f"ep world 2 over NCCL (a card a rank): every K 15 method and "
              f"K 1156 within tolerance of its plain scan; ms a step ({card}): "
              + ", ".join(f"{k} {v:.2f}" for k, v in nms.items())
              + f"; plain DOTA K 1156 peak a rank "
              f"{r0['dota_lvis']['peak_gb']:.3f} GB")
    else:
        print("ep world 2 over NCCL: not run, this machine has one card "
              "(the two ranks shared it over gloo)")

    # (c) DP × EP on a 2 × 2 grid
    t0 = time.perf_counter()
    ranks4 = run_ep_world(tmp, 4)
    for r, res in enumerate(ranks4):
        got = res["dp_ep"]["summary"]["acc1_per_stream"]
        if got != want_dp:
            bad(f"ep DP × EP rank {r}: acc@1 per stream {got} against "
                 f"run_streams_scan's {want_dp}")
    print(f"ep DP × EP (2 × 2 grid, gloo): every stream's acc@1 equal to "
          f"run_streams_scan's on every rank ({want_dp})")
    times["c"] = time.perf_counter() - t0

    # (d) the CLI and the HTTP server at world 2 (without `cli`, the
    # caller's: `run_clis`)
    if cli:
        t0 = time.perf_counter()
        summary["cli"] = run_ep_cli(tmp, torch)
        times["d"] = time.perf_counter() - t0
    summary["seconds"] = time.perf_counter() - t_phase
    summary["part_seconds"] = times
    print(f"ep ms a step ({card}): " + ", ".join(
        f"{k} {v:.2f}" for k, v in ms.items()))
    print(f"phase ep: {summary['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in times.items()) + ")")
    if problems:
        fail(f"phase ep: {len(problems)} checks failed: "
             + "; ".join(problems))
    return launches, summary


# ---- phase 13: the tensor-parallel trunk (parallel/tp.py) -----------------

#: Phase 13's tolerances.  bf16: each cloud's features within cosine
#: TP_COS_BF16 of one process's (the ranks' partial sums are summed in
#: fp32 and rounded once, one process's rounding points, but bf16
#: roundings upstream of a sum flip with its order and 24 blocks carry
#: them on); fp32 (the block's fp32 entry): cosine TP_COS_F32, the
#: MODE-DOTA trajectory's logits within TP_LOGITS (rtol and atol) with
#: acc@1 equal, as tests/test_tp.py's trajectory; EP × TP (fp32) the
#: state within tests/test_ep.py's EP × TP rtol 2e-4, atol 2e-5.  The two
#: planted faults (`bo` added on every rank, one `fc2` sum skipped) must
#: each take some cloud's fp32 features outside TP_COS_F32.
TP_COS_BF16 = 0.99
TP_COS_F32 = 1 - 1e-4
TP_LOGITS = 1e-4
TP_EP_RTOL, TP_EP_ATOL = 2e-4, 2e-5
#: Steps of the fp32 trajectory and of the EP × TP stream; clouds whose
#: features are compared (and steps timed for the all-reduces' share):
#: over gloo on one card a forward of 16 clouds moves 2.4 GB (bf16 model,
#: fp32 partial sums) through the host a rank.
TP_FP32_STEPS = 8
TP_CLOUDS = 4
#: The TP paths' kernels on 1024-point clouds: rows 1, 2 and 3.
TP_KERNELS = ("fps", "knn", "eva_attn_block")


def tp_cfg(dtype: str = "bfloat16", depth: int = 24, dota=None):
    """Uni3D-L at published width, `depth` blocks, in `dtype`, MODE-DOTA
    (with residual learning unless `dota` says otherwise), the trunk
    tensor-parallel."""
    from uni_adapter_torch.config import (Config, DotaConfig, ModelConfig,
                                          RunConfig)

    return Config(model=ModelConfig(compute_dtype=dtype, eva_depth=depth),
                  dota=DotaConfig(**(dota or {})),
                  run=RunConfig(trunk_parallel="tp"))


def tp_model(torch, cfg, kind: str = "uni3d"):
    """The backbone of `cfg` from seed 0 on the card, its Dense biases
    drawn normal(0, 0.1) from a seeded generator: flax's zero biases would
    hide a bias added on every rank (a planted fault)."""
    from uni_adapter_torch.models.common import Dense
    from uni_adapter_torch.models.loader import build_backbone

    model, _, _ = build_backbone(kind, cfg.model, "cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(11)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Dense) and m.bias is not None:
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen,
                                               device="cuda"))
    return model


def tp_backbone_cfg(kind: str):
    """ULIP-2 or OpenShape-G at published widths and depths, bf16, the
    trunk tensor-parallel."""
    from uni_adapter_torch.config import Config, ModelConfig, RunConfig

    return Config(model=ModelConfig(vlm3d=kind),
                  run=RunConfig(trunk_parallel="tp"))


def tp_inputs(torch) -> dict:
    """Phase 13's clouds and banks, numpy-seeded: 16 1024-point clouds on
    spheres (batch 1), ModelNet40's bank, a seeded (15, 1024) bank for
    EP × TP."""
    import numpy as np

    from uni_adapter_torch.anchors import load_precomputed

    rng = np.random.default_rng(22)
    x = rng.standard_normal((16, 1, 1024, 3)).astype(np.float32)
    x = 0.5 * x / np.linalg.norm(x, axis=-1, keepdims=True)
    x *= rng.uniform(0.6, 1.4, (16, 1, 1, 3)).astype(np.float32)
    b = rng.standard_normal((15, 1024)).astype(np.float32)
    return {"pcs": torch.from_numpy(x), "rgbs": torch.ones(16, 1, 1024, 3),
            "bank": load_precomputed("large", "modelnet").float(),
            "bank15": torch.from_numpy(b / np.linalg.norm(b, axis=1,
                                                          keepdims=True))}


def tp_features(torch, encode, pcs, rgbs):
    """The features of the (TP_CLOUDS, 1024) clouds through `encode` (a
    plain encoder or a parts one, its collectives issued), fp32 on the
    CPU."""
    from uni_adapter_torch import engine

    with torch.no_grad():
        feat = engine.drive(engine.encoded(encode, pcs, rgbs), None)
    return feat.float().cpu()


def tp_min_cos(got, want) -> float:
    import torch.nn.functional as F

    return float(F.cosine_similarity(got.double(), want.double(), -1).min())


def tp_fault_bo(torch, encode, pcs, rgbs):
    """The planted fault 'bo added on every rank': the head shards' partial
    sums biased before the sum (each rank adds the out projection's bias),
    the forward otherwise the same."""
    from uni_adapter_torch.models import common
    from uni_adapter_torch.parallel.collectives import Collective

    def parts(self, x):
        if self.tp_group is None:
            return self(x)
        part = self._block(x, None) + self.proj.bias
        yield Collective("sum", part, group=self.tp_group)
        return part.to(x.dtype)

    saved = common.EvaAttention.parts
    common.EvaAttention.parts = parts
    try:
        return tp_features(torch, encode, pcs, rgbs)
    finally:
        common.EvaAttention.parts = saved


def tp_fault_fc2(torch, encode, pcs, rgbs):
    """The planted fault 'one fc2 sum skipped': the third collective of
    the forward (block 0's `fc2` partial product) not issued."""
    from uni_adapter_torch.parallel import collectives

    parts, i = encode(pcs, rgbs), 0
    with torch.no_grad():
        try:
            while True:
                req = next(parts)
                if i != 2:
                    collectives.issue(req, None)
                i += 1
        except StopIteration as done:
            return done.value.float().cpu()


def tp_rank(rank: int, world: int, tmp: str, port: int, mode: str) -> None:
    """One rank of phase 13's worlds of 2 and 4, started by `run_tp_world`:
    mode 'gloo', every rank on card 0 (the bootstrap picks gloo), or
    'nccl', a card a rank; writes tmp/tp_rank{rank}_w{world}_{mode}.pt."""
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if mode == "gloo":
        os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    import torch
    import torch.distributed as dist

    from uni_adapter_torch import engine
    from uni_adapter_torch.cli.tta import set_numerics
    from uni_adapter_torch.ops import attention
    from uni_adapter_torch.parallel import ep, tp, trunk
    from uni_adapter_torch.parallel.bootstrap import init_distributed_device

    boot = init_distributed_device("cuda")
    set_numerics()
    try:
        inp = torch.load(Path(tmp) / "tp_inputs.pt", weights_only=False)
        out = {"backend": boot["backend"]}
        pcs, rgbs = inp["pcs"].cuda(), inp["rgbs"].cuda()
        flat = (pcs[:TP_CLOUDS, 0], rgbs[:TP_CLOUDS, 0])
        if world == 4:
            cfg = tp_cfg("float32", depth=2, dota=dict(res_learning=False))
            model = tp_model(torch, cfg)
            try:
                trunk.prepare_trunk_parallel(tp_cfg(depth=2), model)
                out["indivisible"] = None
            except ValueError as e:
                out["indivisible"] = str(e)
            # EP × TP: (classes, model) = (2, 2)
            grid = tp.make_tp_grid(2)
            rank_model, encode = tp.make_tp_encode_fn(
                model, grid.model_group, "uni3d")
            counters = zeroed_counters()
            state, summary = ep.run_stream_ep(
                cfg, rank_model, inp["bank15"].cuda(),
                pcs[:TP_FP32_STEPS], rgbs[:TP_FP32_STEPS],
                inp["targets_ep"].cuda(), mesh=grid.outer_world, seed=42,
                encode_fn=encode)
            out["ep_tp"] = {"state": ep_state(state), "summary": summary,
                            "grid": tuple(grid[:4]),
                            "launches": {k: c.launches for k, c in
                                         counters.items() if c.launches}}
            if mode == "nccl":
                c = tp_backbone_cfg("openshape")
                _, encode = trunk.prepare_trunk_parallel(
                    c, tp_model(torch, c, "openshape"))
                out["openshape"] = tp_features(torch, encode, *flat)
            # phase 14's PP × TP and phase 15's SP × DP, in this world
            # (one spawn for all three)
            out.update(pp_tp_rank(torch, flat))
            out.update(sp_dp_rank(torch, flat))
            torch.save(out, Path(tmp) / f"tp_rank{rank}_w{world}_{mode}.pt")
            return
        # Uni3D-L bf16: features, the traced captured stream, its timing
        cfg = tp_cfg()
        model, encode = trunk.prepare_trunk_parallel(cfg, tp_model(torch,
                                                                   cfg))
        out["uni3d"] = tp_features(torch, encode, *flat)
        scan_fn = engine.make_scan_fn(cfg, model, encode_fn=encode)
        attention.eva_attn_block.head_shard_launches = 0
        go = lambda: engine.run_stream_scan(  # noqa: E731
            cfg, model, inp["bank"].cuda(), pcs, rgbs,
            inp["targets"].cuda(), seed=42, scan_fn=scan_fn)
        (state, outs), launches, wrapper = traced_run(
            torch, f"the TP stream (world {world}, {mode})", go, TP_KERNELS)
        out["stream"] = {"state": engine_tensors(state),
                         "acc1": engine.summarize(outs, 16)["acc1"],
                         "ms": list(scan_fn.step_ms),
                         "launches": launches,
                         "head_shard_launches":
                             attention.eva_attn_block.head_shard_launches,
                         "wrapper": wrapper["eva_attn_block"],
                         "segments": ep_segments(scan_fn)}
        out["allreduce"] = allreduce_share(torch, lambda: (
            engine.run_stream_scan(
                cfg, model, inp["bank"].cuda(), pcs[:TP_CLOUDS],
                rgbs[:TP_CLOUDS], inp["targets"][:TP_CLOUDS].cuda(),
                seed=42, scan_fn=scan_fn)))
        del model, encode, scan_fn, state, outs
        torch.cuda.empty_cache()
        # Uni3D-L fp32 (row 3f): features, the trajectory, the faults
        cfg = tp_cfg("float32")
        model, encode = trunk.prepare_trunk_parallel(cfg, tp_model(torch,
                                                                   cfg))
        out["uni3d_fp32"] = tp_features(torch, encode, *flat)
        attention.eva_attn_block_fp32_cuda.head_shard_launches = 0
        state, outs = engine.run_stream_scan(
            cfg, model, inp["bank"].cuda(), pcs[:TP_FP32_STEPS],
            rgbs[:TP_FP32_STEPS], inp["targets_fp32"].cuda(), seed=42,
            scan_fn=engine.make_scan_fn(cfg, model, encode_fn=encode))
        out["trajectory"] = {
            "final_logits": outs.final_logits.cpu(),
            "acc1": engine.summarize(outs, TP_FP32_STEPS)["acc1"],
            "head_shard_launches":
                attention.eva_attn_block_fp32_cuda.head_shard_launches}
        out["fault_bo"] = tp_fault_bo(torch, encode, *flat)
        out["fault_fc2"] = tp_fault_fc2(torch, encode, *flat)
        del model, encode, state, outs
        torch.cuda.empty_cache()
        # OpenShape-G and ULIP-2 (rows 4 and 5 / 2 on the rank's heads)
        for kind in ("openshape", "ulip"):
            c = tp_backbone_cfg(kind)
            model, encode = trunk.prepare_trunk_parallel(
                c, tp_model(torch, c, kind))
            counters = zeroed_counters()
            out[kind] = tp_features(torch, encode, *flat)
            out[f"{kind}_launches"] = {k: n.launches
                                       for k, n in counters.items()
                                       if n.launches}
            del model, encode
            torch.cuda.empty_cache()
        torch.save(out, Path(tmp) / f"tp_rank{rank}_w{world}_{mode}.pt")
    finally:
        dist.barrier()
        dist.destroy_process_group()


def run_tp_world(tmp: Path, world: int, mode: str = "gloo") -> list:
    """Phase 13's world of `world` ranks (`tp_rank`): over gloo on card 0,
    or over NCCL, a card a rank."""
    import torch
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    mp.start_processes(tp_rank, args=(world, str(tmp), free_port(), mode),
                       nprocs=world, join=True, start_method="spawn")
    print(f"tp world {world} ({mode}): all ranks done in "
          f"{time.perf_counter() - t0:.1f} s")
    return [torch.load(tmp / f"tp_rank{r}_w{world}_{mode}.pt",
                       weights_only=False) for r in range(world)]


#: What rank 0's out.log says of each trunk mode at world 2.
TRUNK_LOG = {"tp": "trunk parallelism: tensor (Megatron), 2-way",
             "pp": "trunk parallelism: pipeline, 2 stages x 1 chunks/stage",
             "sp": "trunk parallelism: sequence (ring attention), 2-way"}


def start_tta_cli(env: dict, args: list, log: Path):
    """`python -m torch.distributed.run --standalone --nproc-per-node 2 -m
    uni_adapter_torch.cli.tta ARGS` started, its output into `log`:
    (process, start time)."""
    with open(log, "w") as out:
        proc = spawn(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "uni_adapter_torch.cli.tta",
             *args], env=env, stdout=out, stderr=subprocess.STDOUT)
    return proc, time.perf_counter()


def finish_process(what: str, started, log: Path,
                   timeout: float = 300) -> float:
    """Wait for a process of `start_tta_cli`; fail with the end of its log
    if it exits non-zero.  Returns its seconds from the start."""
    proc, t0 = started
    try:
        code = proc.wait(timeout=timeout)
    finally:
        stop_process(proc)
    if code:
        fail(f"{what}: exit {code}\n{log.read_text()[-4000:]}")
    return time.perf_counter() - t0


def start_servers(env: dict, argv: list, tmp: Path, tag: str) -> list:
    """`python -m uni_adapter_torch.cli.serve ARGV` on two ranks (rank 0
    the HTTP front end), each one's output into tmp/{tag}_serve{r}.log."""
    mport = free_port()
    procs = []
    for r in range(2):
        with open(tmp / f"{tag}_serve{r}.log", "w") as out:
            procs.append(spawn(
                [sys.executable, "-m", "uni_adapter_torch.cli.serve", *argv],
                env=dict(env, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                         LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                         MASTER_PORT=str(mport)),
                stdout=out, stderr=subprocess.STDOUT))
    return procs


def serve_requests(what: str, procs: list, port: int, clouds, tmp: Path,
                   tag: str) -> tuple:
    """One client registered on the server of `start_servers` (waiting up
    to 180 s for it to come up, and failing at once if a rank exits
    first), posting `clouds`; then rank 0 interrupted and both ranks'
    exit codes read (both must be 0).  Returns (logits, healthz)."""
    from uni_adapter_torch.client import TTAClient

    def logs() -> str:
        return "\n".join((tmp / f"{tag}_serve{r}.log").read_text()[-2000:]
                         for r in range(2))

    try:
        t0 = time.perf_counter()
        client = TTAClient("127.0.0.1", port, "x", timeout=60.0)
        while True:
            try:
                client.register()
                break
            except OSError as e:
                codes = [p.poll() for p in procs]
                if codes != [None, None]:
                    fail(f"{what}: a rank exited ({codes}) before the "
                         f"server answered\n{logs()}")
                if time.perf_counter() - t0 > 180:
                    fail(f"{what}: no answer to /register in "
                         f"{time.perf_counter() - t0:.0f} s ({e!r})\n"
                         f"{logs()}")
                time.sleep(1.0)
        client.timeout = 300.0
        logits = [client.submit(c) for c in clouds]
        health = client.healthz()
        procs[0].send_signal(signal.SIGINT)
        codes = [p.wait(timeout=60) for p in procs]
    finally:
        for p in procs:
            stop_process(p)
    if codes != [0, 0]:
        fail(f"{what}: exit codes {codes}\n{logs()}")
    return logits, health


def run_tp_cli(tmp: Path, torch, modes=("tp",)) -> dict:
    """The CLI and the HTTP server at world 2 over gloo on card 0, for each
    trunk mode of `modes` (tp, pp, sp) at once: `python -m
    torch.distributed.run --nproc-per-node 2 -m uni_adapter_torch.cli.tta
    --trunk-parallel MODE` (Uni3D-L width, depth 2, fp32, residuals off,
    16 clouds) writing the results.json of the same run in this process
    without it; and `cli.serve --trunk-parallel MODE` on two ranks (rank
    0 the HTTP front end), one client posting 3 clouds whose logits are
    within 1e-3 of a replicated server's here, rank 0 interrupted, both
    ranks exiting 0.  Every launch is started first and the runs in this
    process made while they start.  Returns {mode: summary}."""
    import os

    import numpy as np

    from uni_adapter_torch.anchors import load_precomputed
    from uni_adapter_torch.cli import tta
    from uni_adapter_torch.models.loader import build_backbone
    from uni_adapter_torch.serve import TTAServer

    root = tmp / "trunk_cli_data"
    write_stream(root, 1024, 40)
    common = ["--root", str(root), "--corruption", "uniform", "--eva-depth",
              "2", "--compute-dtype", "float32", "--dota-res-learning",
              "false", "--precomputed-text-features", "large", "--name",
              "run"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0",
               PYTHONPATH=str(Path(__file__).resolve().parent))
    clis, servers = {}, {}
    for mode in modes:
        clis[mode] = start_tta_cli(
            env, [*common, "--trunk-parallel", mode, "--output-dir",
                  str(tmp / f"{mode}_cli")], tmp / f"{mode}_cli.log")
        port = free_port()
        servers[mode] = port, start_servers(env, [
            "--port", str(port), "--gather-ms", "0", "--eva-depth", "2",
            "--compute-dtype", "float32", "--dota-res-learning", "false",
            "--precomputed-text-features", "large", "--trunk-parallel",
            mode, "--output-dir", str(tmp / f"{mode}_serve")], tmp, mode)
    want = tta.main([*common, "--output-dir", str(tmp / "trunk_cli_base")])
    cfg = tp_cfg("float32", depth=2, dota=dict(res_learning=False))
    model, _, _ = build_backbone("uni3d", cfg.model, "cuda", seed=42)
    ref = TTAServer(cfg, model, load_precomputed("large", "modelnet").cuda(),
                    seed=42)
    ref.register("x")
    clouds = np.load(root / "data_uniform_5.npy")[:3, None]
    want_l = [ref.submit([("x", c, None)])["x"] for c in clouds]
    out = {}
    for mode in modes:
        cli_s = finish_process(f"{mode} CLI", clis[mode],
                               tmp / f"{mode}_cli.log")
        got = json.loads((tmp / f"{mode}_cli" / "run" / "results.json")
                         .read_text())
        if got != want["acc1"]:
            fail(f"{mode} CLI: results.json {got} against the run without "
                 f"it {want['acc1']}")
        log = (tmp / f"{mode}_cli" / "run" / "out.log").read_text()
        if TRUNK_LOG[mode] not in log:
            fail(f"{mode} CLI: out.log does not say it ran the {mode} trunk")
        port, procs = servers[mode]
        logits, health = serve_requests(f"{mode} serve CLI", procs, port,
                                        clouds, tmp, mode)
        diff = max(float(np.abs(a - b).max()) for a, b in zip(logits,
                                                             want_l))
        if diff > 1e-3 or health["clients"] != 1:
            fail(f"{mode} serve CLI: logits max |Δ| {diff:.3g} against a "
                 f"replicated server, healthz {health}")
        print(f"{mode} CLI: --trunk-parallel {mode} at world 2 wrote the "
              f"run's results.json without it ({cli_s:.1f} s with the "
              f"launch); cli.serve --trunk-parallel {mode}: 3 requests over "
              f"HTTP, logits max |Δ| {diff:.3g} against a replicated server, "
              f"both ranks exited 0")
        out[mode] = {"cli_s": cli_s, "serve_logits_max_abs_diff": diff}
    return out


def run_clis(tmp: Path, torch, dp_run: dict, ep_run: dict,
             trunk_runs: dict) -> None:
    """The launches of phases 11b (c) (`start_dp_cli`), 12 (d)
    (`start_ep_cli`) and 13–15's CLIs and servers at world 2
    (`run_tp_cli`), all started before any is waited for: none of them
    is timed beyond its own wall seconds, so they share the card and the
    host's cores.  Their summaries go into the phases' `dp_run`,
    `ep_run` and `trunk_runs` ({mode: summary} for tp, pp, sp)."""
    dp = start_dp_cli(tmp)
    ep = start_ep_cli(tmp, torch)
    clis = run_tp_cli(tmp, torch, tuple(trunk_runs))
    ep_run["cli"] = finish_ep_cli(ep)
    dp_run["cli_s"] = finish_dp_cli(dp, torch)
    for mode, run in trunk_runs.items():
        run["cli"] = clis[mode]

def trunk_refs(torch) -> dict:
    """Phases 13 and 14's one-process references, computed once: the
    inputs (`tp_inputs`) with the targets each run meets on every other
    cloud; Uni3D-L's bf16 and fp32 features of TP_CLOUDS clouds, its
    captured bf16 stream (the state and logits `want`, its ms a step and
    peak GB), the fp32 trajectory's logits and acc@1, OpenShape-G's and
    ULIP-2's features, and the depth-2 fp32 model's features and stream
    (EP × TP, PP × TP)."""
    from uni_adapter_torch import engine

    t0 = time.perf_counter()
    inp = tp_inputs(torch)
    pcs, rgbs = inp["pcs"].cuda(), inp["rgbs"].cuda()
    flat = (pcs[:TP_CLOUDS, 0], rgbs[:TP_CLOUDS, 0])
    bank = inp["bank"].cuda()
    ms = {}
    cfg = tp_cfg()
    model = tp_model(torch, cfg)
    ref = {"uni3d": tp_features(torch, engine.encode_with("uni3d", model),
                                *flat)}
    _, outs = engine.run_stream_scan(cfg, model, bank, pcs, rgbs,
                                     torch.zeros(16, 1, dtype=torch.int64),
                                     seed=42)
    inp["targets"] = half_met(torch, outs.final_logits)
    scan_fn = engine.make_scan_fn(cfg, model)
    (state, outs), _, peak = ep_peak(torch, lambda: engine.run_stream_scan(
        cfg, model, bank, pcs, rgbs, inp["targets"].cuda(), seed=42,
        scan_fn=scan_fn))
    want = (engine_tensors(state), outs.final_logits.cpu(),
            engine.summarize(outs, 16)["acc1"])
    ms["plain_bf16"] = statistics.median(scan_fn.step_ms[1:])
    del model, scan_fn, state, outs
    torch.cuda.empty_cache()
    cfg32 = tp_cfg("float32")
    model = tp_model(torch, cfg32)
    ref["uni3d_fp32"] = tp_features(torch, engine.encode_with("uni3d", model),
                                    *flat)
    fp = (pcs[:TP_FP32_STEPS], rgbs[:TP_FP32_STEPS])
    _, outs = engine.run_stream_scan(
        cfg32, model, bank, *fp, torch.zeros(TP_FP32_STEPS, 1,
                                             dtype=torch.int64), seed=42)
    inp["targets_fp32"] = half_met(torch, outs.final_logits)
    scan_fn = engine.make_scan_fn(cfg32, model)
    _, outs = engine.run_stream_scan(cfg32, model, bank, *fp,
                                     inp["targets_fp32"].cuda(), seed=42,
                                     scan_fn=scan_fn)
    ref["trajectory"] = (outs.final_logits.cpu(),
                         engine.summarize(outs, TP_FP32_STEPS)["acc1"],
                         outs.correct.cpu())
    ms["plain_fp32"] = statistics.median(scan_fn.step_ms[1:])
    del model, scan_fn, outs
    torch.cuda.empty_cache()
    for kind in ("openshape", "ulip"):
        m = tp_model(torch, tp_backbone_cfg(kind), kind)
        ref[kind] = tp_features(torch, engine.encode_with(kind, m), *flat)
        del m
    cfg_ep = tp_cfg("float32", depth=2, dota=dict(res_learning=False))
    m = tp_model(torch, cfg_ep)
    ref["depth2_fp32"] = tp_features(torch, engine.encode_with("uni3d", m),
                                     *flat)
    bank15 = inp["bank15"].cuda()
    ep_in = (pcs[:TP_FP32_STEPS], rgbs[:TP_FP32_STEPS])
    _, outs = engine.run_stream_scan(
        cfg_ep, m, bank15, *ep_in, torch.zeros(TP_FP32_STEPS, 1,
                                               dtype=torch.int64), seed=42)
    inp["targets_ep"] = half_met(torch, outs.final_logits)
    state, outs = engine.run_stream_scan(cfg_ep, m, bank15, *ep_in,
                                         inp["targets_ep"].cuda(), seed=42)
    ref["ep_tp"] = (ep_state(state), engine.summarize(outs,
                                                      TP_FP32_STEPS)["acc1"])
    del m, state, outs
    torch.cuda.empty_cache()
    print(f"trunk references (one process): {time.perf_counter() - t0:.1f} "
          f"s; the plain bf16 stream peaked at {peak:.2f} GB")
    return {"inp": inp, "ref": ref, "want": want, "ms": ms,
            "peak_gb": peak}


def run_tp(tmp: Path, card: str, refs=None, cli: bool = True) -> tuple:
    """Phase 13: the tensor-parallel trunk (`parallel/tp.py`).

    (a) world 1 over NCCL in this process: Uni3D-L bf16 at full width and
    depth, MODE-DOTA with residuals, 16 clouds, captured, through
    `prepare_trunk_parallel`'s encoder (a group of one holds the whole
    model): state and outputs bitwise equal to the plain scan's; traced:
    FPS, kNN and the block, no other kernel.  (b) world 2, two processes
    sharing the card over gloo: Uni3D-L bf16 features within TP_COS_BF16
    of one process's and its captured stream traced (rows 1, 2 and the
    head-sharded row 3 on each rank; segments a step, the all-reduces'
    share of host time, ms a step beside the plain scan), Uni3D-L fp32
    features within TP_COS_F32, the fp32 trajectory's logits within
    TP_LOGITS with acc@1 equal, the two planted faults outside
    TP_COS_F32, and OpenShape-G and ULIP-2 features within TP_COS_BF16
    (row 4 on the rank's heads).  (c) world 4 over gloo: EP × TP on a
    (classes, model) = (2, 2) grid (fp32, depth 2, residuals off, K 15)
    within TP_EP_RTOL, TP_EP_ATOL of the plain scan with acc@1 equal, and
    Uni3D-L's SwiGLU width 2730 raising the 4-device error.  (d) the CLI
    and the HTTP server at world 2 (`run_tp_cli`).  With two cards or
    more (b) runs again over NCCL, a card a rank; with four, (c) too, and
    OpenShape-G's features at world 4.  Returns (the world-1 run's
    launches, summary)."""
    import torch
    import torch.distributed as dist

    from uni_adapter_torch import engine
    from uni_adapter_torch.parallel import trunk

    t_phase = time.perf_counter()
    times, problems, summary = {}, [], {"ms_a_step": {}}

    def bad(msg: str) -> None:
        print(f"tp check failed: {msg}")
        problems.append(msg)

    refs = refs or trunk_refs(torch)
    inp, ref, want = refs["inp"], refs["ref"], refs["want"]
    summary["ms_a_step"].update(refs["ms"])
    pcs, rgbs = inp["pcs"].cuda(), inp["rgbs"].cuda()
    bank = inp["bank"].cuda()

    # (a) world 1 over NCCL
    t0 = time.perf_counter()
    cfg = tp_cfg()
    model = tp_model(torch, cfg)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        rank_model, encode = trunk.prepare_trunk_parallel(cfg, model)
        scan_fn = engine.make_scan_fn(cfg, rank_model, encode_fn=encode)
        (state, outs), launches, wrapper = traced_run(
            torch, "the TP stream (world 1, NCCL)",
            lambda: engine.run_stream_scan(
                cfg, rank_model, bank, pcs, rgbs, inp["targets"].cuda(),
                seed=42, scan_fn=scan_fn), TP_KERNELS)
    finally:
        dist.destroy_process_group()
    got = engine_tensors(state)
    same = all(torch.equal(got[k], want[0][k]) for k in want[0]) and \
        torch.equal(outs.final_logits.cpu(), want[1])
    if not same:
        bad("tp world 1: the state or the logits differ from the plain scan")
    summary["ms_a_step"]["world1_bf16"] = statistics.median(
        scan_fn.step_ms[1:])
    print(f"tp world 1 (NCCL), Uni3D-L bf16, MODE-DOTA with residuals, 16 "
          f"clouds captured: state and logits bitwise equal to the plain "
          f"scan's: {same}; acc@1 {engine.summarize(outs, 16)['acc1']} "
          f"(plain {want[2]}); launches {launches}")
    del model, rank_model, encode, scan_fn, state, outs
    torch.cuda.empty_cache()
    times["a"] = time.perf_counter() - t0

    # (b) world 2 over gloo
    t0 = time.perf_counter()
    torch.save({k: (v.cpu() if hasattr(v, "cpu") else v)
                for k, v in inp.items()}, tmp / "tp_inputs.pt")

    def check_world2(ranks: list, tag: str) -> dict:
        res = {}
        for r, out in enumerate(ranks):
            want_backend = "nccl" if "nccl" in tag else "gloo"
            if out["backend"] != want_backend:
                bad(f"tp world 2{tag}: rank {r} runs {out['backend']}")
            cos = {k: tp_min_cos(out[k], ref[k])
                   for k in ("uni3d", "uni3d_fp32", "openshape", "ulip")}
            for k, c in cos.items():
                tol = TP_COS_F32 if k == "uni3d_fp32" else TP_COS_BF16
                if c < tol:
                    bad(f"tp world 2{tag} rank {r}, {k}: features' least "
                        f"cosine {c:.6f} < {tol}")
            faults = {k: tp_min_cos(out[k], ref["uni3d_fp32"])
                      for k in ("fault_bo", "fault_fc2")}
            for k, c in faults.items():
                if c >= TP_COS_F32:
                    bad(f"tp world 2{tag} rank {r}: the planted fault {k} "
                        f"passes (least cosine {c:.6f})")
            tr = out["trajectory"]
            d = float((tr["final_logits"] - ref["trajectory"][0]).abs().max())
            if not torch.allclose(tr["final_logits"], ref["trajectory"][0],
                                  rtol=TP_LOGITS, atol=TP_LOGITS) or \
                    tr["acc1"] != ref["trajectory"][1]:
                bad(f"tp world 2{tag} rank {r}: fp32 logits max |Δ| {d:.3g}"
                    f" (tolerance {TP_LOGITS}), acc@1 {tr['acc1']} against "
                    f"{ref['trajectory'][1]}")
            st = out["stream"]
            heads_ok = (st["head_shard_launches"] == st["wrapper"] > 0
                        and tr["head_shard_launches"] > 0)
            if not heads_ok:
                bad(f"tp world 2{tag} rank {r}: head-sharded block launches "
                    f"{st['head_shard_launches']} of {st['wrapper']} (fp32 "
                    f"{tr['head_shard_launches']})")
            for kind in ("openshape", "ulip"):
                if not out[f"{kind}_launches"].get("eva_attention"):
                    bad(f"tp world 2{tag} rank {r}: {kind} did not launch "
                        f"eva_attention on its heads")
            print(f"tp world 2{tag} rank {r}: least cosine to one process "
                  f"{ {k: round(c, 7) for k, c in cos.items()} }; planted "
                  f"faults {faults}; fp32 trajectory logits max |Δ| {d:.3g},"
                  f" acc@1 {tr['acc1']} (one process "
                  f"{ref['trajectory'][1]}); bf16 stream acc@1 {st['acc1']} "
                  f"(one process {want[2]}), launches {st['launches']}, "
                  f"head-sharded {st['head_shard_launches']} of "
                  f"{st['wrapper']}; segments a step {st['segments']}; "
                  f"all-reduce {out['allreduce']}; OpenShape-G launches "
                  f"{out['openshape_launches']}, ULIP-2 "
                  f"{out['ulip_launches']}")
            res[f"rank{r}"] = {"cos": cos, "faults": faults,
                               "logits_max_abs": d,
                               "segments": st["segments"],
                               "allreduce": out["allreduce"]}
        summary["ms_a_step"][f"world2_bf16{tag}"] = statistics.median(
            ranks[0]["stream"]["ms"][1:])
        return res

    summary["world2"] = check_world2(run_tp_world(tmp, 2), "")
    times["b"] = time.perf_counter() - t0

    # (c) world 4 over gloo: EP × TP, the indivisible width
    t0 = time.perf_counter()

    def check_world4(ranks: list, tag: str) -> None:
        want_st, want_acc = ref["ep_tp"]
        for r, out in enumerate(ranks):
            got = out["ep_tp"]
            if got["grid"] != (2, 2, r // 2, r % 2):
                bad(f"tp EP × TP{tag} rank {r}: grid {got['grid']}")
            d = ep_check(f"tp EP × TP{tag} rank {r}", got["state"], want_st,
                         "mode", (TP_EP_RTOL, TP_EP_ATOL), report=bad)
            if got["summary"]["acc1"] != want_acc:
                bad(f"tp EP × TP{tag} rank {r}: acc@1 "
                    f"{got['summary']['acc1']} against {want_acc}")
            text = out["indivisible"] or ""
            if "don't divide over the 4-device mesh" not in text or \
                    "2730" not in text:
                bad(f"tp world 4{tag} rank {r}: Uni3D-L did not raise the "
                    f"indivisible error: {text!r}")
            if "openshape" in out and tp_min_cos(out["openshape"],
                                                 ref["openshape"]) \
                    < TP_COS_BF16:
                bad(f"tp world 4{tag} rank {r}: OpenShape-G features")
            print(f"tp EP × TP{tag} (classes 2 × model 2) rank {r}: state "
                  f"max |Δ| {d:.3g} from the plain scan (rtol {TP_EP_RTOL}, "
                  f"atol {TP_EP_ATOL}), acc@1 {got['summary']['acc1']}; "
                  f"launches {got['launches']}"
                  + (f"; OpenShape-G at world 4 least cosine "
                     f"{tp_min_cos(out['openshape'], ref['openshape']):.6f}"
                     if "openshape" in out else ""))
        print(f"tp world 4{tag}: Uni3D-L raised: {ranks[0]['indivisible']}")

    refs["tp_world4"] = run_tp_world(tmp, 4)
    check_world4(refs["tp_world4"], "")
    times["c"] = time.perf_counter() - t0

    # (d) the CLI and the HTTP server at world 2 (with `cli`; else the
    # caller runs them beside phase 14's)
    if cli:
        t0 = time.perf_counter()
        summary["cli"] = run_tp_cli(tmp, torch)["tp"]
        times["d"] = time.perf_counter() - t0

    if torch.cuda.device_count() >= 2:
        t0 = time.perf_counter()
        summary["world2_nccl"] = check_world2(run_tp_world(tmp, 2, "nccl"),
                                              " (nccl)")
        if torch.cuda.device_count() >= 4:
            refs["tp_world4_nccl"] = run_tp_world(tmp, 4, "nccl")
            check_world4(refs["tp_world4_nccl"], " (nccl)")
        times["nccl"] = time.perf_counter() - t0
    else:
        print("tp worlds over NCCL: not run, this machine has one card (the "
              "ranks shared it over gloo)")
    summary["seconds"] = time.perf_counter() - t_phase
    summary["part_seconds"] = times
    print(f"tp ms a step ({card}): " + ", ".join(
        f"{k} {v:.2f}" for k, v in summary["ms_a_step"].items()))
    print(f"phase tp: {summary['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in times.items()) + ")")
    if problems:
        fail(f"phase tp: {len(problems)} checks failed: "
             + "; ".join(problems))
    return launches, summary


#: Phase 14: the pipeline-parallel trunk.  At one microbatch a stage runs
#: the same kernels on the same bits as one process, and the shift and
#: the broadcast carry the activations exactly: the features, the
#: captured stream and OpenShape-G's and ULIP-2's features are held
#: bitwise, the fp32 trajectory within TP_LOGITS with acc@1 equal; PP ×
#: TP (fp32) within TP_COS_F32; pretraining as phase 11b's DP step
#: (DP_LOSS_RTOL, 99% of the parameters within DP_PARAM_ATOL after
#: PP_TRAIN_STEPS steps: lr 0, then DP_LR), the resume bitwise.  The
#: planted fault (the first shift skipped on both ranks, its receive
#: zero-filled) must take some cloud's fp32 features outside TP_COS_F32.
PP_TRAIN_STEPS = 2
PP_KERNELS = TP_KERNELS
PP_TRAIN_KERNELS = ("fps_grid", "knn_gather", "eva_attn_block_fp32",
                    "attn_f32_tc", "eva_attn_block_bwd")


def pp_cfg(dtype: str = "bfloat16", depth: int = 24, dota=None,
           interleave: int = 1, kind: str = "uni3d"):
    """`tp_cfg`'s model (or `tp_backbone_cfg`'s for `kind`), its trunk
    pipeline-parallel over the world, `interleave` chunks a stage."""
    cfg = tp_cfg(dtype, depth, dota) if kind == "uni3d" else \
        tp_backbone_cfg(kind)
    return dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, trunk_parallel="pp", pp_interleave=interleave))


def step_requests(scan_fn) -> dict:
    """The requests between a captured step's segments, by program
    (residual gate): {kind: [how many, bytes their buffers send]} (a
    shift that only receives sends none)."""
    out = {}
    for runner in scan_fn.runners.values():
        for gate, program in runner.programs.items():
            sent = collections.defaultdict(lambda: [0, 0])
            for part in program:
                for seg in getattr(part, "segments", [])[:-1]:
                    req = seg.out
                    sent[req.kind][0] += 1
                    if req.buf is not None:
                        sent[req.kind][1] += req.buf.numel() * \
                            req.buf.element_size()
            out[str(gate)] = dict(sent)
    return out


def pp_fault_shift(torch, encode, pcs, rgbs):
    """The planted fault 'one stage's shift skipped': the forward's first
    shift not issued on any rank (no deadlock: both sides skip it), its
    receive buffer zero-filled, the rest as it is."""
    from uni_adapter_torch.parallel import collectives

    parts, skipped = encode(pcs, rgbs), False
    with torch.no_grad():
        try:
            while True:
                req = next(parts)
                if req.kind == "shift" and not skipped:
                    skipped = True
                    if req.out is not None:
                        req.out.zero_()
                    continue
                collectives.issue(req, None)
        except StopIteration as done:
            return done.value.float().cpu()


def pp_train_rank(torch, inp: dict, tmp: Path) -> dict:
    """A rank's pretraining at world 2 (`pp_rank`): PP_TRAIN_STEPS steps of
    Uni3D-L fp32 at full width and depth over two stages of two
    microbatches, the batch of `dist_inputs`, traced for its launches and
    held against the one process's parameters `run_pp` saved; then at
    depth 2, four steps in one go against two, the state gathered and
    saved as the CLI saves it, restored on every rank and cut to its
    stage, and two more: bitwise."""
    import torch.distributed as dist

    from uni_adapter_torch import checkpoint, train
    from uni_adapter_torch.config import ModelConfig
    from uni_adapter_torch.models.uni3d import create_uni3d
    from uni_adapter_torch.parallel import pp

    batch = [inp["batch"][k].cuda() for k in ("pc", "text_embed",
                                               "image_embed", "mask")]

    def fresh(depth):
        model = create_uni3d(ModelConfig(eva_depth=depth,
                                         compute_dtype="float32"), "cuda",
                             torch.float32, seed=0, trainable=True)
        tx = train.make_optimizer(lr=DP_LR, total_steps=4, warmup_steps=1)
        rank_model, step = pp.make_pp_train_step(model, tx, pp.make_stages(),
                                                 n_micro=2)
        return rank_model, step, train.init_train_state(rank_model, tx)

    rank_model, step, state = fresh(PRETRAIN_DEPTH)
    losses, ms = [], []

    def steps():
        nonlocal state
        for _ in range(PP_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, *batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(m["loss"].item())

    torch.cuda.reset_peak_memory_stats()
    _, launches, _ = traced_run(torch, "the PP train step (world 2)", steps,
                                PP_TRAIN_KERNELS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = torch.load(tmp / "pp_train_ref.pt", mmap=True)
    diffs = torch.cat([(p.detach().cpu() - want[n]).abs().reshape(-1)
                       for n, p in state.params.items()])
    out = {"losses": losses, "ms": ms, "launches": launches, "peak_gb": peak,
           "max_abs": diffs.max().item(),
           "within": (diffs <= DP_PARAM_ATOL).float().mean().item(),
           "blocks": sorted({int(n.split(".")[2]) for n in state.params
                             if ".blocks." in n})}
    del rank_model, step, state, want, diffs
    torch.cuda.empty_cache()
    rank_model, step, state = fresh(2)
    for _ in range(4):
        state, _ = step(state, *batch)
    whole = {n: p.detach().clone() for n, p in state.params.items()}
    rank_model, step, state = fresh(2)
    for _ in range(2):
        state, _ = step(state, *batch)
    full = pp.gather_train_state(state, rank_model)
    if dist.get_rank() == 0:
        checkpoint.save_state(str(tmp / "pp_ckpt"), {"train": full})
    dist.barrier()
    rank_model, step, _ = fresh(2)
    saved = checkpoint.restore_state(str(tmp / "pp_ckpt"), device="cuda")
    state = train.load_train_state(rank_model, pp.local_train_state(
        saved["train"], rank_model))
    for _ in range(2):
        state, _ = step(state, *batch)
    out["resumed_bitwise"] = all(torch.equal(whole[n], p) for n, p in
                                 state.params.items())
    out["gathered"] = 0 if full is None else len(full.params)
    return out


def pp_tp_rank(torch, flat) -> dict:
    """A rank's PP × TP at world 4: two stages of two model ranks
    (`pp.make_pp_grid(2, 2)`), Uni3D-L fp32 at depth 2, the features of
    `flat`, the launches and the rank's (stage, model rank)."""
    from uni_adapter_torch.parallel import pp

    cfg = tp_cfg("float32", depth=2)
    grid = pp.make_pp_grid(2, 2)
    counters = zeroed_counters()
    _, encode = pp.make_pp_encode_fn(tp_model(torch, cfg), grid.stages,
                                     "uni3d", tp_group=grid.model_group)
    return {"pp_tp": tp_features(torch, encode, *flat),
            "pp_tp_launches": {k: c.launches for k, c in counters.items()
                               if c.launches},
            "grid": (grid.stages.index, grid.model_rank)}


def pp_rank(rank: int, world: int, tmp: str, port: int, mode: str) -> None:
    """One rank of phase 14's worlds of 2 and 4, started by `run_pp_world`:
    mode 'gloo', every rank on card 0 (the bootstrap picks gloo), or
    'nccl', a card a rank; writes tmp/pp_rank{rank}_w{world}_{mode}.pt."""
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if mode == "gloo":
        os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    import torch
    import torch.distributed as dist

    from uni_adapter_torch import engine
    from uni_adapter_torch.cli.tta import set_numerics
    from uni_adapter_torch.parallel import pp, trunk
    from uni_adapter_torch.parallel.bootstrap import init_distributed_device

    boot = init_distributed_device("cuda")
    set_numerics()
    try:
        inp = torch.load(Path(tmp) / "pp_inputs.pt", weights_only=False)
        out = {"backend": boot["backend"]}
        pcs, rgbs = inp["pcs"].cuda(), inp["rgbs"].cuda()
        flat = (pcs[:TP_CLOUDS, 0], rgbs[:TP_CLOUDS, 0])
        bank = inp["bank"].cuda()
        if world == 4:
            out.update(pp_tp_rank(torch, flat))
            torch.save(out, Path(tmp) / f"pp_rank{rank}_w{world}_{mode}.pt")
            return
        for V in (1, 2):
            cfg = pp_cfg(interleave=V)
            model, encode = trunk.prepare_trunk_parallel(cfg, tp_model(torch,
                                                                       cfg))
            out[f"uni3d_v{V}"] = tp_features(torch, encode, *flat)
            if V == 1:
                scan_fn = engine.make_scan_fn(cfg, model, encode_fn=encode)
                go = lambda: engine.run_stream_scan(  # noqa: E731
                    cfg, model, bank, pcs, rgbs, inp["targets"].cuda(),
                    seed=42, scan_fn=scan_fn)
                ((state, outs), launches, _), _, peak = ep_peak(
                    torch, lambda: traced_run(
                        torch, f"the PP stream (world {world}, {mode})", go,
                        PP_KERNELS))
                out["stream"] = {"state": engine_tensors(state),
                                 "final_logits": outs.final_logits.cpu(),
                                 "acc1": engine.summarize(outs, 16)["acc1"],
                                 "ms": list(scan_fn.step_ms),
                                 "launches": launches, "peak_gb": peak,
                                 "segments": ep_segments(scan_fn),
                                 "bytes": step_requests(scan_fn),
                                 "blocks": len(list(model.point_encoder
                                                    .blocks))}
                del scan_fn, state, outs
            del model, encode
            torch.cuda.empty_cache()
            cfg = pp_cfg("float32", interleave=V)
            model, encode = trunk.prepare_trunk_parallel(cfg, tp_model(torch,
                                                                       cfg))
            out[f"uni3d_fp32_v{V}"] = tp_features(torch, encode, *flat)
            if V == 1:
                _, outs = engine.run_stream_scan(
                    cfg, model, bank, pcs[:TP_FP32_STEPS],
                    rgbs[:TP_FP32_STEPS], inp["targets_fp32"].cuda(),
                    seed=42, scan_fn=engine.make_scan_fn(cfg, model,
                                                         encode_fn=encode))
                out["trajectory"] = {
                    "final_logits": outs.final_logits.cpu(),
                    "acc1": engine.summarize(outs, TP_FP32_STEPS)["acc1"]}
                out["fault_shift"] = pp_fault_shift(torch, encode, *flat)
                del outs
            del model, encode
            torch.cuda.empty_cache()
        for kind in ("openshape", "ulip"):
            c = pp_cfg(kind=kind)
            model, encode = trunk.prepare_trunk_parallel(
                c, tp_model(torch, c, kind))
            counters = zeroed_counters()
            out[kind] = tp_features(torch, encode, *flat)
            out[f"{kind}_launches"] = {k: n.launches
                                       for k, n in counters.items()
                                       if n.launches}
            del model, encode
            torch.cuda.empty_cache()
        out["train"] = pp_train_rank(torch, inp, Path(tmp))
        torch.save(out, Path(tmp) / f"pp_rank{rank}_w{world}_{mode}.pt")
    finally:
        dist.barrier()
        dist.destroy_process_group()


def run_pp_world(tmp: Path, world: int, mode: str = "gloo") -> list:
    """Phase 14's world of `world` ranks (`pp_rank`): over gloo on card 0,
    or over NCCL, a card a rank."""
    import torch
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    mp.start_processes(pp_rank, args=(world, str(tmp), free_port(), mode),
                       nprocs=world, join=True, start_method="spawn")
    print(f"pp world {world} ({mode}): all ranks done in "
          f"{time.perf_counter() - t0:.1f} s")
    return [torch.load(tmp / f"pp_rank{r}_w{world}_{mode}.pt",
                       weights_only=False) for r in range(world)]


def pp_train_reference(torch, inp: dict, tmp: Path) -> dict:
    """One process's PP_TRAIN_STEPS train steps of Uni3D-L fp32 at full
    width and depth on the batch of `dist_inputs` (`train.train_step`):
    the losses, ms a step and peak GB; its parameters saved for the ranks
    (tmp/pp_train_ref.pt)."""
    from uni_adapter_torch import train
    from uni_adapter_torch.config import ModelConfig
    from uni_adapter_torch.models.uni3d import create_uni3d

    batch = [inp["batch"][k].cuda() for k in ("pc", "text_embed",
                                               "image_embed", "mask")]
    model = create_uni3d(ModelConfig(eva_depth=PRETRAIN_DEPTH,
                                     compute_dtype="float32"), "cuda",
                         torch.float32, seed=0, trainable=True)
    tx = train.make_optimizer(lr=DP_LR, total_steps=4, warmup_steps=1)
    state = train.init_train_state(model, tx)
    losses, ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(PP_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = train.train_step(model, tx, state, *batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.save({n: p.detach().cpu() for n, p in state.params.items()},
               tmp / "pp_train_ref.pt")
    del model, state
    torch.cuda.empty_cache()
    return {"losses": losses, "ms": ms, "peak_gb": peak}


def run_pp(tmp: Path, card: str, refs=None, cli: bool = True) -> tuple:
    """Phase 14: the pipeline-parallel trunk (`parallel/pp.py`).

    (a) world 1 over NCCL in this process: Uni3D-L bf16 at full width and
    depth, MODE-DOTA with residuals, 16 clouds, captured, through
    `prepare_trunk_parallel`'s PP encoder (one stage holds the whole
    trunk): state and outputs bitwise the plain scan's (`trunk_refs`);
    traced: FPS, kNN and the block, no other kernel; then one process's
    full-width train steps (`pp_train_reference`).  (b) world 2, two
    processes sharing the card over gloo (`pp_rank`): Uni3D-L's bf16 and
    fp32 features of TP_CLOUDS clouds in one microbatch, GPipe and
    interleaved (V = 2), bitwise one process's; the captured bf16 stream
    bitwise the plain scan's, traced (rows 1, 2 and 3 on each rank: 12
    blocks a rank), with its ms a step, segments a step, bytes shifted
    and broadcast a step and peak GB a rank; the fp32 trajectory within
    TP_LOGITS, acc@1 equal; the planted fault outside TP_COS_F32;
    OpenShape-G's and ULIP-2's features bitwise; pretraining at full
    width against one process and the depth-2 resume bitwise
    (`pp_train_rank`).  (c) world 4 over gloo: PP × TP within TP_COS_F32
    of one process (`pp_tp_rank`, in phase 13's world of 4 where it ran,
    else in a world of its own).  (d) the CLI and the HTTP server at world 2
    (`run_tp_cli`; with `cli` False the caller runs it, beside phase 13's).
    With two cards or more (b) runs again over
    NCCL, a card a rank; with four, (c) too.  Returns (the world-1 run's
    launches, summary)."""
    import torch
    import torch.distributed as dist

    from uni_adapter_torch import engine
    from uni_adapter_torch.parallel import trunk

    t_phase = time.perf_counter()
    times, problems, summary = {}, [], {"ms_a_step": {}}

    def bad(msg: str) -> None:
        print(f"pp check failed: {msg}")
        problems.append(msg)

    refs = refs or trunk_refs(torch)
    inp, ref, want = dict(refs["inp"]), refs["ref"], refs["want"]
    summary["ms_a_step"].update(refs["ms"])
    pcs, rgbs = inp["pcs"].cuda(), inp["rgbs"].cuda()
    bank = inp["bank"].cuda()

    # (a) world 1 over NCCL, and one process's train steps
    t0 = time.perf_counter()
    cfg = pp_cfg()
    model = tp_model(torch, cfg)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        rank_model, encode = trunk.prepare_trunk_parallel(cfg, model)
        scan_fn = engine.make_scan_fn(cfg, rank_model, encode_fn=encode)
        (state, outs), launches, _ = traced_run(
            torch, "the PP stream (world 1, NCCL)",
            lambda: engine.run_stream_scan(
                cfg, rank_model, bank, pcs, rgbs, inp["targets"].cuda(),
                seed=42, scan_fn=scan_fn), PP_KERNELS)
    finally:
        dist.destroy_process_group()
    got = engine_tensors(state)
    same = all(torch.equal(got[k], want[0][k]) for k in want[0]) and \
        torch.equal(outs.final_logits.cpu(), want[1])
    if not same:
        bad("pp world 1: the state or the logits differ from the plain scan")
    summary["ms_a_step"]["world1_bf16"] = statistics.median(
        scan_fn.step_ms[1:])
    print(f"pp world 1 (NCCL), Uni3D-L bf16, MODE-DOTA with residuals, 16 "
          f"clouds captured: state and logits bitwise equal to the plain "
          f"scan's: {same}; launches {launches}")
    del model, rank_model, encode, scan_fn, state, outs
    torch.cuda.empty_cache()
    inp["batch"] = dist_inputs(torch)["batch"]
    train_ref = pp_train_reference(torch, inp, tmp)
    times["a"] = time.perf_counter() - t0

    # (b) world 2 over gloo
    t0 = time.perf_counter()
    torch.save({k: (v.cpu() if hasattr(v, "cpu") else v)
                for k, v in inp.items()}, tmp / "pp_inputs.pt")

    def check_world2(ranks: list, tag: str) -> dict:
        res = {}
        for r, out in enumerate(ranks):
            want_backend = "nccl" if "nccl" in tag else "gloo"
            if out["backend"] != want_backend:
                bad(f"pp world 2{tag}: rank {r} runs {out['backend']}")
            pairs = {f"uni3d_v{V}": "uni3d" for V in (1, 2)}
            pairs.update({f"uni3d_fp32_v{V}": "uni3d_fp32" for V in (1, 2)})
            pairs.update(openshape="openshape", ulip="ulip")
            unequal = [k for k, w in pairs.items()
                       if not torch.equal(out[k], ref[w])]
            if unequal:
                bad(f"pp world 2{tag} rank {r}: features not bitwise one "
                    f"process's: {unequal}")
            fault = tp_min_cos(out["fault_shift"], ref["uni3d_fp32"])
            if fault >= TP_COS_F32:
                bad(f"pp world 2{tag} rank {r}: the planted fault passes "
                    f"(least cosine {fault:.6f})")
            tr = out["trajectory"]
            d = float((tr["final_logits"] - ref["trajectory"][0]).abs().max())
            if not torch.allclose(tr["final_logits"], ref["trajectory"][0],
                                  rtol=TP_LOGITS, atol=TP_LOGITS) or \
                    tr["acc1"] != ref["trajectory"][1]:
                bad(f"pp world 2{tag} rank {r}: fp32 logits max |Δ| {d:.3g}"
                    f", acc@1 {tr['acc1']} against {ref['trajectory'][1]}")
            st = out["stream"]
            same = all(torch.equal(st["state"][k], want[0][k])
                       for k in want[0]) and \
                torch.equal(st["final_logits"], want[1])
            if not same or st["blocks"] != 12:
                bad(f"pp world 2{tag} rank {r}: the captured stream is not "
                    f"bitwise the plain scan's ({same}) or the rank holds "
                    f"{st['blocks']} blocks")
            for kind in ("openshape", "ulip"):
                if not out[f"{kind}_launches"]:
                    bad(f"pp world 2{tag} rank {r}: {kind} launched nothing")
            tr_ = out["train"]
            loss_ok = all(abs(a - b) <= DP_LOSS_RTOL * abs(b) for a, b in
                          zip(tr_["losses"], train_ref["losses"]))
            if not loss_ok or tr_["within"] < 0.99 or \
                    not tr_["resumed_bitwise"]:
                bad(f"pp world 2{tag} rank {r}: train losses "
                    f"{tr_['losses']} against {train_ref['losses']}, "
                    f"{tr_['within']:.4f} of the parameters within "
                    f"{DP_PARAM_ATOL}, resumed bitwise "
                    f"{tr_['resumed_bitwise']}")
            print(f"pp world 2{tag} rank {r}: features bitwise one process's "
                  f"(bf16 and fp32, GPipe and V = 2, OpenShape-G, ULIP-2): "
                  f"{not unequal}; planted fault least cosine {fault:.4f}; "
                  f"fp32 trajectory logits max |Δ| {d:.3g}, acc@1 "
                  f"{tr['acc1']}; bf16 stream bitwise the plain scan's "
                  f"{same}, {st['blocks']} blocks, launches "
                  f"{st['launches']}, segments a step {st['segments']}, "
                  f"bytes a step {st['bytes']}, peak {st['peak_gb']:.2f} GB "
                  f"(one process {refs['peak_gb']:.2f} GB); OpenShape-G "
                  f"launches {out['openshape_launches']}, ULIP-2 "
                  f"{out['ulip_launches']}; train (blocks {tr_['blocks'][0]}"
                  f"-{tr_['blocks'][-1]}): losses {tr_['losses']} (one "
                  f"process {train_ref['losses']}), {tr_['within']:.4f} of "
                  f"the parameters within {DP_PARAM_ATOL} (max |Δ| "
                  f"{tr_['max_abs']:.3g}), ms a step {tr_['ms']} (one "
                  f"process {train_ref['ms']}), peak {tr_['peak_gb']:.2f} GB "
                  f"(one process {train_ref['peak_gb']:.2f} GB), launches "
                  f"{tr_['launches']}, depth-2 resume bitwise "
                  f"{tr_['resumed_bitwise']}")
            res[f"rank{r}"] = {"segments": st["segments"],
                               "bytes": st["bytes"], "peak_gb": st["peak_gb"],
                               "launches": st["launches"],
                               "fault_cos": fault, "logits_max_abs": d,
                               "train": {k: tr_[k] for k in (
                                   "losses", "ms", "peak_gb", "max_abs",
                                   "within", "launches")}}
        summary["ms_a_step"][f"world2_bf16{tag}"] = statistics.median(
            ranks[0]["stream"]["ms"][1:])
        return res

    summary["world2"] = check_world2(run_pp_world(tmp, 2), "")
    summary["one_process"] = {"peak_gb": refs["peak_gb"], "train": train_ref}
    refs["train_ref"] = train_ref           # phase 15's, on the same batch
    times["b"] = time.perf_counter() - t0

    # (c) world 4 over gloo: PP × TP
    t0 = time.perf_counter()

    def check_world4(ranks: list, tag: str) -> None:
        for r, out in enumerate(ranks):
            c = tp_min_cos(out["pp_tp"], ref["depth2_fp32"])
            if c < TP_COS_F32 or out["grid"] != (r // 2, r % 2):
                bad(f"pp × tp world 4{tag} rank {r}: least cosine {c:.6f}, "
                    f"grid {out['grid']}")
            print(f"pp × tp world 4{tag} (stages 2 × model 2) rank {r}: "
                  f"least cosine to one process {c:.7f}; launches "
                  f"{out['pp_tp_launches']}")

    check_world4(refs.get("tp_world4") or run_pp_world(tmp, 4), "")
    times["c"] = time.perf_counter() - t0

    # (d) the CLI and the HTTP server at world 2 (with `cli`; else the
    # caller runs them beside phase 13's)
    if cli:
        t0 = time.perf_counter()
        summary["cli"] = run_tp_cli(tmp, torch, ("pp",))["pp"]
        times["d"] = time.perf_counter() - t0

    if torch.cuda.device_count() >= 2:
        t0 = time.perf_counter()
        summary["world2_nccl"] = check_world2(run_pp_world(tmp, 2, "nccl"),
                                              " (nccl)")
        if torch.cuda.device_count() >= 4:
            check_world4(refs.get("tp_world4_nccl")
                         or run_pp_world(tmp, 4, "nccl"), " (nccl)")
        times["nccl"] = time.perf_counter() - t0
    else:
        print("pp worlds over NCCL: not run, this machine has one card (the "
              "ranks shared it over gloo)")
    summary["seconds"] = time.perf_counter() - t_phase
    summary["part_seconds"] = times
    print(f"pp ms a step ({card}): " + ", ".join(
        f"{k} {v:.2f}" for k, v in summary["ms_a_step"].items()))
    print(f"phase pp: {summary['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in times.items()) + ")")
    if problems:
        fail(f"phase pp: {len(problems)} checks failed: "
             + "; ".join(problems))
    return launches, summary


# ---- phase 15: the sequence-parallel trunk (parallel/sp.py) ---------------

#: Phase 15: the sequence-parallel trunk.  SP restates the blocks in plain
#: PyTorch around its ring (no row 3): at world 1 its features are held to
#: the plain forward's within TP_COS_BF16 (bf16) and TP_COS_F32 (fp32);
#: at world 2 to world 1's, bf16 within TP_COS_BF16, fp32 within
#: SP_F32_ATOL of each feature (only the order of the folds differs),
#: which the planted fault (the last arriving block's fold skipped) must
#: exceed; ULIP-2 within TP_COS_BF16 of one process; the captured fp32
#: MODE-DOTA trajectory's logits within TP_LOGITS of one process's plain
#: trajectory, its `correct` equal (bf16 predictions flip at near-ties
#: with the GEMMs' row counts, cuBLAS's bf16 not being batch-invariant,
#: so the bf16 stream is timed, not compared); SP × DP (fp32) within
#: TP_COS_F32;
#: pretraining as phase 14's (DP_LOSS_RTOL, 99% of the parameters within
#: DP_PARAM_ATOL after SP_TRAIN_STEPS steps), and the depth-2 run resumed
#: at world 1 from world 2's checkpoint held to world 2's uninterrupted
#: run the same way.
SP_F32_ATOL = 1e-5
SP_TRAIN_STEPS = 2
#: The SP paths' kernels: the grouping only (rows 1, 2 on 1024 points;
#: rows 8, 6 on the 10,000-point training batch).
SP_KERNELS = ("fps", "knn")
SP_TRAIN_KERNELS = ("fps_grid", "knn_gather")


def sp_cfg(dtype: str = "bfloat16", depth: int = 24, dota=None,
           kind: str = "uni3d"):
    """`tp_cfg`'s model (or `tp_backbone_cfg`'s for `kind`), its trunk
    sequence-parallel over the world."""
    cfg = tp_cfg(dtype, depth, dota) if kind == "uni3d" else \
        tp_backbone_cfg(kind)
    return dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, trunk_parallel="sp"))


def sp_fault_last_fold(torch, encode, pcs, rgbs, n_ranks: int):
    """The planted fault 'the last arriving block's fold skipped': every
    ring's S-th fold returns its accumulators unchanged, the forward
    otherwise the same."""
    from uni_adapter_torch.parallel import sp

    real, calls = sp._fold, [0]

    def fold(acc, *args):
        calls[0] += 1
        return acc if calls[0] % n_ranks == 0 else real(acc, *args)

    sp._fold = fold
    try:
        return tp_features(torch, encode, pcs, rgbs)
    finally:
        sp._fold = real


def sp_train_rank(torch, inp: dict, tmp: Path) -> dict:
    """A rank's pretraining at world 2 (`sp_rank`): SP_TRAIN_STEPS steps of
    Uni3D-L fp32 at full width and depth, the tokens over the two ranks,
    the batch of `dist_inputs`, traced for its launches and held against
    the one process's parameters saved as tmp/pp_train_ref.pt; then four
    steps at depth 2, the state after the second saved (rank 0, one
    process's state, as the CLI saves it) for `run_sp` to resume at
    world 1 and hold against the fourth."""
    import torch.distributed as dist

    from uni_adapter_torch import checkpoint, train
    from uni_adapter_torch.config import ModelConfig
    from uni_adapter_torch.models.uni3d import create_uni3d
    from uni_adapter_torch.parallel import sp

    batch = [inp["batch"][k].cuda() for k in ("pc", "text_embed",
                                               "image_embed", "mask")]

    def fresh(depth):
        model = create_uni3d(ModelConfig(eva_depth=depth,
                                         compute_dtype="float32"), "cuda",
                             torch.float32, seed=0, trainable=True)
        tx = train.make_optimizer(lr=DP_LR, total_steps=4, warmup_steps=1)
        return sp.make_sp_train_step(model, tx, dist.group.WORLD), \
            train.init_train_state(model, tx)

    step, state = fresh(PRETRAIN_DEPTH)
    losses, ms = [], []

    def steps():
        nonlocal state
        for _ in range(SP_TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, *batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(m["loss"].item())

    torch.cuda.reset_peak_memory_stats()
    _, launches, _ = traced_run(torch, "the SP train step (world 2)", steps,
                                SP_TRAIN_KERNELS)
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = torch.load(tmp / "pp_train_ref.pt", mmap=True)
    diffs = torch.cat([(p.detach().cpu() - want[n]).abs().reshape(-1)
                       for n, p in state.params.items()])
    out = {"losses": losses, "ms": ms, "launches": launches, "peak_gb": peak,
           "max_abs": diffs.max().item(),
           "within": (diffs <= DP_PARAM_ATOL).float().mean().item()}
    del step, state, want, diffs
    torch.cuda.empty_cache()
    step, state = fresh(2)
    for i in range(4):
        if i == 2:
            if dist.get_rank() == 0:
                checkpoint.save_state(str(tmp / "sp_ckpt"), {"train": state})
            dist.barrier()
        state, _ = step(state, *batch)
    out["depth2"] = {n: p.detach().cpu() for n, p in state.params.items()}
    return out


def sp_resume_at_world1(torch, inp: dict, tmp: Path, whole: dict) -> dict:
    """The depth-2 checkpoint `sp_train_rank` saved at world 2 after two
    steps, restored in this process (a world of one) and trained two
    more: its parameters against world 2's after its fourth step."""
    from uni_adapter_torch import checkpoint, train
    from uni_adapter_torch.config import ModelConfig
    from uni_adapter_torch.models.uni3d import create_uni3d
    from uni_adapter_torch.parallel import sp

    batch = [inp["batch"][k].cuda() for k in ("pc", "text_embed",
                                               "image_embed", "mask")]
    model = create_uni3d(ModelConfig(eva_depth=2, compute_dtype="float32"),
                         "cuda", torch.float32, seed=0, trainable=True)
    tx = train.make_optimizer(lr=DP_LR, total_steps=4, warmup_steps=1)
    step = sp.make_sp_train_step(model, tx)
    saved = checkpoint.restore_state(str(tmp / "sp_ckpt"), device="cuda")
    state = train.load_train_state(model, saved["train"])
    for _ in range(2):
        state, _ = step(state, *batch)
    diffs = torch.cat([(p.detach().cpu() - whole[n]).abs().reshape(-1)
                       for n, p in state.params.items()])
    out = {"step": int(state.step), "max_abs": diffs.max().item(),
           "within": (diffs <= DP_PARAM_ATOL).float().mean().item()}
    del model, state
    torch.cuda.empty_cache()
    return out


def sp_dp_rank(torch, flat) -> dict:
    """A rank's SP × DP at world 4: a (data, seq) = (2, 2) grid
    (`sp.make_sp_grid(2, 2)`), Uni3D-L fp32 at depth 2, the features of
    `flat`, the launches and the rank's (seq rank, data rank)."""
    from uni_adapter_torch import engine
    from uni_adapter_torch.parallel import sp

    grid = sp.make_sp_grid(2, 2)
    counters = zeroed_counters()
    encode = engine.encode_parts("uni3d", sp.make_sp_forward(
        tp_model(torch, tp_cfg("float32", depth=2)), grid.seq_group,
        grid.data_group))
    return {"sp_dp": tp_features(torch, encode, *flat),
            "sp_dp_launches": {k: c.launches for k, c in counters.items()
                               if c.launches},
            "sp_grid": (grid.seq_rank, grid.data_rank)}


def sp_rank(rank: int, world: int, tmp: str, port: int, mode: str) -> None:
    """One rank of phase 15's worlds of 2 and 4, started by `run_sp_world`:
    mode 'gloo', every rank on card 0 (the bootstrap picks gloo), or
    'nccl', a card a rank; writes tmp/sp_rank{rank}_w{world}_{mode}.pt."""
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if mode == "gloo":
        os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    import torch
    import torch.distributed as dist

    from uni_adapter_torch import engine
    from uni_adapter_torch.cli.tta import set_numerics
    from uni_adapter_torch.parallel import trunk
    from uni_adapter_torch.parallel.bootstrap import init_distributed_device

    boot = init_distributed_device("cuda")
    set_numerics()
    try:
        inp = torch.load(Path(tmp) / "sp_inputs.pt", weights_only=False)
        out = {"backend": boot["backend"]}
        pcs, rgbs = inp["pcs"].cuda(), inp["rgbs"].cuda()
        flat = (pcs[:TP_CLOUDS, 0], rgbs[:TP_CLOUDS, 0])
        if world == 4:
            out.update(sp_dp_rank(torch, flat))
            torch.save(out, Path(tmp) / f"sp_rank{rank}_w{world}_{mode}.pt")
            return
        # Uni3D-L bf16: features, the traced captured stream
        cfg = sp_cfg()
        model, encode = trunk.prepare_trunk_parallel(cfg, tp_model(torch,
                                                                   cfg))
        out["uni3d"] = tp_features(torch, encode, *flat)
        scan_fn = engine.make_scan_fn(cfg, model, encode_fn=encode)
        go = lambda: engine.run_stream_scan(  # noqa: E731
            cfg, model, inp["bank"].cuda(), pcs, rgbs,
            inp["targets"].cuda(), seed=42, scan_fn=scan_fn)
        ((state, outs), launches, _), _, peak = ep_peak(
            torch, lambda: traced_run(
                torch, f"the SP stream (world {world}, {mode})", go,
                SP_KERNELS))
        out["stream"] = {"acc1": engine.summarize(outs, 16)["acc1"],
                         "ms": list(scan_fn.step_ms),
                         "launches": launches, "peak_gb": peak,
                         "segments": ep_segments(scan_fn),
                         "requests": step_requests(scan_fn)}
        del model, encode, scan_fn, state, outs
        torch.cuda.empty_cache()
        # Uni3D-L fp32: features and the planted fault
        cfg = sp_cfg("float32")
        model, encode = trunk.prepare_trunk_parallel(cfg, tp_model(torch,
                                                                   cfg))
        out["uni3d_fp32"] = tp_features(torch, encode, *flat)
        out["fault"] = sp_fault_last_fold(torch, encode, *flat, world)
        _, outs = engine.run_stream_scan(
            cfg, model, inp["bank"].cuda(), pcs[:TP_FP32_STEPS],
            rgbs[:TP_FP32_STEPS], inp["targets_fp32"].cuda(), seed=42,
            scan_fn=engine.make_scan_fn(cfg, model, encode_fn=encode))
        out["trajectory"] = {"final_logits": outs.final_logits.cpu(),
                             "correct": outs.correct.cpu()}
        del model, encode, outs
        torch.cuda.empty_cache()
        c = sp_cfg(kind="ulip")
        model, encode = trunk.prepare_trunk_parallel(
            c, tp_model(torch, c, "ulip"))
        counters = zeroed_counters()
        out["ulip"] = tp_features(torch, encode, *flat)
        out["ulip_launches"] = {k: n.launches for k, n in counters.items()
                                if n.launches}
        del model, encode
        torch.cuda.empty_cache()
        out["train"] = sp_train_rank(torch, inp, Path(tmp))
        torch.save(out, Path(tmp) / f"sp_rank{rank}_w{world}_{mode}.pt")
    finally:
        dist.barrier()
        dist.destroy_process_group()


def run_sp_world(tmp: Path, world: int, mode: str = "gloo") -> list:
    """Phase 15's world of `world` ranks (`sp_rank`): over gloo on card 0,
    or over NCCL, a card a rank."""
    import torch
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    mp.start_processes(sp_rank, args=(world, str(tmp), free_port(), mode),
                       nprocs=world, join=True, start_method="spawn")
    print(f"sp world {world} ({mode}): all ranks done in "
          f"{time.perf_counter() - t0:.1f} s")
    return [torch.load(tmp / f"sp_rank{r}_w{world}_{mode}.pt",
                       weights_only=False) for r in range(world)]


def run_sp(tmp: Path, card: str, refs=None, cli: bool = True) -> tuple:
    """Phase 15: the sequence-parallel trunk (`parallel/sp.py`).

    (a) world 1 over NCCL in this process: Uni3D-L at full width and
    depth through `prepare_trunk_parallel`'s SP encoder, its bf16 and
    fp32 features against the plain forward's (`trunk_refs`), the
    captured bf16 stream (MODE-DOTA with residuals, 16 clouds) traced:
    FPS and kNN, no other kernel, ms a step beside the plain scan's.  (b)
    world 2, two processes sharing the card over gloo (`sp_rank`): the
    bf16 and fp32 features against world 1's, the planted fault failing,
    ULIP-2's features, the fp32 trajectory against one process's
    (`correct` equal), the captured bf16 stream (ms, segments, shifts and
    their bytes a step, peak GB a rank),
    pretraining at full width against one process (`pp_train_reference`,
    phase 14's where it ran) and the depth-2 checkpoint resumed here at
    world 1 (`sp_resume_at_world1`).  (c) world 4 over gloo: SP × DP
    within TP_COS_F32 of one process (`sp_dp_rank`, in phase 13's world
    of 4 where it ran, else in a world of its own).  (d) the CLI and the
    HTTP server at world 2 (`run_tp_cli`; with `cli` False the caller
    runs it, beside phases 13's and 14's).  With two cards or more (b)
    runs again over NCCL, a card a rank; with four, (c) too.  Returns
    (the world-1 run's launches, summary)."""
    import torch
    import torch.distributed as dist

    from uni_adapter_torch import engine
    from uni_adapter_torch.parallel import trunk

    t_phase = time.perf_counter()
    times, problems, summary = {}, [], {"ms_a_step": {}}

    def bad(msg: str) -> None:
        print(f"sp check failed: {msg}")
        problems.append(msg)

    refs = refs or trunk_refs(torch)
    inp, ref, want = dict(refs["inp"]), refs["ref"], refs["want"]
    summary["ms_a_step"].update(refs["ms"])
    pcs, rgbs = inp["pcs"].cuda(), inp["rgbs"].cuda()
    flat = (pcs[:TP_CLOUDS, 0], rgbs[:TP_CLOUDS, 0])
    bank = inp["bank"].cuda()

    # (a) world 1 over NCCL
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        cfg = sp_cfg("float32")
        _, encode = trunk.prepare_trunk_parallel(cfg, tp_model(torch, cfg))
        world1 = {"uni3d_fp32": tp_features(torch, encode, *flat)}
        del encode
        torch.cuda.empty_cache()
        cfg = sp_cfg()
        rank_model, encode = trunk.prepare_trunk_parallel(
            cfg, tp_model(torch, cfg))
        world1["uni3d"] = tp_features(torch, encode, *flat)
        scan_fn = engine.make_scan_fn(cfg, rank_model, encode_fn=encode)
        (state, outs), launches, _ = traced_run(
            torch, "the SP stream (world 1, NCCL)",
            lambda: engine.run_stream_scan(
                cfg, rank_model, bank, pcs, rgbs, inp["targets"].cuda(),
                seed=42, scan_fn=scan_fn), SP_KERNELS)
    finally:
        dist.destroy_process_group()
    cos = {k: tp_min_cos(world1[k], ref[k]) for k in ("uni3d", "uni3d_fp32")}
    for k, c in cos.items():
        tol = TP_COS_F32 if k == "uni3d_fp32" else TP_COS_BF16
        if c < tol:
            bad(f"sp world 1, {k}: features' least cosine {c:.7f} to the "
                f"plain forward < {tol}")
    acc1 = engine.summarize(outs, 16)["acc1"]
    summary["ms_a_step"]["world1_bf16"] = statistics.median(
        scan_fn.step_ms[1:])
    summary["world1"] = {"cos": cos, "acc1": acc1}
    print(f"sp world 1 (NCCL), Uni3D-L, features' least cosine to the plain "
          f"forward {cos}; MODE-DOTA with residuals, 16 clouds captured: "
          f"acc@1 {acc1} (the plain scan {want[2]}), "
          f"{summary['ms_a_step']['world1_bf16']:.2f} ms a step (plain "
          f"{refs['ms']['plain_bf16']:.2f}); launches {launches}")
    del rank_model, encode, scan_fn, state, outs
    torch.cuda.empty_cache()
    inp["batch"] = dist_inputs(torch)["batch"]
    train_ref = refs.get("train_ref")
    if train_ref is None or not (tmp / "pp_train_ref.pt").exists():
        train_ref = pp_train_reference(torch, inp, tmp)
    times["a"] = time.perf_counter() - t0

    # (b) world 2 over gloo
    t0 = time.perf_counter()
    torch.save({k: (v.cpu() if hasattr(v, "cpu") else v)
                for k, v in inp.items()}, tmp / "sp_inputs.pt")

    def check_world2(ranks: list, tag: str) -> dict:
        res = {}
        resumed = sp_resume_at_world1(torch, inp, tmp,
                                      ranks[0]["train"]["depth2"])
        for r, out in enumerate(ranks):
            want_backend = "nccl" if "nccl" in tag else "gloo"
            if out["backend"] != want_backend:
                bad(f"sp world 2{tag}: rank {r} runs {out['backend']}")
            cos2 = {"uni3d": tp_min_cos(out["uni3d"], world1["uni3d"]),
                    "ulip": tp_min_cos(out["ulip"], ref["ulip"])}
            for k, c in cos2.items():
                if c < TP_COS_BF16:
                    bad(f"sp world 2{tag} rank {r}, {k}: features' least "
                        f"cosine {c:.6f} < {TP_COS_BF16}")
            d32 = float((out["uni3d_fp32"] - world1["uni3d_fp32"]).abs()
                        .max())
            fault = float((out["fault"] - world1["uni3d_fp32"]).abs().max())
            if d32 > SP_F32_ATOL or fault <= SP_F32_ATOL:
                bad(f"sp world 2{tag} rank {r}: fp32 features max |Δ| "
                    f"{d32:.3g} from world 1's, the planted fault "
                    f"{fault:.3g} (tolerance {SP_F32_ATOL})")
            st, tj = out["stream"], out["trajectory"]
            shifts = {g: q["shift"][0] for g, q in st["requests"].items()}
            if set(shifts.values()) != {24}:
                bad(f"sp world 2{tag} rank {r}: shifts a step {shifts} "
                    f"(expected 24)")
            d = float((tj["final_logits"] - ref["trajectory"][0]).abs()
                      .max())
            if not torch.allclose(tj["final_logits"], ref["trajectory"][0],
                                  rtol=TP_LOGITS, atol=TP_LOGITS) or \
                    not torch.equal(tj["correct"], ref["trajectory"][2]):
                bad(f"sp world 2{tag} rank {r}: fp32 trajectory logits max "
                    f"|Δ| {d:.3g} (tolerance {TP_LOGITS}), correct equal "
                    f"to one process's "
                    f"{torch.equal(tj['correct'], ref['trajectory'][2])}")
            if not {"fps", "knn"} <= set(out["ulip_launches"]):
                bad(f"sp world 2{tag} rank {r}: ULIP-2 launched "
                    f"{out['ulip_launches']}")
            tr = out["train"]
            loss_ok = all(abs(a - b) <= DP_LOSS_RTOL * abs(b) for a, b in
                          zip(tr["losses"], train_ref["losses"]))
            if not loss_ok or tr["within"] < 0.99 or \
                    resumed["within"] < 0.99:
                bad(f"sp world 2{tag} rank {r}: train losses {tr['losses']}"
                    f" against {train_ref['losses']}, {tr['within']:.4f} of "
                    f"the parameters within {DP_PARAM_ATOL}; resumed at "
                    f"world 1 {resumed['within']:.4f}")
            print(f"sp world 2{tag} rank {r}: least cosine (bf16 to world "
                  f"1, ULIP-2 to one process) {cos2}; fp32 features max |Δ| "
                  f"{d32:.3g} from world 1's, planted fault {fault:.3g}; "
                  f"fp32 trajectory logits max |Δ| {d:.3g} from one "
                  f"process's, correct equal; bf16 stream acc@1 "
                  f"{st['acc1']} (world 1 {summary['world1']['acc1']}, the "
                  f"plain scan {want[2]}), launches {st['launches']}, "
                  f"segments a step "
                  f"{st['segments']}, requests a step {st['requests']}, "
                  f"peak {st['peak_gb']:.2f} GB (one process "
                  f"{refs['peak_gb']:.2f} GB); ULIP-2 launches "
                  f"{out['ulip_launches']}; train: losses {tr['losses']} "
                  f"(one process {train_ref['losses']}), {tr['within']:.4f} "
                  f"of the parameters within {DP_PARAM_ATOL} (max |Δ| "
                  f"{tr['max_abs']:.3g}), ms a step {tr['ms']} (one process "
                  f"{train_ref['ms']}), peak {tr['peak_gb']:.2f} GB (one "
                  f"process {train_ref['peak_gb']:.2f} GB), launches "
                  f"{tr['launches']}; depth-2 checkpoint resumed at world 1: "
                  f"{resumed['within']:.4f} within {DP_PARAM_ATOL} of world "
                  f"2's uninterrupted run (max |Δ| {resumed['max_abs']:.3g})")
            res[f"rank{r}"] = {"cos": cos2, "fp32_max_abs": d32,
                               "fault_max_abs": fault,
                               "logits_max_abs": d, "acc1": st["acc1"],
                               "segments": st["segments"],
                               "requests": st["requests"],
                               "peak_gb": st["peak_gb"],
                               "launches": st["launches"],
                               "train": {k: tr[k] for k in (
                                   "losses", "ms", "peak_gb", "max_abs",
                                   "within", "launches")},
                               "resumed_at_world1": resumed}
        summary["ms_a_step"][f"world2_bf16{tag}"] = statistics.median(
            ranks[0]["stream"]["ms"][1:])
        return res

    summary["world2"] = check_world2(run_sp_world(tmp, 2), "")
    summary["one_process"] = {"peak_gb": refs["peak_gb"], "train": train_ref}
    times["b"] = time.perf_counter() - t0

    # (c) world 4 over gloo: SP × DP
    t0 = time.perf_counter()

    def check_world4(ranks: list, tag: str) -> None:
        for r, out in enumerate(ranks):
            c = tp_min_cos(out["sp_dp"], ref["depth2_fp32"])
            if c < TP_COS_F32 or out["sp_grid"] != (r % 2, r // 2):
                bad(f"sp × dp world 4{tag} rank {r}: least cosine {c:.6f}, "
                    f"grid {out['sp_grid']}")
            print(f"sp × dp world 4{tag} (data 2 × seq 2) rank {r}: least "
                  f"cosine to one process {c:.7f}; launches "
                  f"{out['sp_dp_launches']}")

    check_world4(refs.get("tp_world4") or run_sp_world(tmp, 4), "")
    times["c"] = time.perf_counter() - t0

    # (d) the CLI and the HTTP server at world 2 (with `cli`; else the
    # caller runs them beside phases 13's and 14's)
    if cli:
        t0 = time.perf_counter()
        summary["cli"] = run_tp_cli(tmp, torch, ("sp",))["sp"]
        times["d"] = time.perf_counter() - t0

    if torch.cuda.device_count() >= 2:
        t0 = time.perf_counter()
        summary["world2_nccl"] = check_world2(run_sp_world(tmp, 2, "nccl"),
                                              " (nccl)")
        if torch.cuda.device_count() >= 4:
            check_world4(refs.get("tp_world4_nccl")
                         or run_sp_world(tmp, 4, "nccl"), " (nccl)")
        times["nccl"] = time.perf_counter() - t0
    else:
        print("sp worlds over NCCL: not run, this machine has one card (the "
              "ranks shared it over gloo)")
    summary["seconds"] = time.perf_counter() - t_phase
    summary["part_seconds"] = times
    print(f"sp ms a step ({card}): " + ", ".join(
        f"{k} {v:.2f}" for k, v in summary["ms_a_step"].items()))
    print(f"phase sp: {summary['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in times.items()) + ")")
    if problems:
        fail(f"phase sp: {len(problems)} checks failed: "
             + "; ".join(problems))
    return launches, summary


_T_START = time.perf_counter()


def stamp(what: str) -> None:
    """Print the seconds since the script started, after `what`."""
    print(f"[{time.perf_counter() - _T_START:.1f} s] {what} done",
          flush=True)


def main() -> None:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dist-only", action="store_true",
                    help="build the kernels and run only the distributed "
                         "phases (the world of two over NCCL where the "
                         "machine has two cards or more)")
    ap.add_argument("--ep-only", action="store_true",
                    help="build the kernels and run only phase 12, the "
                         "class-sharded adaptation")
    ap.add_argument("--tp-only", action="store_true",
                    help="build the kernels and run only phase 13, the "
                         "tensor-parallel trunk")
    ap.add_argument("--pp-only", action="store_true",
                    help="build the kernels and run only phase 14, the "
                         "pipeline-parallel trunk")
    ap.add_argument("--sp-only", action="store_true",
                    help="build the kernels and run only phase 15, the "
                         "sequence-parallel trunk")
    args = ap.parse_args()
    dist_only = args.dist_only
    t_start = time.perf_counter()

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
        ptxas_report(name, log)
    check_gemm_sass()

    from uni_adapter_torch.cli.tta import set_numerics

    set_numerics()
    if args.sp_only:
        with tempfile.TemporaryDirectory() as tmp:
            sp_launches, sp_run = run_sp(Path(tmp), card)
        print(f"chip_smoke --sp-only total: "
              f"{time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"sp": sp_run, "launches": {"sp_world1":
                                                     sp_launches}}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if args.pp_only:
        with tempfile.TemporaryDirectory() as tmp:
            pp_launches, pp_run = run_pp(Path(tmp), card)
        print(f"chip_smoke --pp-only total: "
              f"{time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"pp": pp_run, "launches": {"pp_world1":
                                                     pp_launches}}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if args.tp_only:
        with tempfile.TemporaryDirectory() as tmp:
            tp_launches, tp_run = run_tp(Path(tmp), card)
        print(f"chip_smoke --tp-only total: "
              f"{time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"tp": tp_run, "launches": {"tp_world1":
                                                     tp_launches}}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if args.ep_only:
        with tempfile.TemporaryDirectory() as tmp:
            ep_launches, ep_run = run_ep(Path(tmp), card)
        print(f"chip_smoke --ep-only total: "
              f"{time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"ep": ep_run, "launches": {"ep_world1":
                                                     ep_launches}}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    if dist_only:
        with tempfile.TemporaryDirectory() as tmp:
            inputs = dist_inputs(torch)
            launches, dist_run, dp_ranks = run_dist_streams(Path(tmp), card,
                                                            inputs)
            dp_launches, dp_run = run_dp_pretraining(Path(tmp), card, inputs,
                                                     dp_ranks)
            ep_launches, ep_run = run_ep(Path(tmp), card, cli=False)
            refs = trunk_refs(torch)
            tp_launches, tp_run = run_tp(Path(tmp), card, refs, cli=False)
            pp_launches, pp_run = run_pp(Path(tmp), card, refs, cli=False)
            sp_launches, sp_run = run_sp(Path(tmp), card, refs, cli=False)
            run_clis(Path(tmp), torch, dp_run, ep_run,
                     {"tp": tp_run, "pp": pp_run, "sp": sp_run})
        print(f"chip_smoke --dist-only total: "
              f"{time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"dist_streams": dist_run, "dp_pretraining": dp_run,
                          "ep": ep_run, "tp": tp_run, "pp": pp_run,
                          "sp": sp_run,
                          "launches": {"dist_psum_world1": launches,
                                       "dp_pretrain_world1": dp_launches,
                                       "ep_world1": ep_launches,
                                       "tp_world1": tp_launches,
                                       "pp_world1": pp_launches,
                                       "sp_world1": sp_launches}}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = check_kernels(torch, gen)
    kernels.append(check_ballquery(torch, gen))
    check_ballquery_contract(torch, gen)
    kernels.append(check_eva_attention(torch, gen))
    kernels.append(check_attention_heads(torch, gen))
    kernels.append(check_knn_gather(torch, gen))
    check_knn_contract(torch, gen)
    kernels.append(check_fps_grid(torch, gen))
    check_fps_contract(torch, gen)
    kernels.append(check_attention_fp32(torch, gen))
    kernels.append(check_eva_attention_fp32(torch, gen))
    kernels.append(check_block_fp32(torch, gen))
    kernels.append(check_block_backward(torch, gen))
    kernels.append(check_attention_f32_tc(torch, gen))
    check_f32_routes(torch, gen)
    stamp("the kernels against their plain versions")
    block_errs = check_block_shapes(torch, gen)
    head_shards = check_block_head_shards(torch, gen)
    for k in kernels:
        if k["name"] in block_errs:
            k["max_abs_err"] = max(k["max_abs_err"], block_errs[k["name"]])
        shards = {shape: rec for shape, rec in head_shards.items()
                  if shape.split(" ")[0] == k["name"]}
        if shards:
            k["head_shards"] = shards
            k["max_abs_err"] = max(k["max_abs_err"], *(
                rec["max_abs_err"] for rec in shards.values()))
    check_float16_raises(torch)
    check_sweep_batch(torch, gen, kernels)
    stamp("the head shards, float16 and the sweep batch")
    for k in kernels:
        dev = ("" if k.get("device_ms") is None
               else f", device {k['device_ms']:.4f} ms")
        print(f"kernel {k['name']}: max_abs_err {k['max_abs_err']} | "
              f"{k['ms']:.4f} ms{dev} (plain {k['plain_ms']:.4f} ms, bound "
              f"{k['bound_ms']:.5f} ms by {k['bound_by']}, library "
              f"{k['library_ms']}, library device "
              f"{k.get('library_device_ms')})")
    check_features(torch, gen)
    check_features_fp32(torch, gen)
    by_path, batch1_ms, sweeps = {}, {}, {}
    by_path["openshape_rest"] = check_openshape_rest(torch, gen)
    by_path["pointnet"] = check_pointnet(torch, gen)
    stamp("features, OpenShape's rest, PointNet++")
    with tempfile.TemporaryDirectory() as tmp:
        for kind in PATHS:
            by_path[kind], batch1_ms[kind] = run_main_path(Path(tmp), kind)
        check_float16_cli(Path(tmp))
        by_path["uni3d_batch3_eager"] = run_short_last_batch(Path(tmp))
        by_path["uni3d_dota_profiled"] = run_profile_dir(Path(tmp))
        stamp("the main paths")
        for name, (_, path, extra, _) in SWEEPS.items():
            by_path[f"sweep_{name}"], sweeps[name] = run_sweep(
                Path(tmp), name, None if extra else batch1_ms[path], card)
        stamp("the sweeps")
        check_streams_equal_sequential(torch)
        check_cache_streams_equal_sequential(torch)
        scan_ms = check_scan(torch)
        scan_ms.update(check_variant_scans(torch))
        check_cache_card_vs_cpu(torch)
        dota_update_ms = check_variants_card_vs_cpu(torch)
        tier_ms = check_residual_tiers(torch, gen)
        stamp("streams, scans, cache and variants on the card and the CPU")
        by_path["continual_uni3d"] = run_continual(Path(tmp))
        for path in ("uni3d_dota", "uni3d_gmm", "uni3d_adaptive"):
            by_path[f"continual_{path}"] = run_continual(Path(tmp), 2, path)
        for kind in EXTRACT_PATHS:
            by_path[f"extract_{kind}"] = run_extraction(Path(tmp), kind)
        for kind in EXTRACT_PATHS:
            by_path[f"extract_{kind}_fp32"] = run_extraction_fp32(kind)
        stamp("continual and extraction")
        text_ms = check_text_tower(torch)
        load_s = check_loader(torch)
        by_path.update(run_loaded_path(Path(tmp)))
        stamp("the text tower and the loader")
        check_serving_equals_sequential(torch)
        by_path["serve_uni3d"], serving = run_serving(Path(tmp), card)
        by_path["uni3d_int8"], int8_ms = check_quant(torch, Path(tmp),
                                                     batch1_ms["uni3d"])
        stamp("serving and int8")
        check_grad_guard(torch)
        by_path["pretrain_uni3d"], pretraining = run_pretraining(Path(tmp),
                                                                 card)
        by_path["dvae"], dvae_run = run_dvae(torch)
        stamp("pretraining and the dVAE")
        inputs = dist_inputs(torch)
        by_path["dist_psum_world1"], dist_run, dp_ranks = run_dist_streams(
            Path(tmp), card, inputs)
        by_path["dp_pretrain_world1"], dp_run = run_dp_pretraining(
            Path(tmp), card, inputs, dp_ranks)
        by_path["cross_class"], cross_run = run_cross_class(Path(tmp), card)
        stamp("data parallelism and the cross-class analysis")
        by_path["ep_world1"], ep_run = run_ep(Path(tmp), card, cli=False)
        refs = trunk_refs(torch)
        by_path["tp_world1"], tp_run = run_tp(Path(tmp), card, refs,
                                              cli=False)
        by_path["pp_world1"], pp_run = run_pp(Path(tmp), card, refs,
                                              cli=False)
        by_path["sp_world1"], sp_run = run_sp(Path(tmp), card, refs,
                                              cli=False)
        del refs
        run_clis(Path(tmp), torch, dp_run, ep_run,
                 {"tp": tp_run, "pp": pp_run, "sp": sp_run})
        stamp("EP, TP, PP and SP, and the CLIs at world 2")
    for k in kernels:
        k["launches_by_path"] = {p: n[k["name"]] for p, n in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    print(f"chip_smoke total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"sweeps": sweeps, "residual_tier_product_ms": tier_ms,
                      "scan_ms": scan_ms, "dota_update_ms": dota_update_ms,
                      "text_tower": text_ms, "checkpoint_load_s": load_s,
                      "serving": serving, "pretraining": pretraining,
                      "dvae": dvae_run, "dist_streams": dist_run,
                      "dp_pretraining": dp_run, "cross_class": cross_run,
                      "ep": ep_run, "tp": tp_run, "pp": pp_run,
                      "sp": sp_run, "uni3d_int8_ms": {"uni3d_int8": int8_ms,
                                        "uni3d": batch1_ms["uni3d"]}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
