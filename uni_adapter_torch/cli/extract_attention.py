"""Attention-map extraction CLI (mirror of
`uni_adapter_tpu/cli/extract_attention.py`).

    python -m uni_adapter_torch.cli.extract_attention --vlm3d uni3d \
        [--depth 24] [--root DATA --corruption uniform] \
        [--checkpoint POINT.pt] [--device cuda|cpu]

Builds the backbone at its published widths (`--depth` cuts Uni3D's, as
in the JAX CLI), feeds it one sample (from the corrupted dataset under
`--root`, the synthetic unit sphere otherwise), extracts every layer's
attention map and writes, under `--out`: `attention_maps.npz`,
`attention_stats.json`, `extract.log` and the figures (per-layer/head
heatmaps, head-averaged maps, CLS evolution, per-head grid, layer
evolution, the 3D views).  Runs on the GPU unless `--device cpu` is
passed; asked for `cuda` on a host without one, it raises.  The weights
are random from seed 42 with `--checkpoint` (a reference-layout torch
checkpoint, `models/loader.py`) laid over them; without one the maps show
that the path ran, not what a trained model attends to.

`extract` is the device half (model, extraction, statistics, the .npz);
`main` calls it, then draws the figures on the host.
"""
from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

from uni_adapter_torch.analysis import attention as A
from uni_adapter_torch.cli.tta import resolve_device, set_numerics
from uni_adapter_torch.config import Config, DataConfig, ModelConfig
from uni_adapter_torch.data.datasets import load_tta_dataset
from uni_adapter_torch.models.loader import build_backbone
from uni_adapter_torch.utils.logging import setup_logging

#: The seed of the JAX CLI's random weights (`init_or_load_params`).
WEIGHT_SEED = 42


def synthetic_sphere(npoints: int = 1024, seed: int = 0) -> np.ndarray:
    """Unit-sphere fallback sample (the JAX CLI's)."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((npoints, 3)).astype(np.float32)
    return pts / np.linalg.norm(pts, axis=1, keepdims=True)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root", default=None, help="corrupted-dataset root")
    parser.add_argument("--dataset-name", default="modelnet")
    parser.add_argument("--corruption", default="uniform")
    parser.add_argument("--severity", type=int, default=5)
    parser.add_argument("--sample-idx", type=int, default=0)
    parser.add_argument("--out", default="outputs/attention")
    parser.add_argument("--layers", type=int, nargs="*", default=None)
    parser.add_argument("--heads", type=int, nargs="*", default=[0, 1])
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--depth", type=int, default=24,
                        help="Uni3D's EVA depth (the others keep theirs)")
    parser.add_argument("--vlm3d", default="uni3d",
                        choices=["uni3d", "ulip", "openshape"])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return parser.parse_args(argv)


def extract(args: argparse.Namespace):
    """The device half: build the model, extract one sample's maps, write
    `attention_stats.json` and `attention_maps.npz` under `args.out`.
    Returns (extractor, point cloud, maps)."""
    device = resolve_device(args.device)
    set_numerics()
    os.makedirs(args.out, exist_ok=True)
    mc = ModelConfig(vlm3d=args.vlm3d, eva_depth=args.depth)
    model, num_group, group_size = build_backbone(
        args.vlm3d, mc, device, seed=WEIGHT_SEED,
        checkpoint_path=args.checkpoint)
    if args.root:
        cfg = Config(data=DataConfig(root=args.root,
                                     dataset_name=args.dataset_name,
                                     corruption=args.corruption,
                                     severity=args.severity))
        pc, _, name, _ = load_tta_dataset(cfg)[args.sample_idx]
        logging.info("sample %d: class %s", args.sample_idx, name)
    else:
        pc = synthetic_sphere()
        logging.info("no --root given: using the synthetic sphere")

    extractor = A.AttentionExtractor(model, num_group, group_size,
                                     vlm3d=args.vlm3d)
    maps = extractor.extract(pc)
    logging.info("extracted %d layers, map shape %s", len(maps),
                 maps["layer_0"].shape)
    with open(os.path.join(args.out, "attention_stats.json"), "w") as f:
        json.dump(A.attention_statistics(maps), f, indent=2)
    np.savez(os.path.join(args.out, "attention_maps.npz"), **maps)
    return extractor, pc, maps


def draw_figures(args: argparse.Namespace, extractor, pc, maps) -> None:
    """The host half: the JAX CLI's figure set, from the extracted maps."""
    out = args.out
    A.visualize_attention_maps(maps, args.layers, args.heads,
                               os.path.join(out, "attention_maps.png"))
    A.visualize_head_averaged(maps, os.path.join(out, "head_averaged.png"))
    A.visualize_cls_evolution(maps, os.path.join(out, "cls_evolution.png"))
    A.visualize_per_head_grid(maps, -1, os.path.join(out, "per_head_grid.png"))
    A.visualize_layer_evolution(maps, 0,
                                os.path.join(out, "layer_evolution.png"))
    A.visualize_attention_3d(extractor, pc, -1,
                             os.path.join(out, "attention_3d.html"))

    centers = extractor.get_group_centers(pc)[0]
    cls_attn = extractor.get_cls_attention(-1)[0]          # (H, G)
    A.visualize_attention_on_pointcloud(
        pc, cls_attn.mean(0), centers,
        title="CLS attention (last layer, head-averaged)",
        save_path=os.path.join(out, "attention_on_pointcloud.html"))
    A.visualize_attention_heads_on_pointcloud(
        pc, cls_attn, centers,
        save_path=os.path.join(out, "attention_heads_on_pointcloud"))
    A.visualize_layer_attention_on_pointcloud_grid(
        maps, pc, centers, args.layers,
        save_path=os.path.join(out, "layer_attention_grid"))


def main(argv=None):
    """Extract, then draw; returns what `extract` returns."""
    args = parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    setup_logging(os.path.join(args.out, "extract.log"))
    extractor, pc, maps = extract(args)
    draw_figures(args, extractor, pc, maps)
    logging.info("wrote figures + npz to %s", args.out)
    return extractor, pc, maps


def cli() -> int:
    main()
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
