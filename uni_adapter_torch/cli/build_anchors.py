"""CLI: build a text-anchor bank (.npy) from a CLIP text tower (mirror of
`uni_adapter_tpu/cli/build_anchors.py`).

    python -m uni_adapter_torch.cli.build_anchors --text-preset uni3d \
        --clip-checkpoint open_clip.pt --labels-key objaverse_lvis_openshape \
        --out lvis_bank.npy [--device cuda|cpu]

Every class name of the labels.json key (or of `--dataset-name`'s key) in
every template of `--template-key` goes through the tower
(`anchors.clip_classifier`), `--batch-size` prompts a forward.  The tower
is random from `--seed` with `--clip-checkpoint` (a reference-layout torch
checkpoint, `models/loader.py`) laid over it; without one a warning says
that the bank only exercises the pipeline.  The output is a row-normalised
(K, D) float32 `.npy`, the layout `anchors.load_precomputed` reads (pass
its path as `--precomputed-text-features` to the evaluation CLI).
`--compare-to BANK.npy` adds the max abs difference to that bank to the
one-line JSON summary.  Runs on the GPU unless `--device cpu` is passed;
asked for `cuda` on a host without one, it raises.
"""
from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np
import torch

from uni_adapter_torch.anchors import clip_classifier
from uni_adapter_torch.cli.tta import resolve_device, set_numerics
from uni_adapter_torch.config import ASSETS_DIR, labels_key_for
from uni_adapter_torch.models.clip_text import create_text_encoder
from uni_adapter_torch.models.loader import load_checkpoint


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--text-preset", default="uni3d",
                    help="text tower preset (ulip / uni3d / "
                         "openshape_vitg14 / openshape_vitl14)")
    ap.add_argument("--clip-checkpoint", default=None,
                    help="reference-layout CLIP text checkpoint (torch .pt); "
                         "random weights and a warning without one")
    ap.add_argument("--labels-key", default=None,
                    help="labels.json key (e.g. modelnet40_openshape, "
                         "objaverse_lvis_openshape)")
    ap.add_argument("--dataset-name", default=None,
                    help="infer --labels-key from a dataset family name "
                         "(modelnet / scanobject / shapenet / lvis)")
    ap.add_argument("--template-key", default="modelnet40_64",
                    help="templates.json key (the 64-prompt ensemble)")
    ap.add_argument("--labels-path", default=None)
    ap.add_argument("--templates-path", default=None)
    ap.add_argument("--out", required=True, help="output .npy path")
    ap.add_argument("--batch-size", type=int, default=256,
                    help="prompts per text-tower forward (K*T in all)")
    ap.add_argument("--tower-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="the tower's compute dtype; the bank is fp32 "
                         "either way")
    ap.add_argument("--compare-to", default=None,
                    help="an existing bank (.npy): print the max abs diff")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if not args.labels_key and not args.dataset_name:
        ap.error("one of --labels-key or --dataset-name is required")
    return args


def main(argv=None) -> np.ndarray:
    """Build, save and summarise the bank; returns it as (K, D) float32."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_numerics()
    key = args.labels_key or labels_key_for(args.dataset_name)
    with open(args.labels_path
              or os.path.join(ASSETS_DIR, "labels.json")) as f:
        classnames = json.load(f)[key]
    with open(args.templates_path
              or os.path.join(ASSETS_DIR, "templates.json")) as f:
        templates = json.load(f)[args.template_key]

    tower = create_text_encoder(args.text_preset, device,
                                getattr(torch, args.tower_dtype),
                                seed=args.seed)
    if args.clip_checkpoint is None:
        logging.warning("no --clip-checkpoint: random text tower — the "
                        "bank exercises the pipeline but is not a usable "
                        "classifier")
    else:
        load_checkpoint(tower, args.clip_checkpoint)
    anchors = clip_classifier(classnames, templates, tower,
                              batch_size=args.batch_size,
                              device=device).cpu().numpy()
    # np.save appends .npy when absent; report the path that exists
    out = args.out if args.out.endswith(".npy") else args.out + ".npy"
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.save(out, anchors)

    summary = {"out": out, "labels_key": key, "K": anchors.shape[0],
               "D": anchors.shape[1], "templates": len(templates)}
    if args.compare_to:
        other = np.load(args.compare_to)
        summary["compare_to"] = args.compare_to
        summary["max_abs_diff"] = (
            float(np.abs(anchors - other).max())
            if other.shape == anchors.shape else "shape mismatch "
            f"{other.shape} vs {anchors.shape}")
    print(json.dumps(summary))
    return anchors


def cli() -> int:
    main()
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
