"""CLI: clean-vs-corrupted cross-class attention analysis (mirror of
`uni_adapter_tpu/cli/cross_class.py`).

    python -m uni_adapter_torch.cli.cross_class [--root DATA] \
        [--corruption gaussian] [--severities 1 2 3 4 5] \
        [--vlm3d uni3d|ulip|openshape] [--depth 24] [--checkpoint P.pt] \
        [--out outputs/cross_class] [--device cuda|cpu]

Sweeps severities of one corruption, builds per-class CLS-attention
centroids for the clean and each corrupted set, compares their distance
matrices and nearest-neighbour flips, embeds the displacement by exact
t-SNE (`utils/tsne.py`, on the device; the JAX CLI's is scikit-learn's
Barnes-Hut) and writes, under `--out`: `centroids_clean.npy`, per
severity `centroids_s{s}.npy` and `tsne_s{s}.npy`, `analysis.json`,
`analysis.log`, and the figures where matplotlib imports (the log says
when it does not).  Without `--root` it runs on synthetic per-class
clusters (the JAX CLI's, bitwise).  The backbone is built at its
published widths (`--depth` cuts Uni3D's) with random weights from seed
42, `--checkpoint` (a reference-layout torch checkpoint) laid over them.
Runs on the GPU unless `--device cpu` is passed; asked for `cuda` on a
host without one, it raises.
"""
from __future__ import annotations

import argparse
import importlib.util
import logging
import os

import numpy as np

from uni_adapter_torch.analysis import cross_class as X
from uni_adapter_torch.cli.tta import resolve_device, set_numerics
from uni_adapter_torch.config import Config, DataConfig, ModelConfig
from uni_adapter_torch.data.datasets import load_tta_dataset
from uni_adapter_torch.models.loader import build_backbone
from uni_adapter_torch.utils.logging import setup_logging

#: The seed of the JAX CLI's random weights (`init_or_load_params`).
WEIGHT_SEED = 42


def synthetic_class_set(n_classes: int = 6, per_class: int = 3,
                        npoints: int = 512, noise: float = 0.0,
                        noise_seed: int = 1):
    """Synthetic per-class clusters.  The class GEOMETRY (anchors + base
    points) is fixed (seed 0) so the clean and every corrupted severity
    share the same underlying classes — only the additive noise varies
    with `noise_seed`; otherwise the displacement analysis would measure a
    seed change, not corruption."""
    rng = np.random.default_rng(0)
    noise_rng = np.random.default_rng(1000 + noise_seed)
    pcs, labels = [], []
    for k in range(n_classes):
        anchor = rng.standard_normal(3)
        for _ in range(per_class):
            pts = rng.standard_normal((npoints, 3)).astype(np.float32)
            pts /= np.linalg.norm(pts, axis=1, keepdims=True)
            pts = pts * (0.4 + 0.1 * k) + anchor * 0.2
            pcs.append(pts + noise * noise_rng.standard_normal(pts.shape)
                       .astype(np.float32))
            labels.append(k)
    return np.stack(pcs), np.array(labels)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--root", default=None)
    parser.add_argument("--dataset-name", default="modelnet")
    parser.add_argument("--corruption", default="gaussian")
    parser.add_argument("--severities", type=int, nargs="*",
                        default=[1, 2, 3, 4, 5])
    parser.add_argument("--max-per-class", type=int, default=4)
    parser.add_argument("--out", default="outputs/cross_class")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--depth", type=int, default=24)
    parser.add_argument("--vlm3d", default="uni3d",
                        choices=["uni3d", "ulip", "openshape"])
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return parser.parse_args(argv)


def draw_figures(out: str, corruption: str, class_names, clean_cent,
                 per_severity: dict, progression: dict) -> None:
    """The JAX CLI's figure set: per severity the distance triptych, the
    most-confused pairs, the t-SNE displacement and the displacement
    magnitudes; the severity progression over two or more severities."""
    for s, (cent, mats, analysis, emb) in per_severity.items():
        X.plot_distance_matrices(mats, class_names,
                                 os.path.join(out, f"distance_s{s}.png"))
        X.visualize_top_confused_pairs(
            analysis, corruption, s,
            os.path.join(out, f"confused_pairs_s{s}.png"))
        X.visualize_tsne_with_displacement(
            clean_cent, cent, class_names, corruption, s,
            os.path.join(out, f"tsne_displacement_s{s}.png"), embedding=emb)
        X.visualize_displacement_magnitudes(
            clean_cent, cent, class_names, corruption, s,
            os.path.join(out, f"displacement_s{s}.png"))
    if len(progression) > 1:
        X.visualize_severity_progression(
            progression, class_names, corruption,
            os.path.join(out, "severity_progression.png"))


def main(argv=None) -> dict:
    """Run the analysis; returns {"clean": (K, G) centroids, "severities":
    {s: (centroids, distance matrices, top-confused analysis, (K, 2, 2)
    embedding)}, "figures": whether they were drawn}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_numerics()
    os.makedirs(args.out, exist_ok=True)
    setup_logging(os.path.join(args.out, "analysis.log"))

    mc = ModelConfig(vlm3d=args.vlm3d, eva_depth=args.depth)
    model, num_group, group_size = build_backbone(
        args.vlm3d, mc, device, seed=WEIGHT_SEED,
        checkpoint_path=args.checkpoint)

    if args.root:
        def load(severity, corruption=None):
            cfg = Config(data=DataConfig(
                root=args.root, dataset_name=args.dataset_name,
                corruption=corruption or args.corruption, severity=severity))
            ds = load_tta_dataset(cfg)
            pcs = [np.asarray(ds[i][0]) for i in range(len(ds))]
            labels = np.array([ds[i][1] for i in range(len(ds))])
            return np.stack(pcs), labels

        clean_pcs, clean_labels = load(1, "clean")
        class_names = load_tta_dataset(Config(data=DataConfig(
            root=args.root, dataset_name=args.dataset_name,
            corruption=args.corruption))).class_names
        sev_loader = load
    else:
        logging.info("no --root: synthetic class set")
        clean_pcs, clean_labels = synthetic_class_set()
        class_names = [f"class_{i}" for i in range(6)]

        def sev_loader(s):
            return synthetic_class_set(noise=0.05 * s, noise_seed=s)

    an = X.CrossClassAttentionAnalyzer(model, class_names,
                                       num_group=num_group,
                                       group_size=group_size,
                                       vlm3d=args.vlm3d)
    clean_pcs, clean_labels = X._subsample_per_class(clean_pcs, clean_labels,
                                                     args.max_per_class)
    clean_cent = an.class_centroids(clean_pcs, clean_labels)
    sweep = an.severity_sweep(sev_loader, args.severities,
                              args.max_per_class)

    results = {"severities": {}}
    progression, per_severity = {}, {}
    for s, cent in sweep.items():
        mats = an.distance_matrices(clean_cent, cent)
        conf = an.confusion_analysis(clean_cent, cent)
        emb = an.tsne_displacement(clean_cent, cent)
        analysis = X.top_confused_pairs(mats, class_names)
        progression[s] = {"analysis": analysis,
                          "clean_distances": mats["clean"],
                          "corrupted_distances": mats["corrupted"]}
        per_severity[s] = (cent, mats, analysis, emb)
        results["severities"][s] = {"confusion": conf,
                                    "top_confused": analysis}
        np.save(os.path.join(args.out, f"centroids_s{s}.npy"), cent)
        np.save(os.path.join(args.out, f"tsne_s{s}.npy"), emb)
        logging.info("severity %d: %d nearest-neighbour flips", s,
                     conf["n_flips"])
    figures = importlib.util.find_spec("matplotlib") is not None
    if figures:
        draw_figures(args.out, args.corruption, class_names, clean_cent,
                     per_severity, progression)
    else:
        logging.info("matplotlib does not import here: figures not drawn")
    np.save(os.path.join(args.out, "centroids_clean.npy"), clean_cent)
    an.save_results(args.out, results)
    logging.info("analysis written to %s", args.out)
    return {"clean": clean_cent, "severities": per_severity,
            "figures": figures}


def cli() -> int:
    """Console-script entry: exit 0 on success — main()'s return value is
    in-process API, not an exit code."""
    main()
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
