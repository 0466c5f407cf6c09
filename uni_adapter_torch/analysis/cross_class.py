"""Cross-class attention analysis: clean vs corrupted attention structure
(a copy of `uni_adapter_tpu/analysis/cross_class.py`).

Per-class CLS-attention centroids, cosine distance matrices clean vs
corrupted, confusion deltas and nearest-neighbour flips, t-SNE
displacement maps, severity 1–5 sweeps, and JSON + npy dumps.  The
attention comes from the port's `AttentionExtractor` (one batched forward
a chunk of samples, on the model's device: the Hopper kernels on the
card); the statistics are numpy, as in the JAX package.

The t-SNE is the port's own (`utils/tsne.py`, exact, on the model's
device) where the JAX package calls scikit-learn's Barnes-Hut `TSNE`: the
embedding is the exact objective's, not the approximation's.  The
figures import matplotlib lazily.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

import torch

from uni_adapter_torch.analysis.attention import AttentionExtractor
from uni_adapter_torch.utils.tsne import tsne


def _cosine_distance_matrix(x: np.ndarray) -> np.ndarray:
    n = x / (np.linalg.norm(x, axis=1, keepdims=True) + 1e-12)
    return 1.0 - n @ n.T


class CrossClassAttentionAnalyzer:
    """Compare per-class attention signatures between clean and corrupted
    streams (reference :48-198)."""

    def __init__(self, model: torch.nn.Module, class_names: List[str],
                 layer_idx: int = -1, num_group: int = 512,
                 group_size: int = 64, vlm3d: str = "uni3d"):
        self.extractor = AttentionExtractor(model, num_group, group_size,
                                            vlm3d=vlm3d)
        self.class_names = class_names
        self.layer_idx = layer_idx

    def class_centroids(self, pcs: np.ndarray, labels: np.ndarray,
                        batch_size: int = 16) -> np.ndarray:
        """(K, G) per-class mean CLS-attention signature
        (reference :175-198).  Samples run through the extractor in
        batches (one batched forward a chunk, chunked to bound the
        (B, H, N, N) map memory); only the layer's CLS rows reach the
        host."""
        pcs = np.asarray(pcs)
        labels = np.asarray(labels)
        if len(pcs) == 0:
            raise ValueError("class_centroids: empty sample set "
                             "(load_fn returned no samples)")
        K = len(self.class_names)
        sums, counts = None, np.zeros(K)
        for i in range(0, len(pcs), batch_size):
            chunk = pcs[i:i + batch_size]
            sigs = self.extractor.cls_attention_of(
                chunk, self.layer_idx).mean(1)
            if sums is None:
                sums = np.zeros((K, sigs.shape[1]))
            for sig, lab in zip(sigs, labels[i:i + batch_size]):
                sums[int(lab)] += sig
                counts[int(lab)] += 1
        if (counts == 0).any():
            # an all-zero centroid is a phantom class: it sits at cosine
            # distance exactly 1.0 from everything and silently contaminates
            # flips / confused pairs / t-SNE — fail loud instead
            missing = [self.class_names[k] for k in np.where(counts == 0)[0]]
            raise ValueError(
                f"class_centroids: no samples for classes {missing}; "
                f"pass a class_names list restricted to the classes present")
        return sums / counts[:, None]

    def distance_matrices(self, clean_centroids: np.ndarray,
                          corrupted_centroids: np.ndarray) -> Dict:
        """Cosine distance matrices + their delta (reference :200-232)."""
        d_clean = _cosine_distance_matrix(clean_centroids)
        d_corr = _cosine_distance_matrix(corrupted_centroids)
        return {"clean": d_clean, "corrupted": d_corr,
                "delta": d_corr - d_clean}

    def confusion_analysis(self, clean_centroids: np.ndarray,
                           corrupted_centroids: np.ndarray) -> Dict:
        """Nearest-neighbour structure + flips under corruption
        (reference :234-314)."""
        def nn(c):
            d = _cosine_distance_matrix(c)
            np.fill_diagonal(d, np.inf)
            return d.argmin(1)

        nn_clean, nn_corr = nn(clean_centroids), nn(corrupted_centroids)
        flips = [
            {"class": self.class_names[k],
             "clean_nn": self.class_names[nn_clean[k]],
             "corrupted_nn": self.class_names[nn_corr[k]]}
            for k in range(len(self.class_names)) if nn_clean[k] != nn_corr[k]
        ]
        return {"nn_clean": nn_clean.tolist(), "nn_corrupted": nn_corr.tolist(),
                "flips": flips, "n_flips": len(flips)}

    def tsne_displacement(self, clean_centroids: np.ndarray,
                          corrupted_centroids: np.ndarray,
                          seed: int = 0) -> np.ndarray:
        """Joint t-SNE embedding of clean+corrupted centroids, returning
        (K, 2, 2) [clean_xy, corrupted_xy] (reference t-SNE displacement):
        exact t-SNE (`utils/tsne.py`) from the PCA init, on the model's
        device.  `seed` is the JAX signature's; the exact method from the
        PCA init draws nothing."""
        del seed
        return _joint_tsne(clean_centroids, corrupted_centroids,
                           self.extractor.device)

    def severity_sweep(self, load_fn, severities=range(1, 6),
                       max_per_class: int = 4) -> Dict[int, np.ndarray]:
        """Per-severity centroids; load_fn(severity) -> (pcs, labels)
        (reference :617-716 severity loop)."""
        out = {}
        for s in severities:
            pcs, labels = load_fn(s)
            pcs, labels = _subsample_per_class(pcs, labels, max_per_class)
            out[int(s)] = self.class_centroids(pcs, labels)
        return out

    def save_results(self, out_dir: str, results: Dict) -> None:
        """JSON for scalars/lists, npy for arrays (reference :716-788)."""
        os.makedirs(out_dir, exist_ok=True)
        scalars, arrays = {}, {}
        for k, v in results.items():
            if isinstance(v, np.ndarray):
                arrays[k] = v
            elif isinstance(v, dict) and any(isinstance(x, np.ndarray)
                                             for x in v.values()):
                for kk, vv in v.items():
                    if isinstance(vv, np.ndarray):
                        arrays[f"{k}_{kk}"] = vv
                    else:
                        scalars.setdefault(k, {})[kk] = vv
            else:
                scalars[k] = v
        with open(os.path.join(out_dir, "analysis.json"), "w") as f:
            json.dump(scalars, f, indent=2, default=str)
        for k, v in arrays.items():
            np.save(os.path.join(out_dir, f"{k}.npy"), v)


def _joint_tsne(clean: np.ndarray, corrupted: np.ndarray,
                device="cpu") -> np.ndarray:
    """(K, 2, 2) exact t-SNE of the 2K centroids, perplexity
    max(2, min(30, K − 1)) as the JAX package's."""
    K = clean.shape[0]
    joint = torch.as_tensor(np.concatenate([clean, corrupted], 0),
                            dtype=torch.float64, device=device)
    emb = tsne(joint, perplexity=max(2, min(30, K - 1)))["embedding"]
    emb = emb.cpu().numpy()
    return np.stack([emb[:K], emb[K:]], axis=1)


def _subsample_per_class(pcs, labels, max_per_class: int):
    labels = np.asarray(labels)
    keep = []
    for k in np.unique(labels):
        idx = np.where(labels == k)[0][:max_per_class]
        keep.extend(idx.tolist())
    keep = np.array(keep)
    return np.asarray(pcs)[keep], labels[keep]


def top_confused_pairs(matrices: Dict, class_names: List[str],
                       top_k: int = 10) -> Dict:
    """Pairs whose distance SHRINKS most under corruption — the classes
    corruption pushes toward each other (reference
    cross_class_attention_analysis.py:234-314 analysis dict)."""
    delta = matrices["delta"]
    K = delta.shape[0]
    iu = np.triu_indices(K, k=1)
    order = np.argsort(delta[iu])           # most negative change first
    pairs = []
    for n in order[:top_k]:
        i, j = iu[0][n], iu[1][n]
        pairs.append({
            "class_i": class_names[i], "class_j": class_names[j],
            "class_i_idx": int(i), "class_j_idx": int(j),
            "clean_distance": float(matrices["clean"][i, j]),
            "corrupted_distance": float(matrices["corrupted"][i, j]),
            "distance_change": float(delta[i, j]),
        })
    nn_clean = _nn_indices(matrices["clean"])
    nn_corr = _nn_indices(matrices["corrupted"])
    return {
        "top_confused_pairs": pairs,
        "mean_distance_change": float(delta[iu].mean()),
        "neighbor_change_ratio": float((nn_clean != nn_corr).mean()),
    }


def _nn_indices(d: np.ndarray) -> np.ndarray:
    d = d.copy()
    np.fill_diagonal(d, np.inf)
    return d.argmin(1)


from uni_adapter_torch.analysis.attention import _plt  # shared Agg bootstrap


def _save(fig, save_path):
    import matplotlib.pyplot as plt
    if save_path:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
        fig.savefig(save_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return save_path


def visualize_top_confused_pairs(analysis: Dict, corruption: str,
                                 severity: int,
                                 save_path: Optional[str] = None):
    """Grouped clean/corrupted distance bars for the most-confused pairs
    (reference cross_class_attention_analysis.py:372-413)."""
    plt = _plt()
    pairs = analysis["top_confused_pairs"]
    labels = [f"{p['class_i']}\n↔\n{p['class_j']}" for p in pairs]
    x = np.arange(len(pairs))
    fig, ax = plt.subplots(figsize=(12, 6))
    ax.bar(x - 0.2, [p["clean_distance"] for p in pairs], 0.4,
           label="Clean", color="steelblue")
    ax.bar(x + 0.2, [p["corrupted_distance"] for p in pairs], 0.4,
           label="Corrupted", color="coral")
    for i, p in enumerate(pairs):
        top = max(p["clean_distance"], p["corrupted_distance"])
        ax.annotate(f"{p['distance_change']:+.3f}", xy=(i, top + 0.01),
                    ha="center", fontsize=8,
                    color="red" if p["distance_change"] < 0 else "green")
    ax.set_xticks(x)
    ax.set_xticklabels(labels, fontsize=8)
    ax.set_ylabel("Cosine Distance")
    ax.set_title(f"Top {len(pairs)} Most Confused Class Pairs\n"
                 f"{corruption} severity {severity}")
    ax.legend()
    ax.grid(alpha=0.3, axis="y")
    fig.tight_layout()
    return _save(fig, save_path)


def visualize_tsne_with_displacement(clean_centroids: np.ndarray,
                                     corrupted_centroids: np.ndarray,
                                     class_names: List[str],
                                     corruption: str, severity: int,
                                     save_path: Optional[str] = None,
                                     seed: int = 0,
                                     embedding: Optional[np.ndarray] = None):
    """Joint t-SNE of clean (circles) and corrupted (triangles) centroids
    with clean→corrupted displacement arrows (reference :416-497).

    Pass `embedding` (the (K, 2, 2) result of
    CrossClassAttentionAnalyzer.tsne_displacement) to plot EXACTLY the
    coordinates that were saved to npy; otherwise the same exact t-SNE
    runs here, on the CPU (deterministic: the same coordinates)."""
    plt = _plt()
    K = len(class_names)
    del seed
    if embedding is None:
        embedding = _joint_tsne(clean_centroids, corrupted_centroids)
    ce, xe = embedding[:, 0], embedding[:, 1]
    fig, ax = plt.subplots(figsize=(12, 9))
    cmap = plt.cm.tab20 if K <= 20 else plt.cm.rainbow
    colors = cmap(np.linspace(0, 1, min(20, K) if K <= 20 else K))
    for i in range(K):
        c = [colors[i % len(colors)]]
        ax.scatter(*ce[i], c=c, s=90, marker="o", edgecolors="black",
                   linewidth=1, alpha=0.85)
        ax.scatter(*xe[i], c=c, s=90, marker="^", edgecolors="black",
                   linewidth=1, alpha=0.85)
        ax.annotate("", xy=tuple(xe[i]), xytext=tuple(ce[i]),
                    arrowprops=dict(arrowstyle="->", color="gray",
                                    alpha=0.5, lw=1))
        ax.annotate(class_names[i], tuple(ce[i]), fontsize=7, ha="center",
                    va="bottom", alpha=0.8)
    ax.scatter([], [], c="gray", s=90, marker="o", label="Clean")
    ax.scatter([], [], c="gray", s=90, marker="^", label="Corrupted")
    ax.legend(loc="upper right")
    ax.set_title(f"t-SNE of Class Attention Centroids\n{corruption} "
                 f"severity {severity} (arrows: clean → corrupted)")
    ax.set_xlabel("t-SNE 1")
    ax.set_ylabel("t-SNE 2")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    return _save(fig, save_path)


def visualize_displacement_magnitudes(clean_centroids: np.ndarray,
                                      corrupted_centroids: np.ndarray,
                                      class_names: List[str],
                                      corruption: str, severity: int,
                                      save_path: Optional[str] = None):
    """Sorted horizontal bars of per-class centroid displacement
    (reference :499-536)."""
    plt = _plt()
    disp = np.linalg.norm(corrupted_centroids - clean_centroids, axis=1)
    order = np.argsort(disp)[::-1]
    fig, ax = plt.subplots(figsize=(11, max(4, 0.28 * len(class_names))))
    colors = plt.cm.RdYlGn_r(disp[order] / (disp.max() + 1e-12))
    bars = ax.barh(range(len(class_names)), disp[order], color=colors)
    ax.set_yticks(range(len(class_names)))
    ax.set_yticklabels([class_names[i] for i in order], fontsize=8)
    ax.invert_yaxis()
    for idx, bar in zip(order, bars):
        ax.text(bar.get_width() + disp.max() * 0.01,
                bar.get_y() + bar.get_height() / 2, f"{disp[idx]:.4f}",
                va="center", fontsize=7)
    ax.set_xlabel("Displacement magnitude (L2 in attention space)")
    ax.set_title(f"Class Displacement Under {corruption} "
                 f"(severity {severity})\nhigher = more affected")
    ax.grid(alpha=0.3, axis="x")
    fig.tight_layout()
    return _save(fig, save_path)


def visualize_severity_progression(all_results: Dict[int, Dict],
                                   class_names: List[str], corruption: str,
                                   save_path: Optional[str] = None):
    """2×2 severity-sweep panel (reference :538-616): mean distance change,
    NN-flip ratio, the top pair's distance trend, and a top-pair × severity
    change heatmap.

    Args:
      all_results: {severity: {"analysis": top_confused_pairs() dict,
        "clean_distances": (K,K), "corrupted_distances": (K,K)}}.
    """
    plt = _plt()
    sev = sorted(all_results)
    top_sev = sev[-1]
    fig, axes = plt.subplots(2, 2, figsize=(13, 9))

    axes[0][0].plot(sev, [all_results[s]["analysis"]["mean_distance_change"]
                          for s in sev], "o-", color="coral", lw=2)
    axes[0][0].axhline(0, color="black", ls="--", alpha=0.5)
    axes[0][0].set_xlabel("Severity")
    axes[0][0].set_title("Mean Distance Change\n(negative = classes closer)")
    axes[0][0].grid(alpha=0.3)

    axes[0][1].plot(sev, [all_results[s]["analysis"]["neighbor_change_ratio"]
                          for s in sev], "s-", color="steelblue", lw=2)
    axes[0][1].set_ylim(0, 1)
    axes[0][1].set_xlabel("Severity")
    axes[0][1].set_title("Nearest-Neighbor Instability")
    axes[0][1].grid(alpha=0.3)

    top = all_results[top_sev]["analysis"]["top_confused_pairs"][0]
    i, j = top["class_i_idx"], top["class_j_idx"]
    axes[1][0].plot(sev, [all_results[s]["clean_distances"][i, j]
                          for s in sev], "o--", label="Clean", color="green",
                    alpha=0.7)
    axes[1][0].plot(sev, [all_results[s]["corrupted_distances"][i, j]
                          for s in sev], "s-", label="Corrupted", color="red",
                    lw=2)
    axes[1][0].set_xlabel("Severity")
    axes[1][0].set_ylabel("Cosine Distance")
    axes[1][0].set_title(
        f"Most Confused Pair: {top['class_i']} ↔ {top['class_j']}")
    axes[1][0].legend()
    axes[1][0].grid(alpha=0.3)

    pairs = all_results[top_sev]["analysis"]["top_confused_pairs"]
    change = np.array([[all_results[s]["corrupted_distances"][p["class_i_idx"],
                                                              p["class_j_idx"]]
                        - all_results[s]["clean_distances"][p["class_i_idx"],
                                                            p["class_j_idx"]]
                        for s in sev] for p in pairs])
    lim = np.abs(change).max() + 1e-12
    im = axes[1][1].imshow(change, cmap="RdBu_r", aspect="auto",
                           vmin=-lim, vmax=lim)
    axes[1][1].set_xticks(range(len(sev)))
    axes[1][1].set_xticklabels(sev)
    axes[1][1].set_yticks(range(len(pairs)))
    axes[1][1].set_yticklabels(
        [f"{p['class_i'][:8]}↔{p['class_j'][:8]}" for p in pairs], fontsize=7)
    axes[1][1].set_xlabel("Severity")
    axes[1][1].set_title("Distance Change for Top Pairs (red = closer)")
    fig.colorbar(im, ax=axes[1][1], fraction=0.046)

    fig.suptitle(f"{corruption}: Severity Progression Analysis")
    fig.tight_layout()
    return _save(fig, save_path)


def plot_distance_matrices(matrices: Dict, class_names: List[str],
                           save_path: Optional[str] = None):
    """Clean / corrupted / delta heatmap triptych (reference figures)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 3, figsize=(18, 5))
    for ax, key in zip(axes, ["clean", "corrupted", "delta"]):
        im = ax.imshow(matrices[key],
                       cmap="coolwarm" if key == "delta" else "viridis")
        ax.set_title(f"{key} cosine distance")
        fig.colorbar(im, ax=ax, shrink=0.8)
    fig.tight_layout()
    return _save(fig, save_path)
