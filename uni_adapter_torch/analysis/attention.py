"""Attention-map extraction and its figures (a copy of
`uni_adapter_tpu/analysis/attention.py`).

The blocks of all three backbones return their attention maps when asked
(`return_attn=True` through `models/common.py`), so extraction is one
forward under `torch.no_grad()`: the block outputs come from the
(B, H, N, hd) attention (`ops/attention_heads.py`, the Hopper kernel on the
card), the maps from `common.attn_probs`, and the maps reach the host once,
at the end, as fp32 numpy.  The statistics are numpy; the figures are
numpy + matplotlib (imported lazily) and plotly where it imports.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from uni_adapter_torch.ops.geometry import group_points


class AttentionExtractor:
    """Extract per-layer attention maps from a Uni3D, ULIP-2 or OpenShape
    model: extract → {layer_i: (B, H, N, N)}, CLS getters, group centers.

    The model holds its weights and its device: inputs go to the device of
    its parameters, so a model on the card runs there (kernels), one on
    the CPU runs the plain versions.
    """

    def __init__(self, model: torch.nn.Module, num_group: int = 512,
                 group_size: int = 64, vlm3d: str = "uni3d"):
        """Args:
          vlm3d: backbone kind — selects the forward-call convention
            (the JAX extractor's): 'uni3d' consumes xyz‖color, 'ulip' xyz
            only, 'openshape' (xyz, xyz‖color).
        """
        self.model = model
        self.num_group = num_group
        self.group_size = group_size
        self.vlm3d = vlm3d
        self.attention_maps: Dict[str, np.ndarray] = {}
        if vlm3d == "uni3d":
            self._forward = lambda pc: model(pc, return_attn=True)
        elif vlm3d == "ulip":
            self._forward = lambda pc: model(pc[:, :, :3], return_attn=True)
        elif vlm3d == "openshape":
            self._forward = lambda pc: model(pc[:, :, :3], pc,
                                             return_attn=True)
        else:
            raise ValueError(f"unknown vlm3d {vlm3d!r}")

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _cloud(self, point_cloud) -> torch.Tensor:
        pc = torch.as_tensor(np.asarray(point_cloud, np.float32),
                             device=self.device)
        return pc[None] if pc.dim() == 2 else pc

    def extract(self, point_cloud: np.ndarray) -> Dict[str, np.ndarray]:
        """Run one forward, stash every layer's (B, H, N, N) attention."""
        pc = self._cloud(point_cloud)
        if pc.shape[-1] == 3:   # xyz only → ones color, reference convention
            pc = torch.cat([pc, torch.ones_like(pc)], dim=-1)
        with torch.no_grad():
            _, attns = self._forward(pc)
            host = torch.stack(attns).to(torch.float32).cpu().numpy()
        self.attention_maps = {f"layer_{i}": a for i, a in enumerate(host)}
        self.num_layers = len(attns)
        return self.attention_maps

    def cls_attention_of(self, point_cloud, layer_idx: int = -1) -> np.ndarray:
        """One forward's attention from the CLS token to the group tokens
        at one layer, (B, H, G): what `extract` then
        `get_cls_attention(layer_idx)` give, with only that row of that
        layer brought to the host (the cross-class analysis needs no
        more)."""
        pc = self._cloud(point_cloud)
        if pc.shape[-1] == 3:
            pc = torch.cat([pc, torch.ones_like(pc)], dim=-1)
        with torch.no_grad():
            _, attns = self._forward(pc)
            row = attns[layer_idx][:, :, 0, 1:]
            return row.to(torch.float32).cpu().numpy()

    def _layer_map(self, layer_idx: int) -> np.ndarray:
        if not self.attention_maps:
            raise ValueError("No attention maps. Run extract() first.")
        if layer_idx == -1:
            layer_idx = self.num_layers - 1
        key = f"layer_{layer_idx}"
        if key not in self.attention_maps:
            raise ValueError(f"Layer {layer_idx} attention not found "
                             f"(have {len(self.attention_maps)} layers).")
        return self.attention_maps[key]

    def get_cls_attention(self, layer_idx: int = -1) -> np.ndarray:
        """Attention FROM the CLS token to all group tokens, (B, H, G)."""
        return self._layer_map(layer_idx)[:, :, 0, 1:]

    def get_attention_to_cls(self, layer_idx: int = -1) -> np.ndarray:
        """Attention from each token TO the CLS token, (B, H, G)."""
        return self._layer_map(layer_idx)[:, :, 1:, 0]

    def get_group_centers(self, point_cloud: np.ndarray) -> np.ndarray:
        """FPS group centers aligned with the attention tokens (the port's
        `group_points`, on its kernels on the card)."""
        xyz = self._cloud(point_cloud)[:, :, :3]
        _, centers, _ = group_points(xyz, None, self.num_group,
                                     self.group_size)
        return centers.cpu().numpy()


def attention_entropy(attn: np.ndarray) -> np.ndarray:
    """Row entropy of attention distributions (reference CLS-evolution
    stats, extract_attention.py:"entropy/sparsity")."""
    p = attn / (attn.sum(-1, keepdims=True) + 1e-12)
    return -(p * np.log(p + 1e-12)).sum(-1)


def attention_sparsity(attn: np.ndarray, threshold: float = 0.01) -> np.ndarray:
    """Fraction of attention weights below threshold."""
    return (attn < threshold).mean(-1)


def cls_attention_evolution(maps: Dict[str, np.ndarray]) -> np.ndarray:
    """(L, G) head-averaged CLS attention per layer, for evolution plots."""
    layers = sorted(maps, key=lambda k: int(k.split("_")[1]))
    return np.stack([maps[k][:, :, 0, 1:].mean(axis=(0, 1)) for k in layers])


# ---------------------------------------------------------------------------
# Visualizations (matplotlib, Agg backend)
# ---------------------------------------------------------------------------

def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _save_fig(fig, save_path, plt, dpi: int = 110):
    """Shared save/close boilerplate for every figure family (the
    cross_class analogue is cross_class._save)."""
    if save_path:
        os.makedirs(os.path.dirname(os.path.abspath(save_path)),
                    exist_ok=True)
        fig.savefig(save_path, dpi=dpi)
    plt.close(fig)
    return save_path


def _write_plotly_html(fig, save_path):
    """Shared plotly-branch writer: same .html suffix + parent-dir creation
    convention as every matplotlib/canvas fallback path in this module."""
    if not save_path.lower().endswith(".html"):
        save_path += ".html"
    os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
    fig.write_html(save_path)
    return save_path


def _resolve_layers(attention_maps: Dict[str, np.ndarray],
                    layer_indices) -> List[int]:
    """Normalise layer indices (negative = from the end, matching
    _layer_map's -1 convention) and validate against the available maps."""
    n = len(attention_maps)
    out = []
    for i in layer_indices:
        li = i + n if i < 0 else i
        if f"layer_{li}" not in attention_maps:
            raise ValueError(f"Layer {i} attention not found "
                             f"(have {n} layers).")
        out.append(li)
    return out


def visualize_attention_maps(attention_maps: Dict[str, np.ndarray],
                             layer_indices: Optional[List[int]] = None,
                             head_indices: Optional[List[int]] = None,
                             save_path: Optional[str] = None,
                             figsize: Tuple[int, int] = (16, 12),
                             cmap: str = "viridis"):
    """Per-layer/head heatmap grid (reference :321-420)."""
    plt = _plt()
    layers = sorted(attention_maps, key=lambda k: int(k.split("_")[1]))
    if layer_indices is not None:
        layers = [f"layer_{i}"
                  for i in _resolve_layers(attention_maps, layer_indices)]
    heads = head_indices or [0]
    fig, axes = plt.subplots(len(layers), len(heads), figsize=figsize,
                             squeeze=False)
    for r, lk in enumerate(layers):
        for c, h in enumerate(heads):
            axes[r][c].imshow(attention_maps[lk][0, h], cmap=cmap)
            axes[r][c].set_title(f"{lk} head {h}", fontsize=8)
            axes[r][c].axis("off")
    fig.tight_layout()
    return _save_fig(fig, save_path, plt)


def visualize_head_averaged(attention_maps: Dict[str, np.ndarray],
                            save_path: Optional[str] = None,
                            cmap: str = "viridis"):
    """Head-averaged attention per layer (reference :423-...)."""
    plt = _plt()
    layers = sorted(attention_maps, key=lambda k: int(k.split("_")[1]))
    n = len(layers)
    cols = min(n, 6)
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows),
                             squeeze=False)
    for i, lk in enumerate(layers):
        ax = axes[i // cols][i % cols]
        ax.imshow(attention_maps[lk][0].mean(0), cmap=cmap)
        ax.set_title(lk, fontsize=8)
        ax.axis("off")
    for j in range(n, rows * cols):
        axes[j // cols][j % cols].axis("off")
    fig.tight_layout()
    return _save_fig(fig, save_path, plt)


def visualize_cls_evolution(attention_maps: Dict[str, np.ndarray],
                            save_path: Optional[str] = None):
    """CLS-attention evolution heatmap + entropy/sparsity curves
    (reference CLS-evolution block)."""
    plt = _plt()
    evo = cls_attention_evolution(attention_maps)          # (L, G)
    fig, axes = plt.subplots(1, 3, figsize=(16, 4))
    axes[0].imshow(evo, aspect="auto", cmap="viridis")
    axes[0].set_xlabel("group token")
    axes[0].set_ylabel("layer")
    axes[0].set_title("CLS attention evolution")
    axes[1].plot(attention_entropy(evo))
    axes[1].set_title("entropy per layer")
    axes[2].plot(attention_sparsity(evo))
    axes[2].set_title("sparsity per layer")
    fig.tight_layout()
    return _save_fig(fig, save_path, plt)


def visualize_per_head_grid(attention_maps: Dict[str, np.ndarray],
                            layer_idx: int = -1,
                            save_path: Optional[str] = None,
                            cmap: str = "viridis"):
    """All heads of one layer as a grid (reference per-head grids)."""
    plt = _plt()
    layers = sorted(attention_maps, key=lambda k: int(k.split("_")[1]))
    key = layers[layer_idx]
    attn = attention_maps[key][0]                  # (H, N, N)
    H = attn.shape[0]
    cols = min(H, 4)
    rows = -(-H // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows),
                             squeeze=False)
    for h in range(H):
        ax = axes[h // cols][h % cols]
        ax.imshow(attn[h], cmap=cmap)
        ax.set_title(f"{key} head {h}", fontsize=8)
        ax.axis("off")
    for j in range(H, rows * cols):
        axes[j // cols][j % cols].axis("off")
    fig.tight_layout()
    return _save_fig(fig, save_path, plt)


def visualize_layer_evolution(attention_maps: Dict[str, np.ndarray],
                              token_idx: int = 0,
                              save_path: Optional[str] = None):
    """One token's outgoing attention across layers (reference
    layer-evolution figure); defaults to the CLS token."""
    plt = _plt()
    layers = sorted(attention_maps, key=lambda k: int(k.split("_")[1]))
    evo = np.stack([attention_maps[k][0].mean(0)[token_idx]
                    for k in layers])              # (L, N)
    fig, ax = plt.subplots(figsize=(10, 4))
    im = ax.imshow(evo, aspect="auto", cmap="magma")
    ax.set_xlabel("token")
    ax.set_ylabel("layer")
    ax.set_title(f"token {token_idx} outgoing attention across layers")
    fig.colorbar(im, ax=ax, shrink=0.8)
    fig.tight_layout()
    return _save_fig(fig, save_path, plt)


def attention_statistics(attention_maps: Dict[str, np.ndarray]) -> dict:
    """Per-layer entropy / sparsity / CLS-mass summary (reference
    entropy-sparsity stats block)."""
    layers = sorted(attention_maps, key=lambda k: int(k.split("_")[1]))
    stats = {}
    for k in layers:
        attn = attention_maps[k]
        cls_row = attn[:, :, 0, :]
        stats[k] = {
            "entropy_mean": float(attention_entropy(attn).mean()),
            "sparsity_mean": float(attention_sparsity(attn).mean()),
            "cls_self_attention": float(attn[:, :, 0, 0].mean()),
            "cls_row_max": float(cls_row.max()),
        }
    return stats


def visualize_attention_on_pointcloud(point_cloud: np.ndarray,
                                      attention_weights: np.ndarray,
                                      group_centers: np.ndarray,
                                      title: str = "Attention Visualization",
                                      save_path: Optional[str] = None,
                                      point_size: float = 1.5,
                                      center_size: float = 5.0):
    """3D overlay: gray point cloud + group centers coloured by a scalar
    attention weight (reference extract_attention.py:762-843).

    Uses plotly when importable; otherwise writes the self-contained
    interactive canvas HTML (visualize.visualize_colored_pointcloud_html).
    """
    pc = np.asarray(point_cloud)[..., :3].reshape(-1, 3)
    w = np.asarray(attention_weights).reshape(-1)
    centers = np.asarray(group_centers).reshape(-1, 3)
    try:
        import plotly.graph_objects as go

        wn = (w - w.min()) / (w.max() - w.min() + 1e-8)
        fig = go.Figure()
        fig.add_trace(go.Scatter3d(
            x=pc[:, 0], y=pc[:, 1], z=pc[:, 2], mode="markers",
            marker=dict(size=point_size, color="lightgray", opacity=0.3),
            name="Point Cloud"))
        fig.add_trace(go.Scatter3d(
            x=centers[:, 0], y=centers[:, 1], z=centers[:, 2],
            mode="markers",
            marker=dict(size=center_size, color=wn, colorscale="Viridis",
                        colorbar=dict(title="Attention"), opacity=0.9),
            name="Group Centers (Attention)",
            text=[f"Attention: {x:.3f}" for x in w], hoverinfo="text"))
        fig.update_layout(title=title, scene=dict(aspectmode="data"))
        if save_path:
            save_path = _write_plotly_html(fig, save_path)
        return save_path
    except ImportError:
        if save_path is None:
            # the plotly branch returns without writing when no path is
            # given; the HTML fallback has nothing to show without a file
            return None
        from uni_adapter_torch.visualize import visualize_colored_pointcloud_html

        return visualize_colored_pointcloud_html(
            [{"name": "point cloud", "points": pc, "colors": "#555555",
              "size": point_size, "opacity": 0.35},
             {"name": "attention (viridis)", "points": centers, "colors": w,
              "size": center_size}],
            save_path, title=title)


def _scatter3d_grid_png(panels, point_cloud, group_centers, save_path,
                        suptitle):
    """Matplotlib 3D grid fallback shared by the two multi-panel overlays.

    panels: list of (title, (G,) scalar weights)."""
    if not panels:
        raise ValueError("panels must be non-empty")
    plt = _plt()
    n = len(panels)
    cols = min(3, n)
    rows = -(-n // cols)
    fig = plt.figure(figsize=(4.5 * cols, 4 * rows))
    pc = np.asarray(point_cloud)[..., :3].reshape(-1, 3)
    centers = np.asarray(group_centers).reshape(-1, 3)
    for i, (title, w) in enumerate(panels):
        ax = fig.add_subplot(rows, cols, i + 1, projection="3d")
        ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], s=1, c="lightgray",
                   alpha=0.2)
        wn = (w - w.min()) / (w.max() - w.min() + 1e-8)
        sc = ax.scatter(centers[:, 0], centers[:, 1], centers[:, 2], s=14,
                        c=wn, cmap="viridis", alpha=0.9)
        ax.set_title(title, fontsize=9)
        ax.set_axis_off()
    fig.colorbar(sc, ax=fig.axes, shrink=0.5, label="Attention")
    fig.suptitle(suptitle)
    if save_path:
        if save_path.lower().endswith(".html"):
            save_path = save_path[:-5]
        if not save_path.lower().endswith(".png"):
            save_path += ".png"
        os.makedirs(os.path.dirname(os.path.abspath(save_path)), exist_ok=True)
        fig.savefig(save_path, dpi=110)
    plt.close(fig)
    return save_path


def visualize_attention_heads_on_pointcloud(
        point_cloud: np.ndarray, attention_weights: np.ndarray,
        group_centers: np.ndarray, head_indices: Optional[List[int]] = None,
        title: str = "Attention by Head", save_path: Optional[str] = None):
    """Per-head overlay grid (reference extract_attention.py:845-935).

    Args:
      attention_weights: (H, G) per-head weights over group tokens.
    """
    attention_weights = np.asarray(attention_weights)
    H = attention_weights.shape[0]
    heads = head_indices if head_indices is not None else list(
        range(min(4, H)))
    if not heads:
        raise ValueError("head_indices must be non-empty (pass None for "
                         "the default first-4-heads selection)")
    try:
        import plotly.graph_objects as go
        from plotly.subplots import make_subplots

        pc = np.asarray(point_cloud)[..., :3].reshape(-1, 3)
        centers = np.asarray(group_centers).reshape(-1, 3)
        cols = min(2, len(heads))
        rows = -(-len(heads) // cols)
        fig = make_subplots(
            rows=rows, cols=cols,
            specs=[[{"type": "scatter3d"}] * cols for _ in range(rows)],
            subplot_titles=[f"Head {h}" for h in heads])
        for i, h in enumerate(heads):
            w = attention_weights[h]
            wn = (w - w.min()) / (w.max() - w.min() + 1e-8)
            r, c = i // cols + 1, i % cols + 1
            fig.add_trace(go.Scatter3d(
                x=pc[:, 0], y=pc[:, 1], z=pc[:, 2], mode="markers",
                marker=dict(size=1, color="lightgray", opacity=0.2),
                showlegend=False), row=r, col=c)
            fig.add_trace(go.Scatter3d(
                x=centers[:, 0], y=centers[:, 1], z=centers[:, 2],
                mode="markers",
                marker=dict(size=5, color=wn, colorscale="Viridis",
                            opacity=0.9), showlegend=False), row=r, col=c)
        fig.update_layout(title=title, height=400 * rows, width=500 * cols)
        if save_path:
            save_path = _write_plotly_html(fig, save_path)
        return save_path
    except ImportError:
        return _scatter3d_grid_png(
            [(f"Head {h}", attention_weights[h]) for h in heads],
            point_cloud, group_centers, save_path, title)


def visualize_layer_attention_on_pointcloud_grid(
        attention_maps: Dict[str, np.ndarray], point_cloud: np.ndarray,
        group_centers: np.ndarray,
        layer_indices: Optional[List[int]] = None,
        save_path: Optional[str] = None):
    """Head-averaged CLS attention on the cloud, one panel per layer
    (reference extract_attention.py:636-759).  Auto-selects 6 evenly spaced
    layers when layer_indices is None."""
    available = sorted(int(k.split("_")[1]) for k in attention_maps)
    if layer_indices is None:
        n_sel = min(6, len(available))
        idx = np.linspace(0, len(available) - 1, n_sel).astype(int)
        layer_indices = [available[i] for i in idx]
    panels = []
    for li in _resolve_layers(attention_maps, layer_indices):
        attn = attention_maps[f"layer_{li}"][0]          # (H, N, N)
        cls_attn = attn.mean(0)[0, 1:]                   # (G,)
        panels.append((f"Layer {li}", cls_attn))
    try:
        import plotly.graph_objects as go
        from plotly.subplots import make_subplots

        pc = np.asarray(point_cloud)[..., :3].reshape(-1, 3)
        centers = np.asarray(group_centers).reshape(-1, 3)
        cols = min(3, len(panels))
        rows = -(-len(panels) // cols)
        fig = make_subplots(
            rows=rows, cols=cols,
            specs=[[{"type": "scatter3d"}] * cols for _ in range(rows)],
            subplot_titles=[t for t, _ in panels])
        for i, (_, w) in enumerate(panels):
            wn = (w - w.min()) / (w.max() - w.min() + 1e-8)
            r, c = i // cols + 1, i % cols + 1
            fig.add_trace(go.Scatter3d(
                x=pc[:, 0], y=pc[:, 1], z=pc[:, 2], mode="markers",
                marker=dict(size=1, color="lightgray", opacity=0.15),
                showlegend=False, hoverinfo="skip"), row=r, col=c)
            fig.add_trace(go.Scatter3d(
                x=centers[:, 0], y=centers[:, 1], z=centers[:, 2],
                mode="markers",
                marker=dict(size=5, color=wn, colorscale="Viridis",
                            opacity=0.9, showscale=(i == 0)),
                showlegend=False), row=r, col=c)
        fig.update_layout(
            title="CLS Attention on Point Cloud (Averaged Over Heads)",
            height=400 * rows, width=450 * cols)
        if save_path:
            save_path = _write_plotly_html(fig, save_path)
        return save_path
    except ImportError:
        return _scatter3d_grid_png(
            panels, point_cloud, group_centers, save_path,
            "CLS attention on point cloud (head-averaged) — layer comparison")


def _per_layer_stats(attention_maps: Dict[str, np.ndarray]) -> dict:
    layers = sorted(attention_maps, key=lambda k: int(k.split("_")[1]))
    cls_rows = [attention_maps[k][0].mean(0)[0] for k in layers]  # (N,)
    return {
        "layers": [int(k.split("_")[1]) for k in layers],
        "entropy": [float(attention_entropy(r[None])[0]) for r in cls_rows],
        "max": [float(r.max()) for r in cls_rows],
        "sparsity": [float(attention_sparsity(r[None])[0]) for r in cls_rows],
        "cls_rows": np.stack(cls_rows),
    }


def visualize_comparison(clean_maps: Dict[str, np.ndarray],
                         corrupted_maps: Dict[str, np.ndarray],
                         out_dir: str, class_name: str = "object",
                         corruption_type: str = "corruption",
                         severity: int = 5) -> List[str]:
    """Clean-vs-corrupted comparison panel set
    (reference example_attention_extraction.py:117-345 visualize_comparison):

      1. side-by-side CLS-attention evolution matrices (layer × token),
      2. their signed difference map (RdBu, corrupted − clean),
      3. a 2×2 statistics panel: per-layer entropy, max weight, sparsity,
         and clean↔corrupted cosine similarity of the CLS rows.

    Returns the list of files written.
    """
    plt = _plt()
    os.makedirs(out_dir, exist_ok=True)
    cs, xs = _per_layer_stats(clean_maps), _per_layer_stats(corrupted_maps)
    paths = []

    # 1. side-by-side evolution
    fig, axes = plt.subplots(1, 2, figsize=(16, 6))
    vmax = max(cs["cls_rows"].max(), xs["cls_rows"].max())
    for ax, st, name in [(axes[0], cs, f"Clean - {class_name}"),
                         (axes[1], xs,
                          f"{corruption_type} (sev {severity}) - "
                          f"{class_name}")]:
        im = ax.imshow(st["cls_rows"], aspect="auto", cmap="viridis",
                       vmin=0, vmax=vmax)
        ax.set_title(name)
        ax.set_xlabel("token")
        ax.set_ylabel("layer")
        fig.colorbar(im, ax=ax)
    fig.suptitle("CLS Attention Evolution: Clean vs Corrupted "
                 "(averaged over heads)")
    p = os.path.join(out_dir, "comparison_evolution.png")
    fig.tight_layout()
    fig.savefig(p, dpi=110)
    plt.close(fig)
    paths.append(p)

    # 2. difference map
    diff = xs["cls_rows"] - cs["cls_rows"]
    fig, ax = plt.subplots(figsize=(10, 6))
    lim = np.abs(diff).max() + 1e-12
    im = ax.imshow(diff, aspect="auto", cmap="RdBu_r", vmin=-lim, vmax=lim)
    ax.set_title(f"Attention Difference (Corrupted − Clean)\n"
                 f"{corruption_type} severity {severity} | {class_name}")
    ax.set_xlabel("token")
    ax.set_ylabel("layer")
    fig.colorbar(im, ax=ax, label="Attention Difference")
    p = os.path.join(out_dir, "comparison_difference.png")
    fig.tight_layout()
    fig.savefig(p, dpi=110)
    plt.close(fig)
    paths.append(p)

    # 3. statistics panel
    fig, axes = plt.subplots(2, 2, figsize=(13, 9))
    L = cs["layers"]
    for ax, key, title in [(axes[0][0], "entropy", "Attention Entropy"),
                           (axes[0][1], "max", "Maximum Attention Weight"),
                           (axes[1][0], "sparsity", "Attention Sparsity")]:
        ax.plot(L, cs[key], "o-", label="Clean", color="tab:blue")
        ax.plot(L, xs[key], "s-", label="Corrupted", color="tab:red")
        ax.set_xlabel("layer")
        ax.set_title(title)
        ax.legend()
        ax.grid(alpha=0.3)
    cn = cs["cls_rows"] / (np.linalg.norm(cs["cls_rows"], axis=1,
                                          keepdims=True) + 1e-12)
    xn = xs["cls_rows"] / (np.linalg.norm(xs["cls_rows"], axis=1,
                                          keepdims=True) + 1e-12)
    sims = (cn * xn).sum(1)
    axes[1][1].bar(L, sims, color="teal", alpha=0.7)
    axes[1][1].set_title("Clean vs Corrupted Attention Similarity")
    axes[1][1].set_xlabel("layer")
    axes[1][1].set_ylim(0, 1.05)
    fig.suptitle(f"Attention Statistics: Clean vs {corruption_type} | "
                 f"{class_name}")
    p = os.path.join(out_dir, "comparison_statistics.png")
    fig.tight_layout()
    fig.savefig(p, dpi=110)
    plt.close(fig)
    paths.append(p)
    return paths


def visualize_attention_3d(extractor: AttentionExtractor,
                           point_cloud: np.ndarray, layer_idx: int = -1,
                           save_path: Optional[str] = None):
    """3D overlay: group centers coloured by CLS attention (the reference's
    plotly overlay, :"3D plotly overlays"); writes the self-contained HTML
    viewer with per-cloud intensity buckets."""
    from uni_adapter_torch.visualize import visualize_pointclouds_plotly

    if not extractor.attention_maps:
        # reuse maps already extracted for this cloud (the CLI extracts then
        # visualizes the same cloud — re-running repeats the full forward
        # plus the L×(H,N,N) device→host copy); callers passing a DIFFERENT
        # cloud must call extract() themselves first
        extractor.extract(point_cloud)
    cls_attn = extractor.get_cls_attention(layer_idx).mean(1)[0]   # (G,)
    centers = extractor.get_group_centers(point_cloud)[0]          # (G, 3)
    q = np.quantile(cls_attn, [0.5, 0.8, 0.95])
    clouds = {
        "points": np.asarray(point_cloud)[..., :3].reshape(-1, 3),
        "low attention": centers[cls_attn < q[0]],
        "mid attention": centers[(cls_attn >= q[0]) & (cls_attn < q[1])],
        "high attention": centers[(cls_attn >= q[1]) & (cls_attn < q[2])],
        "top attention": centers[cls_attn >= q[2]],
    }
    return visualize_pointclouds_plotly(
        {k: v for k, v in clouds.items() if len(v)}, save_path=save_path,
        title=f"CLS attention, layer {layer_idx}")
