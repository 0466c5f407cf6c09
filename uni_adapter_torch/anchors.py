"""Text anchors: the zero-shot classifier's (K, D) rows (mirror of
`uni_adapter_tpu/anchors.py`).

Two sources, in the reference's precedence (`get_text_anchors`):

  * precomputed banks: the port ships its own copies of the JAX package's
    four (the reference's CLIP text features, fp32): Uni3D large and
    giant for ModelNet40, large for ScanObjectNN and for ShapeNetCore;
    ULIP-2 (512-d), OpenShape (1280-d or 768-d) and Objaverse-LVIS banks
    are passed as files;
  * on the fly (`clip_classifier`): each class name in each of the 64
    prompt templates, tokenized on the host, through the text tower in
    batches on its device; each embedding L2-normalised, averaged over
    the templates and normalised again.
"""
from __future__ import annotations

import logging
import os
from typing import Callable, Optional

import numpy as np
import torch

from uni_adapter_torch.config import (ASSETS_DIR, Config, load_labels,
                                      load_templates)
from uni_adapter_torch.utils.tokenizer import SimpleTokenizer

#: Shipped banks, keyed by (backbone size, dataset family).
PRECOMPUTED = {
    ("large", "modelnet"): "text_features_large.npy",
    ("giant", "modelnet"): "text_features_giant.npy",
    ("large", "scanobject"): "text_features_large_scanobjectnn.npy",
    ("large", "shapenet"): "text_features_large_shapenetcorev2.npy",
}


def load_precomputed(path_or_key: str,
                     dataset_name: Optional[str] = None) -> torch.Tensor:
    """A (K, D) float32 anchor bank from a .npy or .npz path (an archive
    gives its first array) or a size key ('large') resolved against the
    shipped banks for `dataset_name`."""
    if os.path.exists(path_or_key):
        loaded = np.load(path_or_key)
        if isinstance(loaded, np.lib.npyio.NpzFile):
            with loaded:
                loaded = loaded[loaded.files[0]]
        return torch.from_numpy(loaded.astype(np.float32))
    if path_or_key.endswith((".npy", ".npz")) or os.sep in path_or_key:
        raise FileNotFoundError(
            f"precomputed text-feature file not found: {path_or_key}")
    family = next((f for f in ("modelnet", "scanobject", "shapenet")
                   if dataset_name and f in dataset_name.lower()), None)
    if family is None:
        if dataset_name is not None:
            # an unknown dataset must not get the ModelNet bank (another
            # class set scores silently wrong)
            raise KeyError(
                f"no shipped anchor-bank family for dataset "
                f"'{dataset_name}' (known: modelnet/scanobject/shapenet; "
                f"or pass a .npy path)")
        family = "modelnet"
    try:
        fname = PRECOMPUTED[(path_or_key, family)]
    except KeyError:
        avail = sorted({k for k, fam in PRECOMPUTED if fam == family})
        raise KeyError(
            f"no shipped '{path_or_key}' bank for dataset family "
            f"'{family}' (available sizes: {avail}; or pass a .npy path)"
        ) from None
    return torch.from_numpy(
        np.load(os.path.join(ASSETS_DIR, fname)).astype(np.float32))


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


@torch.no_grad()
def clip_classifier(classnames, templates,
                    encode_text_fn: Callable[[torch.Tensor], torch.Tensor],
                    tokenizer: Optional[SimpleTokenizer] = None,
                    batch_size: int = 256,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """The template ensemble's (K, D) fp32 rows, row-normalised, on
    `device`.

    Each class name ('_' read as ' ') goes into every template; the K·T
    prompts are tokenized on the host and `encode_text_fn` ((B, 77) ids on
    `device` → (B, D)) takes them `batch_size` at a time.
    """
    tokenizer = tokenizer or SimpleTokenizer()
    prompts = [t.format(name.replace("_", " "))
               for name in classnames for t in templates]
    tokens = torch.from_numpy(tokenizer(prompts))                # (K·T, 77)
    emb = torch.cat([
        encode_text_fn(tokens[s:s + batch_size].to(device)).to(torch.float32)
        for s in range(0, tokens.shape[0], batch_size)])
    emb = _normalize(emb).reshape(len(classnames), len(templates), -1)
    return _normalize(emb.mean(dim=1))


def get_text_anchors(cfg: Config, encode_text_fn=None, tokenizer=None,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """The anchors in the reference's precedence: a bank that is configured
    and present; else (a configured bank that is missing warns) the text
    tower `encode_text_fn` on the labels and templates of `cfg`; with
    neither, ValueError.  A bank comes back on the CPU, the tower's rows
    on `device`."""
    pre = cfg.data.precomputed_text_features
    if pre:
        try:
            return load_precomputed(pre, cfg.data.dataset_name)
        except FileNotFoundError:
            if encode_text_fn is None:
                raise
            logging.warning(
                "precomputed bank '%s' not found; computing anchors on the "
                "fly", pre)
    if encode_text_fn is None:
        raise ValueError("No precomputed anchors configured and no text "
                         "encoder provided for the on-the-fly path")
    return clip_classifier(load_labels(cfg), load_templates(cfg),
                           encode_text_fn, tokenizer, device=device)
