"""Precomputed text anchors (mirror of `uni_adapter_tpu/anchors.py::
load_precomputed`).

The port ships its own copies of the JAX package's four banks (the
reference's precomputed CLIP text features, fp32): Uni3D large and giant
for ModelNet40, large for ScanObjectNN and for ShapeNetCore.  ULIP-2
(512-d), OpenShape (1280-d or 768-d) and Objaverse-LVIS banks are passed
as files.  The on-the-fly text tower is ROADMAP M11.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from uni_adapter_torch.config import ASSETS_DIR

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
