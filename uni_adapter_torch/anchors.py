"""Precomputed text anchors (mirror of `uni_adapter_tpu/anchors.py::
load_precomputed`).

The port ships its own copy of the Uni3D-L ModelNet40 bank
(`assets/text_features_large.npy`, (40, 1024) fp32, the reference's
precomputed CLIP text features); ULIP-2 (512-d) and OpenShape (1280-d or
768-d) banks are passed as files.  Other shipped banks and the on-the-fly
text tower are ROADMAP M11.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from uni_adapter_torch.config import ASSETS_DIR

#: Shipped banks, keyed by (backbone size, dataset family).
PRECOMPUTED = {("large", "modelnet"): "text_features_large.npy"}


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
    if family is None and dataset_name is not None:
        raise KeyError(f"no shipped anchor-bank family for dataset "
                       f"'{dataset_name}' (or pass a .npy path)")
    fname = PRECOMPUTED.get((path_or_key, family or "modelnet"))
    if fname is None:
        raise NotImplementedError(
            f"the '{path_or_key}' bank for '{family or 'modelnet'}' is not "
            f"shipped with the port yet (ROADMAP M11); pass a .npy path")
    return torch.from_numpy(
        np.load(os.path.join(ASSETS_DIR, fname)).astype(np.float32))
