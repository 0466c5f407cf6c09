"""Corrupted point-cloud test sets, numpy only (a copy of the ModelNet40-C
part of `uni_adapter_tpu/data/datasets.py`).

Layout: `data_{corruption}_{severity}.npy` + `label.npy` under the root
('clean' reads `data_original.npy`).  Clouds whose point count differs
from `npoints` are resampled with replacement from
`np.random.default_rng(seed)`, in dataset order, exactly as the JAX
package does, so both packages stream identical arrays.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

MODELNET40_CLASSES = [
    "airplane", "bathtub", "bed", "bench", "bookshelf", "bottle", "bowl",
    "car", "chair", "cone", "cup", "curtain", "desk", "door", "dresser",
    "flower_pot", "glass_box", "guitar", "keyboard", "lamp", "laptop",
    "mantel", "monitor", "night_stand", "person", "piano", "plant", "radio",
    "range_hood", "sink", "sofa", "stairs", "stool", "table", "tent",
    "toilet", "tv_stand", "vase", "wardrobe", "xbox",
]


def _npy_pair_paths(data_path: str, corruption: str, severity: int):
    if corruption == "clean":
        data_file = os.path.join(data_path, "data_original.npy")
    else:
        data_file = os.path.join(data_path, f"data_{corruption}_{severity}.npy")
    label_file = os.path.join(data_path, "label.npy")
    if "mixed_corruptions" in corruption:
        data_file = os.path.join(data_path, f"{corruption}.npy")
        label_file = os.path.join(data_path, "mixed_corruptions_labels.npy")
    return data_file, label_file


def load_data(data_path: str, corruption: str, severity: int):
    """The npy pair of one corruption."""
    data_file, label_file = _npy_pair_paths(data_path, corruption, severity)
    for f in (data_file, label_file):
        if not os.path.exists(f):
            raise FileNotFoundError(f"Data file not found: {f}")
    return (np.load(data_file, allow_pickle=True),
            np.load(label_file, allow_pickle=True))


@dataclass
class TTADataset:
    """One corruption stream: (pc, label, class_name, rgb) per item."""
    data: np.ndarray           # (T, N, 3) or object array of ragged clouds
    labels: np.ndarray         # (T,) int
    class_names: list[str]

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, i: int):
        pc = np.asarray(self.data[i], dtype=np.float32)
        label = int(self.labels[i])
        return pc, label, self.class_names[label], np.ones_like(pc)

    def iter_batches(self, batch_size: int = 1,
                     npoints: Optional[int] = None,
                     seed: int = 42) -> Iterator[tuple]:
        """(pc (B,N,3), rgb (B,N,3), label (B,)) batches in dataset order;
        the last batch may be short."""
        rng = np.random.default_rng(seed)
        for s in range(0, len(self), batch_size):
            items = [self[i] for i in range(s, min(s + batch_size, len(self)))]
            pcs = [it[0] for it in items]
            if npoints is not None:
                pcs = [pc if pc.shape[0] == npoints else
                       pc[rng.choice(pc.shape[0], npoints, replace=True)]
                       for pc in pcs]
            yield (np.stack(pcs), np.stack([np.ones_like(pc) for pc in pcs]),
                   np.array([it[1] for it in items], np.int32))

    def as_arrays(self, batch_size: int = 1,
                  npoints: Optional[int] = None, seed: int = 42):
        """Fixed-shape stacks (T', B, N, 3) pc and rgb plus (T', B) labels;
        trailing samples that do not fill a batch are dropped."""
        rng = np.random.default_rng(seed)
        n = npoints or max(np.asarray(self.data[i]).shape[0]
                           for i in range(len(self)))
        pcs, labels = [], []
        for i in range(len(self)):
            pc, label, _, _ = self[i]
            if pc.shape[0] != n:
                pc = pc[rng.choice(pc.shape[0], n, replace=True)]
            pcs.append(pc)
            labels.append(label)
        T = (len(pcs) // batch_size) * batch_size
        pc_arr = np.stack(pcs[:T]).reshape(T // batch_size, batch_size, n, 3)
        lab = np.array(labels[:T], np.int32).reshape(T // batch_size,
                                                     batch_size)
        return pc_arr, np.ones_like(pc_arr), lab


def _normalize_labels(labels: np.ndarray) -> np.ndarray:
    labels = np.asarray(labels)
    if labels.ndim > 1:
        labels = labels[0] if labels.shape[0] == 1 else labels.reshape(-1)
    return labels.astype(np.int64)


def modelnet40_c(root: str, corruption: str, severity: int = 5,
                 debug: bool = False) -> TTADataset:
    data, labels = load_data(root, corruption, severity)
    if debug:
        data, labels = data[:5], labels[:5]
    return TTADataset(data, _normalize_labels(labels), MODELNET40_CLASSES)


def load_tta_dataset(cfg) -> TTADataset:
    """Dataset for `cfg.data` (name-substring dispatch)."""
    d = cfg.data
    if "modelnet" in d.dataset_name.lower():
        return modelnet40_c(d.root, d.corruption, d.severity, d.debug)
    raise NotImplementedError(f"dataset {d.dataset_name!r} is not ported yet "
                              f"(ROADMAP M6); the port reads ModelNet40-C")
