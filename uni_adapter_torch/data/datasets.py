"""Corrupted point-cloud test sets, numpy only (a copy of the -C loaders
of `uni_adapter_tpu/data/datasets.py`: ModelNet40-C, ScanObjectNN-C,
ShapeNetCore-C, and the generic -C family for Objaverse-LVIS and
OmniObject3D, whose class names come from labels.json).

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

from uni_adapter_torch.config import load_labels

MODELNET40_CLASSES = [
    "airplane", "bathtub", "bed", "bench", "bookshelf", "bottle", "bowl",
    "car", "chair", "cone", "cup", "curtain", "desk", "door", "dresser",
    "flower_pot", "glass_box", "guitar", "keyboard", "lamp", "laptop",
    "mantel", "monitor", "night_stand", "person", "piano", "plant", "radio",
    "range_hood", "sink", "sofa", "stairs", "stool", "table", "tent",
    "toilet", "tv_stand", "vase", "wardrobe", "xbox",
]

SCANOBJECTNN_CLASSES = [
    "bag", "bin", "box", "cabinet", "chair", "desk", "display", "door",
    "shelf", "table", "bed", "pillow", "sink", "sofa", "toilet",
]

SHAPENETCORE_CLASSES = [
    "airplane", "bag", "basket", "bathtub", "bed", "bench", "bottle", "bowl",
    "bus", "cabinet", "can", "camera", "cap", "car", "chair", "clock",
    "dishwasher", "monitor", "table", "telephone", "tin_can", "tower",
    "train", "keyboard", "earphone", "faucet", "file", "guitar", "helmet",
    "jar", "knife", "lamp", "laptop", "speaker", "mailbox", "microphone",
    "microwave", "motorcycle", "mug", "piano", "pillow", "pistol", "pot",
    "printer", "remote_control", "rifle", "rocket", "skateboard", "sofa",
    "stove", "vessel", "washer", "cellphone", "birdhouse", "bookshelf",
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
    if not os.path.exists(data_file):
        raise FileNotFoundError(f"Data file not found: {data_file}")
    if not os.path.exists(label_file):
        raise FileNotFoundError(f"Label file not found: {label_file}")
    return (np.load(data_file, allow_pickle=True),
            np.load(label_file, allow_pickle=True))


def open_native(data_path: str, corruption: str, severity: int,
                prefetch: int = 8):
    """`load_data`'s pair as mmap'd readers (`native.loader.NativeNpy`,
    the C++ reader with a background prefetch ring; numpy where it is
    out).  Returns (data reader, label reader)."""
    from uni_adapter_torch.native.loader import NativeNpy

    data_file, label_file = _npy_pair_paths(data_path, corruption, severity)
    return (NativeNpy(data_file, prefetch=prefetch), NativeNpy(label_file))


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


def generic_c(root: str, corruption: str, class_names: list[str],
              severity: int = 5, debug: bool = False) -> TTADataset:
    """A -C set in the common layout with its class names given.  Labels
    are flattened before the debug slice (ScanObjectNN stores them as
    [1, T]); the JAX package's other loaders slice first, which for 1-D
    labels is the same."""
    data, labels = load_data(root, corruption, severity)
    labels = _normalize_labels(labels)
    if debug:
        data, labels = data[:5], labels[:5]
    return TTADataset(data, labels, class_names)


def modelnet40_c(root: str, corruption: str, severity: int = 5,
                 debug: bool = False) -> TTADataset:
    return generic_c(root, corruption, MODELNET40_CLASSES, severity, debug)


def scanobjectnn_c(root: str, corruption: str, severity: int = 5,
                   debug: bool = False) -> TTADataset:
    return generic_c(root, corruption, SCANOBJECTNN_CLASSES, severity, debug)


def shapenetcore_c(root: str, corruption: str, severity: int = 5,
                   debug: bool = False) -> TTADataset:
    return generic_c(root, corruption, SHAPENETCORE_CLASSES, severity, debug)


def load_tta_dataset(cfg) -> TTADataset:
    """Dataset for `cfg.data` (name-substring dispatch)."""
    d = cfg.data
    name = d.dataset_name.lower()
    if "modelnet" in name:
        return modelnet40_c(d.root, d.corruption, d.severity, d.debug)
    if "scanobject" in name:
        return scanobjectnn_c(d.root, d.corruption, d.severity, d.debug)
    if "shapenet" in name:
        return shapenetcore_c(d.root, d.corruption, d.severity, d.debug)
    if "lvis" in name or "objaverse" in name or "omniobject" in name:
        return generic_c(d.root, d.corruption, load_labels(cfg), d.severity,
                         d.debug)
    raise NotImplementedError(f"Dataset {d.dataset_name} is not implemented")
