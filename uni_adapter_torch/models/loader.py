"""The one dispatch from `--vlm3d` to a backbone (named after
`uni_adapter_tpu/models/loader.py::build_backbone`), shared by the
evaluation and the attention-extraction CLIs.  Loading checkpoints is not
ported yet (ROADMAP M12): the weights are random from a seed.
"""
from __future__ import annotations

import torch

from uni_adapter_torch.models.pointbert import create_ulip
from uni_adapter_torch.models.ppta import create_openshape
from uni_adapter_torch.models.uni3d import create_uni3d

#: Model constructors by `--vlm3d`: create(cfg.model, device, seed=...).
BACKBONES = {"uni3d": create_uni3d, "ulip": create_ulip,
             "openshape": create_openshape}


def build_backbone(vlm3d: str, mc, device: torch.device | str,
                   seed: int = 0):
    """The point backbone for `vlm3d` from the ModelConfig `mc`, on
    `device`, frozen, with random weights from `seed`.

    Returns (model, num_group, group_size): where the transformer tokens
    sit spatially, for the on-pointcloud attention overlays (OpenShape's
    tokens sit on its set abstraction's FPS centres, the same FPS as
    `group_points`).
    """
    if vlm3d not in BACKBONES:
        raise ValueError(f"unknown vlm3d {vlm3d!r}")
    model = BACKBONES[vlm3d](mc, device, seed=seed)
    if vlm3d == "ulip":
        return model, mc.num_group, mc.ulip_group_size
    if vlm3d == "openshape":
        return model, model.ppat.sa.npoint, model.ppat.sa.nsample
    return model, mc.num_group, mc.group_size
