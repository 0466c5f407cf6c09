"""Entropy helper (mirror of `uni_adapter_tpu/utils/math.py`)."""
from __future__ import annotations

import torch


def softmax_entropy(x: torch.Tensor) -> torch.Tensor:
    """Shannon entropy of softmax(x) rows, in nats: (..., K) -> (...,)."""
    probs = torch.softmax(x, dim=-1)
    return -(probs * torch.log(probs + 1e-10)).sum(dim=-1)
