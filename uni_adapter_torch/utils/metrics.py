"""Top-k correct counts (mirror of `uni_adapter_tpu/utils/metrics.py`)."""
from __future__ import annotations

from typing import Sequence

import torch


def topk_correct(logits: torch.Tensor, target: torch.Tensor,
                 topk: Sequence[int] = (1, 3, 5)) -> torch.Tensor:
    """Per-k correct counts for one batch.

    Args:
      logits: ([S,] B, K); target: ([S,] B) int.
    Returns:
      ([S,] len(topk)) float32 — samples whose target is within the top-k.
      Equal logits rank by lower index, as `jax.lax.top_k` does (a stable
      descending sort; `torch.topk` promises no tie order).
    """
    maxk = min(max(topk), logits.shape[-1])
    pred = torch.sort(logits, dim=-1, descending=True,
                      stable=True).indices[..., :maxk]
    correct = pred == target.to(pred.device)[..., None].long()
    return torch.stack([correct[..., :min(k, maxk)].any(dim=-1).sum(dim=-1)
                        .to(torch.float32) for k in topk], dim=-1)
