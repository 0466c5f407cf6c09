"""CLIP text transformer (mirror of `uni_adapter_tpu/models/clip_text.py`):
causal, QuickGELU, pooled at the end-of-text token.

    (B, 77) token ids
      → token embedding + positional embedding, each cast to the compute
        dtype before the add
      → `layers` pre-norm blocks: attention under the additive causal mask
        (plain PyTorch on either device, as the JAX package keeps masked
        attention out of its kernels), QuickGELU MLP
      → ln_final → the row at argmax(ids) (the end-of-text token has the
        highest id; the first maximum when it was truncated away)
      → @ text_projection, an fp32 product with TF32 off → (B, embed_dim)

One module covers the text spaces of all three backbones (`TEXT_PRESETS`).
Parameters are named after the flax tree (`token_embedding`,
`resblocks.{i}.attn.qkv`, `ln_final`, `text_projection`, ...), so
`weights.from_jax_params` maps the JAX tower's parameters unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from uni_adapter_torch.adapt.residual import tier_product
from uni_adapter_torch.models.common import (LN, Mlp, ViTAttention,
                                             finish_model, quick_gelu)

#: Text-tower presets by backbone (the JAX package's `TEXT_PRESETS`).
TEXT_PRESETS = {
    "ulip": dict(width=512, layers=12, heads=8, embed_dim=512),
    "uni3d": dict(width=1280, layers=32, heads=20, embed_dim=1024),
    "openshape_vitg14": dict(width=1280, layers=32, heads=20, embed_dim=1280),
    "openshape_vitl14": dict(width=768, layers=12, heads=12, embed_dim=768),
}


class ResidualAttentionBlock(nn.Module):
    """Pre-norm block: biased-qkv attention under the mask, QuickGELU MLP."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = LN(width)
        self.attn = ViTAttention(width, heads, qkv_bias=True)
        self.ln_2 = LN(width)
        self.mlp = Mlp(width, width * 4, act=quick_gelu)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask=mask)
        return x + self.mlp(self.ln_2(x))


class TextEncoder(nn.Module):
    """CLIP text encoder: (B, context_length) ids → (B, embed_dim) fp32."""

    def __init__(self, vocab_size: int = 49408, width: int = 512,
                 layers: int = 12, heads: int = 8, context_length: int = 77,
                 embed_dim: int = 512, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.context_length = context_length
        self.token_embedding = nn.Parameter(torch.zeros(vocab_size, width))
        self.positional_embedding = nn.Parameter(
            torch.zeros(context_length, width))
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads) for _ in range(layers))
        self.ln_final = LN(width)
        self.text_projection = nn.Parameter(torch.zeros(width, embed_dim))

    def causal_mask(self, device: torch.device) -> torch.Tensor:
        """(1, 1, L, L) fp32: 0 on and below the diagonal, -inf above."""
        L = self.context_length
        return torch.full((L, L), float("-inf"), device=device).triu(1)[
            None, None]

    def forward(self, text: torch.Tensor) -> torch.Tensor:
        text = text.long()
        x = (self.token_embedding[text].to(self.dtype)
             + self.positional_embedding.to(self.dtype))
        mask = self.causal_mask(x.device)
        for blk in self.resblocks:
            x = blk(x, mask)
        x = self.ln_final(x)
        eot = torch.argmax(text, dim=-1)         # the first maximum
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        # the JAX Precision.HIGHEST product: fp32, TF32 off whatever the
        # process has set
        return tier_product(pooled.to(torch.float32),
                            self.text_projection.T, "highest")


def create_text_encoder(name: str, device: torch.device | str,
                        dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                        state_dict: Optional[dict] = None,
                        **dims) -> TextEncoder:
    """The text tower of preset `name` (`dims` replace its widths, e.g. a
    small `vocab_size` for tests) on `device`, frozen and in eval mode.

    The weights are `state_dict` or random from `seed` on `device` (a
    0.69 G-parameter preset is drawn on the card, not the host), as
    `common.finish_model` draws them, then the bare parameters as flax
    draws them: token embedding normal(0.02), positional normal(0.01),
    projection normal(0.02).  Dense layers are stored in `dtype`; the
    embeddings and the projection stay fp32.
    """
    with torch.device(device):
        model = TextEncoder(**{**TEXT_PRESETS[name], **dims}, dtype=dtype)

    def init_bare(gen: torch.Generator) -> None:
        nn.init.normal_(model.token_embedding, std=0.02, generator=gen)
        nn.init.normal_(model.positional_embedding, std=0.01, generator=gen)
        nn.init.normal_(model.text_projection, std=0.02, generator=gen)

    return finish_model(model, device, dtype, seed, state_dict, init_bare)
