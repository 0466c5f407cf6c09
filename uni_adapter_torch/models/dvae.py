"""Point-BERT's discrete VAE, the point tokenizer's training stage (mirror
of `uni_adapter_tpu/models/dvae.py`).

  * DGCNN: a k = 4 graph-conv stack with GroupNorm (4 groups, flax's
    statistics) and LeakyReLU 0.2 over centre-relative kNN graph features;
  * FoldingDecoder: coarse MLP points + 2×2 folding-grid refinement;
  * DiscreteVAE: mini-PointNet encoder → DGCNN → Gumbel-softmax over a
    learnt codebook (straight-through with `hard`) → DGCNN → folding
    decoder; `chamfer_l1` and `dvae_loss` (reconstruction + the
    uniform-prior KL).

Grouping and the graph's kNN run on the card's kernels (`ops.fps`,
`ops.knn`: indices only, no gradient needed); the gathers, the dense
layers and the norms are plain PyTorch.  Module and parameter names
follow the flax tree (`weights.from_jax_params`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from uni_adapter_torch.models.common import Dense, finish_model
from uni_adapter_torch.models.uni3d import MiniPointNet
from uni_adapter_torch.ops.geometry import group_points, index_points
from uni_adapter_torch.ops.knn import knn


def graph_feature(coor: torch.Tensor, x: torch.Tensor,
                  k: int = 4) -> torch.Tensor:
    """Centre-relative kNN graph features: coor (B, N, 3), x (B, N, C) →
    (B, N, k, 2C) = [neighbour − centre ‖ centre]."""
    nb = index_points(x, knn(k, coor, coor))                 # (B, N, k, C)
    ctr = x[:, :, None, :].expand_as(nb)
    return torch.cat([nb - ctr, ctr], dim=-1)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class GroupNorm(nn.Module):
    """flax's `nn.GroupNorm` on channels-last input (B, ..., C): statistics
    per sample and group over every other axis, the variance as E[x²] −
    E[x]² (flax's fast variance), eps 1e-6; y = (x − mean)·(rsqrt(var +
    eps)·scale) + bias."""

    def __init__(self, num_groups: int, features: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1]
        G = self.num_groups
        g = x.reshape(B, -1, G, C // G)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((g * g).mean(dim=(1, 3), keepdim=True)
                          - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(G, C // G)
        y = (g - mean) * mul + self.bias.reshape(G, C // G)
        return y.reshape(x.shape)


class DGCNN(nn.Module):
    """4-stage graph-conv feature extractor."""

    def __init__(self, in_channels: int, output_channel: int):
        super().__init__()
        self.input_trans = Dense(in_channels, 128)
        prev = 128
        for i, ch in enumerate((256, 512, 512, 1024)):
            setattr(self, f"layer{i + 1}", Dense(2 * prev, ch, bias=False))
            setattr(self, f"gn{i + 1}", GroupNorm(4, ch))
            prev = ch
        self.layer5 = Dense(256 + 512 + 512 + 1024, output_channel,
                            bias=False)
        self.gn5 = GroupNorm(4, output_channel)

    def forward(self, f: torch.Tensor, coor: torch.Tensor) -> torch.Tensor:
        # f: (B, G, C); coor: (B, G, 3)
        f = self.input_trans(f)
        feats = []
        for i in range(1, 5):
            g = graph_feature(coor, f)                      # (B, G, k, 2C)
            g = getattr(self, f"gn{i}")(getattr(self, f"layer{i}")(g))
            f = _leaky(g).amax(dim=2)                       # (B, G, ch)
            feats.append(f)
        f = self.gn5(self.layer5(torch.cat(feats, dim=-1)))
        return _leaky(f)


class FoldingDecoder(nn.Module):
    """Coarse-points MLP + folding-grid refinement."""

    def __init__(self, in_channels: int, num_fine: int):
        super().__init__()
        self.num_fine = num_fine
        num_coarse = num_fine // 4
        self.mlp1 = Dense(in_channels, 1024)
        self.mlp2 = Dense(1024, 1024)
        self.mlp3 = Dense(1024, 3 * num_coarse)
        self.final1 = Dense(in_channels + 2 + 3, 512)
        self.final2 = Dense(512, 512)
        self.final3 = Dense(512, 3)

    def forward(self, feature_global: torch.Tensor):
        # feature_global: (B, G, C)
        B, G, C = feature_global.shape
        num_coarse = self.num_fine // 4
        fg = feature_global.reshape(B * G, C)
        h = torch.relu(self.mlp2(torch.relu(self.mlp1(fg))))
        coarse = self.mlp3(h).reshape(B * G, num_coarse, 3)
        # the folding seed: a 2×2 grid in [-0.05, 0.05]², x fastest
        lin = torch.linspace(-0.05, 0.05, 2, device=fg.device)
        a, b = torch.meshgrid(lin, lin, indexing="xy")
        seed = torch.stack([a.reshape(-1), b.reshape(-1)], dim=-1)  # (4, 2)
        seed = seed[None, None].expand(B * G, num_coarse, 4, 2).reshape(
            B * G, self.num_fine, 2)
        point_feat = torch.repeat_interleave(coarse, 4, dim=1)  # (BG, n, 3)
        fg_exp = fg[:, None, :].expand(B * G, self.num_fine, C)
        feat = torch.cat([fg_exp, seed, point_feat], dim=-1)
        x = torch.relu(self.final2(torch.relu(self.final1(feat))))
        fine = self.final3(x) + point_feat
        return (coarse.reshape(B, G, num_coarse, 3),
                fine.reshape(B, G, self.num_fine, 3))


def gumbel_noise(shape, generator: torch.Generator,
                 device) -> torch.Tensor:
    """Standard Gumbel noise −log(−log U), U uniform in (0, 1], drawn from
    `generator` (not the JAX draw: tests hand both the same noise)."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


class DiscreteVAE(nn.Module):
    """Point tokenizer dVAE at Point-BERT's widths by default."""

    def __init__(self, num_group: int = 64, group_size: int = 32,
                 encoder_dims: int = 256, tokens_dims: int = 256,
                 decoder_dims: int = 256, num_tokens: int = 8192):
        super().__init__()
        self.num_group, self.group_size = num_group, group_size
        self.num_tokens = num_tokens
        self.encoder = MiniPointNet(encoder_dims, 3, dtype=torch.float32)
        self.dgcnn_1 = DGCNN(encoder_dims, num_tokens)
        self.codebook = nn.Parameter(torch.empty(num_tokens, tokens_dims))
        self.dgcnn_2 = DGCNN(tokens_dims, decoder_dims)
        self.decoder = FoldingDecoder(decoder_dims, group_size)

    def forward(self, inp: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                temperature: float = 1.0, hard: bool = False,
                gumbel: Optional[torch.Tensor] = None):
        """inp (B, N, 3).  The Gumbel noise is `gumbel` (B, G, num_tokens)
        where given, else drawn from `generator`.  Returns (whole_coarse,
        whole_fine, coarse, fine, neighborhood, logits)."""
        neighborhood, center, _ = group_points(inp, None, self.num_group,
                                               self.group_size)
        logits = self.dgcnn_1(self.encoder(neighborhood), center)  # (B,G,V)
        if gumbel is None:
            gumbel = gumbel_noise(logits.shape, generator, logits.device)
        soft = torch.softmax((logits + gumbel) / temperature, dim=2)
        if hard:
            # straight-through: the one-hot forward, the soft gradient
            onehot = F.one_hot(soft.argmax(dim=2), self.num_tokens).to(
                soft.dtype)
            soft = onehot + soft - soft.detach()
        sampled = torch.einsum("bgn,nc->bgc", soft, self.codebook)
        feature = self.dgcnn_2(sampled, center)
        coarse, fine = self.decoder(feature)
        whole_fine = (fine + center[:, :, None, :]).reshape(inp.shape[0], -1, 3)
        whole_coarse = (coarse + center[:, :, None, :]).reshape(
            inp.shape[0], -1, 3)
        return whole_coarse, whole_fine, coarse, fine, neighborhood, logits


def create_dvae(device, seed: int = 0, state_dict: Optional[dict] = None,
                **widths) -> DiscreteVAE:
    """A trainable fp32 DiscreteVAE on `device`: weights from `state_dict`
    (e.g. `weights.from_jax_params`) or random from `seed` (Dense kernels
    lecun-normal, the codebook standard normal)."""
    with torch.device(device):
        model = DiscreteVAE(**widths)
    return finish_model(
        model, device, torch.float32, seed, state_dict,
        lambda gen: nn.init.normal_(model.codebook, generator=gen),
        trainable=True)


def chamfer_l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric Chamfer-L1 between (B, N, 3) and (B, M, 3), averaged over
    the two directions."""
    d = torch.linalg.vector_norm(a[:, :, None] - b[:, None], dim=-1)
    return 0.5 * (d.amin(dim=2).mean() + d.amin(dim=1).mean())


def dvae_loss(ret) -> Tuple[torch.Tensor, torch.Tensor]:
    """(reconstruction, KL(uniform ‖ q)) of a DiscreteVAE forward tuple; the
    grouped ground truth is its own neighbourhoods."""
    _, _, coarse, fine, group_gt, logits = ret
    B, G = coarse.shape[:2]
    gt = group_gt.reshape(B * G, -1, 3)
    rec = (chamfer_l1(coarse.reshape(B * G, -1, 3), gt)
           + chamfer_l1(fine.reshape(B * G, -1, 3), gt))
    mean_softmax = torch.softmax(logits, dim=-1).mean(dim=1)
    log_qy = torch.log(mean_softmax + 1e-12)
    log_uniform = -torch.log(torch.tensor(float(logits.shape[-1]),
                                          device=logits.device))
    klv = torch.mean(torch.sum(torch.exp(log_uniform)
                               * (log_uniform - log_qy), dim=-1))
    return rec, klv
