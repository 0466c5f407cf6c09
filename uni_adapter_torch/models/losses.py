"""Contrastive losses (mirror of `uni_adapter_tpu/models/losses.py`).

The pc↔text plus masked pc↔image InfoNCE of Uni3D's pretraining
(`Uni3d_Text_Image_Loss`).  Products run in fp32 with TF32 off (the
process's setting, `cli.tta.set_numerics`), the counterpart of the JAX
package's `precision=HIGHEST`.  With `axis_name` (a process group) the
features of every rank are gathered as the negatives, each rank's rows
labelled at its offset, and the masked leg's numerator and denominator
summed over the ranks; the gathers carry their gradients as JAX's AD
transposes its collectives (`parallel/collectives.py`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from uni_adapter_torch.parallel import collectives


def all_gather_batch(tensors, axis_name=None):
    """Gather batches from all ranks along the batch axis (rank order,
    differentiable); the identity without a group."""
    if axis_name is None:
        return tensors
    return [collectives.gather_rows(t, axis_name) for t in tensors]


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.take_along_dim(logp, labels[:, None], dim=1).mean()


def info_nce(feat_a: torch.Tensor, feat_b: torch.Tensor,
             logit_scale: torch.Tensor, labels: torch.Tensor,
             feat_a_gathered: Optional[torch.Tensor] = None,
             feat_b_gathered: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Symmetric InfoNCE between two normalised feature sets: each side's
    local rows scored against the other side's gathered set (the plain
    square form without gathered args)."""
    a_g = feat_a if feat_a_gathered is None else feat_a_gathered
    b_g = feat_b if feat_b_gathered is None else feat_b_gathered
    logits_ab = logit_scale * torch.matmul(feat_a, b_g.T)
    logits_ba = logit_scale * torch.matmul(feat_b, a_g.T)
    return 0.5 * (_xent(logits_ab, labels) + _xent(logits_ba, labels))


def uni3d_text_image_loss(pc_embed: torch.Tensor, text_embed: torch.Tensor,
                          image_embed: torch.Tensor,
                          logit_scale: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          axis_name=None) -> dict:
    """pc↔text + (masked) pc↔image contrastive loss.

    Args:
      pc_embed/text_embed/image_embed: (B, D), unnormalised.
      logit_scale: the scale itself (exp of the learnt log-scale).
      mask: (B,) 0/1 image-validity mask: rows without a render count in
        neither direction of the image leg.
      axis_name: a process group: the negatives are every rank's rows, and
        the masked leg is normalised by the global mask count.
    Returns:
      dict with loss, uni3d_loss, pc_text_acc and pc_image_acc (in %).
    """
    def norm(x):
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True)
                    + 1e-12)

    pc, tx, im = norm(pc_embed), norm(text_embed), norm(image_embed)
    pc_g, tx_g, im_g = all_gather_batch([pc, tx, im], axis_name)
    B = pc.shape[0]
    offset = 0 if axis_name is None else dist.get_rank(axis_name) * B
    labels = offset + torch.arange(B, device=pc.device)

    loss_pt = info_nce(pc, tx, logit_scale, labels,
                       feat_a_gathered=pc_g, feat_b_gathered=tx_g)
    # the image leg is symmetric like the text leg, both directions masked
    # on this process's rows
    logits_pi = logit_scale * torch.matmul(pc, im_g.T)
    logits_ip = logit_scale * torch.matmul(im, pc_g.T)
    if mask is not None:
        m = mask.to(torch.float32)

        def masked_ce(logits):
            logp = torch.log_softmax(logits, dim=-1)
            per = -torch.take_along_dim(logp, labels[:, None], dim=1)[:, 0]
            # the GLOBAL mask count normalises: ranks with different
            # numbers of valid images weigh their rows as one device would
            num = collectives.sum_across((per * m).sum(), axis_name)
            den = collectives.sum_across(m.sum(), axis_name)
            return num / torch.clamp(den, min=1.0)

        loss_pi = 0.5 * (masked_ce(logits_pi) + masked_ce(logits_ip))
    else:
        loss_pi = 0.5 * (_xent(logits_pi, labels) + _xent(logits_ip, labels))
    loss = loss_pt + loss_pi

    with torch.no_grad():
        hit_t = torch.argmax(logit_scale * torch.matmul(pc, tx_g.T), dim=1)
        hit_i = torch.argmax(logits_pi, dim=1)
        pc_text_acc = (hit_t == labels).to(torch.float32).mean()
        pc_image_acc = (hit_i == labels).to(torch.float32).mean()
    return {"loss": loss, "uni3d_loss": loss,
            "pc_text_acc": 100.0 * pc_text_acc,
            "pc_image_acc": 100.0 * pc_image_acc}
