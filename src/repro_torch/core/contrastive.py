"""Symmetric InfoNCE / NT-Xent (paper §3.3.3, eqs. 2-4); counterpart of
``repro/core/contrastive.py``."""

from __future__ import annotations

import torch


def l2_normalize(z: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return z / torch.clamp_min(torch.linalg.norm(z, dim=-1, keepdim=True), eps)


def info_nce(z1: torch.Tensor, z2: torch.Tensor, tau: float):
    """z1, z2: (B, d) projected views.  Returns (loss, metrics), all 0-d
    tensors on the views' device.  Computed in float32 whatever the
    policy's compute dtype (the logits and softmax are the numerically
    sensitive part)."""
    z1 = l2_normalize(z1.float())
    z2 = l2_normalize(z2.float())
    S = (z1 @ z2.T) / tau                                      # eq. 2

    def ce(S):                                                 # eq. 3
        return -torch.mean(torch.diagonal(torch.log_softmax(S, dim=-1)))

    loss = 0.5 * (ce(S) + ce(S.T))                             # eq. 4
    B = S.shape[0]
    ar = torch.arange(B, device=S.device)
    acc = torch.mean((torch.argmax(S, dim=-1) == ar).float())
    pos = torch.mean(torch.diagonal(S)) * tau
    neg = (torch.sum(S) - torch.trace(S)) / max(B * (B - 1), 1) * tau
    return loss, {"nce_acc": acc, "pos_sim": pos, "neg_sim": neg}
