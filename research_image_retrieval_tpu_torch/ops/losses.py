"""Margin classification loss of the flagship and its metrics
(port of ``cross_entropy``, ``arcface_logits`` and ``topk_errors`` of
``research_image_retrieval_tpu/ops/losses.py``).

The classifier weight is an explicit argument, as in the JAX functions.
``arcface_delg_logits`` and ``madacos_loss`` belong to the DELG and
ULTRON models and are not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from research_image_retrieval_tpu_torch.ops.norm import l2_normalize

__all__ = ["arcface_logits", "cross_entropy", "topk_errors"]


def _at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy with integer labels (fp32; float64
    input stays float64, as in every function here)."""
    logits = _at_least_fp32(logits)
    logz = torch.logsumexp(logits, dim=-1)
    target = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    return (logz - target).mean()


def arcface_logits(features: torch.Tensor, weight: torch.Tensor,
                   labels: torch.Tensor, s: float = 64.0, m: float = 0.50,
                   eps: float = 1e-6) -> torch.Tensor:
    """Additive angular margin (ArcFace) logits ``[B, num_classes]``.

    ``features`` [B, D] and ``weight`` [num_classes, D] are L2-normalized
    here.  The margin is added to the target class's angle only, and not
    where ``theta > pi - m`` (the angle would wrap).
    """
    cos_theta = torch.matmul(l2_normalize(_at_least_fp32(features)),
                             l2_normalize(_at_least_fp32(weight)).t())
    theta = torch.arccos(torch.clamp(cos_theta, -1.0 + eps, 1.0 - eps))
    one_hot = F.one_hot(labels.long(), weight.shape[0]).bool()
    selected = one_hot & ~(theta > (math.pi - m))
    return torch.cos(torch.where(selected, theta + m, theta)) * s


def topk_errors(logits: torch.Tensor, labels: torch.Tensor, ks=(1, 5)):
    """Top-k error percentages, k clamped to the class count (a head with
    fewer classes than k reports 0)."""
    ks = tuple(min(k, logits.shape[-1]) for k in ks)
    _, top_idx = torch.topk(logits, max(ks), dim=-1)
    correct = top_idx == labels[:, None].to(top_idx.device)
    return [(1.0 - correct[:, :k].any(dim=1).to(torch.float32).mean()) * 100.0
            for k in ks]
