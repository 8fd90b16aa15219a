"""Margin classification loss of the flagship and its metrics
(port of ``cross_entropy``, ``arcface_logits``, ``arcface_delg_logits``,
``madacos_loss`` and ``topk_errors`` of
``research_image_retrieval_tpu/ops/losses.py``).

The classifier weight is an explicit argument, as in the JAX functions;
``arcface_delg_logits`` returns its EMA state instead of mutating it.

Inside ``utils.collectives.active_mesh`` the weight may be this
rank's column shard ``[num_classes, D / model]`` (``parallel.mesh``):
the row norms ``||w_c||^2`` and the partial dot products are then summed
over the model group.  The batch statistics (MadaCos' median and means,
DELG's mean target cosine) are taken over the global batch, over the
data group; the losses themselves stay each rank's mean over its shard,
whose gradients the train step averages.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from research_image_retrieval_tpu_torch.ops.norm import (
    at_least_fp32,
    l2_normalize,
)
from research_image_retrieval_tpu_torch.utils import collectives

__all__ = ["arcface_delg_logits", "arcface_logits", "class_cosines",
           "cross_entropy",
           "madacos_loss", "topk_errors"]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy with integer labels (fp32; float64
    input stays float64, as in every function here)."""
    logits = at_least_fp32(logits)
    logz = torch.logsumexp(logits, dim=-1)
    target = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    return (logz - target).mean()


def class_cosines(features: torch.Tensor,
                  weight: torch.Tensor) -> torch.Tensor:
    """``l2n(features) @ l2n(weight).T`` ``[B, num_classes]`` in at least
    fp32; a column-shard ``weight`` is reduced over the model group."""
    feats = l2_normalize(at_least_fp32(features))
    w = at_least_fp32(weight)
    shard = collectives.model_shard(feats.shape[-1], w)
    if shard is None:
        return torch.matmul(feats, l2_normalize(w).t())
    # both sums feed only what every rank of the group computes alike
    # (the division and the loss), so their backward is the identity
    group, cols = shard
    sq = collectives.reduce_from_group((w * w).sum(-1), group)
    dot = collectives.reduce_from_group(torch.matmul(
        collectives.copy_to_group(feats, group)[:, cols], w.t()), group)
    return dot / torch.clamp(torch.sqrt(sq), min=1e-12)


def arcface_logits(features: torch.Tensor, weight: torch.Tensor,
                   labels: torch.Tensor, s: float = 64.0, m: float = 0.50,
                   eps: float = 1e-6) -> torch.Tensor:
    """Additive angular margin (ArcFace) logits ``[B, num_classes]``.

    ``features`` [B, D] and ``weight`` [num_classes, D] are L2-normalized
    here.  The margin is added to the target class's angle only, and not
    where ``theta > pi - m`` (the angle would wrap).
    """
    cos_theta = class_cosines(features, weight)
    theta = torch.arccos(torch.clamp(cos_theta, -1.0 + eps, 1.0 - eps))
    one_hot = F.one_hot(labels.long(), weight.shape[0]).bool()
    selected = one_hot & ~(theta > (math.pi - m))
    return torch.cos(torch.where(selected, theta + m, theta)) * s


def arcface_delg_logits(features: torch.Tensor, weight: torch.Tensor,
                        labels: torch.Tensor, t_state: torch.Tensor,
                        s: float = 64.0, m: float = 0.50, eps: float = 1e-6):
    """DELG's ArcFace with hard-example rescaling: the target logit is
    ``cos(theta + m)`` by cos algebra, or ``cos - sin(pi - m) * m`` below
    ``cos(pi - m)``; non-target cosines above the margined target are
    rescaled to ``(t + cos) * cos``, ``t`` an EMA of the batch's mean
    target cosine.  Returns ``(logits [B, C], new_t_state [1])``; the new
    state carries no gradient."""
    cos_m, sin_m = math.cos(m), math.sin(m)
    threshold = math.cos(math.pi - m)
    mm = math.sin(math.pi - m) * m
    cos_theta = torch.clamp(class_cosines(features, weight),
                            -1.0 + eps, 1.0 - eps)
    target = torch.gather(cos_theta, 1, labels[:, None].long())  # [B, 1]
    sin_theta = torch.sqrt(torch.clamp(1.0 - target ** 2, min=0.0))
    cos_theta_m = target * cos_m - sin_theta * sin_m
    new_t = (collectives.data_mean(target.mean()) * 0.01
             + 0.99 * t_state.reshape(())).detach().reshape(1)
    out = torch.where(cos_theta > cos_theta_m,
                      cos_theta * (new_t[0] + cos_theta), cos_theta)
    final_target = torch.where(target > threshold, cos_theta_m, target - mm)
    one_hot = F.one_hot(labels.long(), weight.shape[0]).bool()
    return torch.where(one_hot, final_target, out) * s, new_t


def madacos_loss(features: torch.Tensor, weight: torch.Tensor,
                 labels: torch.Tensor, rho: float = 0.04, t: float = 0.1,
                 sigma: float = 0.1, fixed_scale: float | None = None,
                 fixed_margin: float | None = None):
    """Margin-adaptive cosine loss (MadaCos, ULTRON eqs 13-15).

    scale ``s = log((1-t)(1-rho)/sigma) / (1 - median(target_cos))`` with
    the LOWER median (``sort[(n-1)//2]``, torch.median's rule);
    margin ``m = mean(target_cos) - 0.5 log(rho E[sum_j exp(s cos_j)] /
    (1-rho))`` clamped to [0, 1], the target column zeroed BEFORE the exp
    (it adds exp(0) = 1 to each row); logits ``s (cos_t - m)`` at the
    target and ``s cos`` elsewhere; cross entropy over them.  Scale and
    margin carry no gradient.  Returns ``(loss, {"scale", "margin",
    "logits"})``."""
    cos = class_cosines(features, weight)
    lab = labels.long()
    target_cos = torch.gather(cos, 1, lab[:, None])[:, 0]
    if fixed_scale is not None:
        scale = torch.tensor(fixed_scale, dtype=cos.dtype, device=cos.device)
    else:
        every = collectives.data_gather(target_cos.detach())
        median = torch.sort(every).values[(every.shape[0] - 1) // 2]
        scale = math.log((1.0 - t) * (1.0 - rho) / sigma) \
            / (1.0 - median + 1e-8)
    if fixed_margin is not None:
        margin = torch.tensor(fixed_margin, dtype=cos.dtype,
                              device=cos.device)
    else:
        one_hot = F.one_hot(lab, weight.shape[0]).to(cos.dtype)
        mean_cos = collectives.data_mean(target_cos.detach().mean())
        neg_cos = cos.detach() * (1.0 - one_hot)
        exp_sum = collectives.data_mean(
            torch.exp(scale * neg_cos).sum(dim=1).mean())
        margin = torch.clamp(
            mean_cos - 0.5 * torch.log(rho * exp_sum / (1.0 - rho) + 1e-8),
            0.0, 1.0)
    target_entry = scale * (target_cos - margin)
    hot = F.one_hot(lab, weight.shape[0]).bool()
    logits = torch.where(hot, target_entry[:, None], scale * cos)
    return cross_entropy(logits, labels), {"scale": scale, "margin": margin,
                                           "logits": logits}


def topk_errors(logits: torch.Tensor, labels: torch.Tensor, ks=(1, 5)):
    """Top-k error percentages, k clamped to the class count (a head with
    fewer classes than k reports 0)."""
    ks = tuple(min(k, logits.shape[-1]) for k in ks)
    _, top_idx = torch.topk(logits, max(ks), dim=-1)
    correct = top_idx == labels[:, None].to(top_idx.device)
    return [(1.0 - correct[:, :k].any(dim=1).to(torch.float32).mean()) * 100.0
            for k in ks]
