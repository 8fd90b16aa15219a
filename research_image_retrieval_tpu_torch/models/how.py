"""HOW-VLAD / HOW-ASMK: aggregated local descriptors
(port of ``research_image_retrieval_tpu/models/how.py``).

layer4 -> a 1x1 ``local_proj`` (with bias) -> each cell's vector
L2-normalized -> VLAD or ASMK over the ``K`` learnable ``centroids`` ->
``final_proj`` (Linear); training is cross entropy over a Linear
``classifier``.

* VLAD: soft assignment ``softmax(-alpha * dist)`` over the clusters,
  residuals summed per cluster (``a^T x - mass * c``), L2-normalized
  ``[B, K*D]``.
* ASMK: each token's nearest centroid; a token is kept when its distance
  is below its image's mean + std of those distances (strictly); each
  kept token adds its cluster's learnable weight; L2-normalized
  ``[B, K]``.

Distances are computed as JAX computes them, ``sqrt(max(|x|^2 - 2 x.c +
|c|^2, 1e-12))``, not by ``torch.cdist``, which rounds otherwise.  With
a token mask the pad tokens carry no assignment mass, and ASMK's mean,
std and counts run over the valid tokens only.  ASMK's selection is a
discontinuous function of the distances: a rounding change can move a
near-tied token's centroid or keep bit (``asmk_select`` gives both, for
checks that must tell such ties apart).

The backbone runs in ``dtype`` (its identity blocks on the bottleneck
kernel in eval mode); the head runs in fp32.  No GeM head here, so the
head kernel does not run.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from research_image_retrieval_tpu_torch.models.backbone import (
    ResNet,
    compute_dtype,
    nchw_conv,
    stage_extents,
    train_mode,
)
from research_image_retrieval_tpu_torch.models.registry import register_model
from research_image_retrieval_tpu_torch.ops.losses import cross_entropy
from research_image_retrieval_tpu_torch.ops.masking import token_mask
from research_image_retrieval_tpu_torch.ops.norm import (
    at_least_fp32,
    l2_normalize,
)
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["HOWModel", "asmk_aggregate", "asmk_select", "vlad_aggregate"]


def _distances(x: torch.Tensor, centroids: torch.Tensor):
    """[B, N, K] Euclidean distances of tokens [B, N, D] to centroids
    [K, D], in JAX's form."""
    d2 = ((x * x).sum(-1, keepdim=True)
          - 2.0 * torch.einsum("bnd,kd->bnk", x, centroids)
          + (centroids * centroids).sum(-1))
    return torch.sqrt(torch.clamp(d2, min=1e-12))


@fp32_precision()
def vlad_aggregate(x: torch.Tensor, centroids: torch.Tensor,
                   alpha: float = 100.0,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """Soft-assignment VLAD of tokens [B, N, D] (``mask`` [B, N]: token
    validity) -> L2-normalized [B, K*D]."""
    B, _, D = x.shape
    K = centroids.shape[0]
    assign = torch.softmax(-alpha * _distances(x, centroids), dim=2)
    if mask is not None:
        assign = assign * mask.to(assign.dtype)[..., None]
    ax = torch.einsum("bnk,bnd->bkd", assign, x)
    mass = assign.sum(dim=1)  # [B, K]
    vlad = ax - mass[..., None] * centroids[None]
    return l2_normalize(vlad.reshape(B, K * D))


@fp32_precision()
def asmk_select(x: torch.Tensor, centroids: torch.Tensor,
                mask: torch.Tensor | None = None):
    """(nearest [B, N] centroid ids, keep [B, N] in {0, 1}, distances
    [B, N, K], threshold [B, 1]) of ASMK's selection."""
    dist = _distances(x, centroids)
    min_d, nearest = dist.min(dim=2)
    n = min_d.shape[1]
    if mask is None:
        # unbiased std; one token gets std 0, and the strict test then
        # keeps nothing (JAX's code; its comment says everything)
        std = (torch.std(min_d, dim=1, keepdim=True) if n > 1
               else torch.zeros_like(min_d[:, :1]))
        thresh = min_d.mean(dim=1, keepdim=True) + std
        keep = (min_d < thresh).to(min_d.dtype)
    else:
        m = mask.to(min_d.dtype)
        cnt = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
        mean = (min_d * m).sum(dim=1, keepdim=True) / cnt
        var = (m * (min_d - mean) ** 2).sum(dim=1, keepdim=True) / \
            torch.clamp(cnt - 1.0, min=1.0)
        thresh = mean + torch.sqrt(var)
        keep = (min_d < thresh).to(min_d.dtype) * m
    return nearest, keep, dist, thresh


def asmk_aggregate(x: torch.Tensor, centroids: torch.Tensor,
                   weights: torch.Tensor,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """Selective match-kernel aggregation of tokens [B, N, D] ->
    L2-normalized [B, K]: each kept token adds its nearest cluster's
    weight."""
    nearest, keep, _, _ = asmk_select(x, centroids, mask)
    one_hot = F.one_hot(nearest, centroids.shape[0]).to(keep.dtype)
    counts = torch.einsum("bn,bnk->bk", keep, one_hot)
    return l2_normalize(counts * weights[None])


class HOWModel(nn.Module):
    """HOW local-descriptor model with VLAD or ASMK aggregation."""

    def __init__(self, backbone_name: str = "resnet50",
                 pooling_type: str = "vlad", local_dim: int = 128,
                 num_clusters: int = 64, outputdim: int = 2048,
                 num_classes: int = 81313, alpha: float = 100.0,
                 dtype=torch.float32):
        super().__init__()
        if pooling_type not in ("vlad", "asmk"):
            raise ValueError(f"Unsupported pooling type: {pooling_type}")
        self.dtype = compute_dtype(dtype)
        self.pooling_type, self.alpha = pooling_type, alpha
        self.backbone = ResNet(backbone_name, dtype=self.dtype)
        self.local_proj = nn.Conv2d(self.backbone.outputdim, local_dim, 1)
        self.centroids = nn.Parameter(torch.rand(num_clusters, local_dim))
        if pooling_type == "asmk":
            self.weights = nn.Parameter(torch.ones(num_clusters))
        pooled = num_clusters * local_dim if pooling_type == "vlad" \
            else num_clusters
        self.final_proj = nn.Linear(pooled, outputdim)
        self.classifier = nn.Linear(outputdim, num_classes)

    def reset_flax(self, generator: torch.Generator):
        """flax's laws for the bare parameters (``training_init``):
        centroids ``uniform(1.0)`` = U[0, 1), ASMK weights 1."""
        with torch.no_grad():
            self.centroids.copy_(torch.rand(self.centroids.shape,
                                            generator=generator))
            if self.pooling_type == "asmk":
                self.weights.fill_(1.0)

    def _locals(self, x, valid_hw=None):
        """(L2-normalized local descriptors [B, H*W, local_dim], the
        [B, H*W] token mask or None)."""
        fmap = at_least_fp32(self.backbone(x, valid_hw=valid_hw))
        loc = nchw_conv(self.local_proj, fmap)
        B, H, W, D = loc.shape
        tmask = None
        if valid_hw is not None:
            tmask = token_mask(H, W, stage_extents(valid_hw, 5))
        return l2_normalize(loc.reshape(B, H * W, D)), tmask

    def _features(self, x, valid_hw=None):
        loc, tmask = self._locals(x, valid_hw)
        if self.pooling_type == "vlad":
            pooled = vlad_aggregate(loc, self.centroids, self.alpha,
                                    mask=tmask)
        else:
            pooled = asmk_aggregate(loc, self.centroids, self.weights,
                                    mask=tmask)
        return self.final_proj(pooled)

    @fp32_precision()
    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                train: bool | None = None):
        """Train forward ``(loss, logits)``."""
        train_mode(self, train)
        logits = self.classifier(self._features(x))
        return cross_entropy(logits, labels), logits

    @fp32_precision()
    def extract(self, x: torch.Tensor,
                valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """[B, H, W, 3] images (+ [B, 2] bucket extents) -> [B, outputdim]
        L2-normalized fp32 descriptors."""
        train_mode(self, False)
        return l2_normalize(self._features(x, valid_hw))


register_model(
    "how_vlad_r50",
    description="HOW with soft-assignment VLAD aggregation (reference "
                "models/how_vlad.py:14)",
    defaults=dict(backbone_name="resnet50", pooling_type="vlad"),
    family="how",
    paper="Tolias et al., HOW (ECCV 2020)",
    table1_names=("R50-HOW-VLAD",),
)(HOWModel)

register_model(
    "how_asmk_r50",
    description="HOW with selective match-kernel (ASMK) aggregation",
    defaults=dict(backbone_name="resnet50", pooling_type="asmk"),
    family="how_asmk",
    table1_names=("R50-HOW-ASMK",),
)(HOWModel)
