"""AdaptiveHybrid: three GeM-family descriptors per image and QAFF fusion
(port of ``research_image_retrieval_tpu/models/adaptive_hybrid.py``).

* SC-GeM — GeM of layer4 gated by a learned token (ReLU / sigmoid MLP),
  projected.
* Regional-GeM — GeM over a 2x2 grid of each image's valid extent,
  concatenated, projected.
* Scale-GeM — GeM at full and half scale, concatenated, projected.  The
  half-scale map is a separable triangle-kernel resize built by
  ``ops/resize.dense_resize_weights`` (antialiased, as
  ``jax.image.resize(..., "bilinear")``), masked or not.
* ``QAFF`` — query-adaptive fusion weights (LayerNorm -> MLP -> softmax
  over the 3 types) applied to gallery descriptor sets at search time
  (``index/gallery.HybridGallery``).
* ``contrastive_loss`` — supervised InfoNCE over a batch.

``extract`` is the equal-weight L2 mean of the three; training is the
contrastive loss plus cross entropy on that mean.  The backbone runs in
``dtype`` (its identity blocks on the bottleneck kernel in eval mode);
the heads run in fp32, as flax promotes a bf16 map against fp32
parameters.  No branch is GeM -> projection -> L2 alone, so the head
kernel does not run.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from research_image_retrieval_tpu_torch.models.backbone import (
    ResNet,
    compute_dtype,
    stage_extents,
    train_mode,
)
from research_image_retrieval_tpu_torch.models.layers import (
    LayerNorm,
    dropout,
)
from research_image_retrieval_tpu_torch.models.registry import register_model
from research_image_retrieval_tpu_torch.ops.losses import cross_entropy
from research_image_retrieval_tpu_torch.ops.masking import hw_mask
from research_image_retrieval_tpu_torch.ops.norm import (
    at_least_fp32,
    l2_normalize,
)
from research_image_retrieval_tpu_torch.ops.pooling import gem_pool
from research_image_retrieval_tpu_torch.ops.resize import dense_resize_weights
from research_image_retrieval_tpu_torch.utils import collectives
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["AdaptiveHybridModel", "QAFF", "contrastive_loss"]


class QAFF(nn.Module):
    """Query-adaptive feature fusion: one LayerNorm shared by the query
    and every gallery set, fusion weights from an MLP on the query."""

    def __init__(self, feature_dim: int, num_feature_types: int = 3,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.layer_norm = LayerNorm(feature_dim)
        self.wg_fc1 = nn.Linear(feature_dim, feature_dim // 2)
        self.wg_fc2 = nn.Linear(feature_dim // 2, feature_dim // 4)
        self.wg_fc3 = nn.Linear(feature_dim // 4, num_feature_types)

    @fp32_precision()
    def forward(self, query_feature: torch.Tensor, gallery_features,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """query_feature [B, D]; gallery_features: a list of [B, D]."""
        ln = self.layer_norm
        h = F.relu(self.wg_fc1(ln(query_feature)))
        h = dropout(h, self.dropout, self.training, generator)
        h = F.relu(self.wg_fc2(h))
        h = dropout(h, self.dropout, self.training, generator)
        w = torch.softmax(self.wg_fc3(h), dim=-1)  # [B, T]
        return sum(w[:, i:i + 1] * ln(g)
                   for i, g in enumerate(gallery_features))


@fp32_precision()
def contrastive_loss(features: torch.Tensor, labels: torch.Tensor,
                     temperature: float = 0.07) -> torch.Tensor:
    """Supervised InfoNCE: each anchor's mean log-softmax (over the other
    rows) of its same-label rows, averaged over anchors that have one;
    under a multi-GPU layout over the global batch
    (``utils.collectives.data_gather_grad``)."""
    features = collectives.data_gather_grad(features)
    labels = collectives.data_gather(labels)
    f = l2_normalize(at_least_fp32(features))
    sims = f @ f.t() / temperature
    B = features.shape[0]
    eye = torch.eye(B, dtype=torch.bool, device=f.device)
    pos = (labels[:, None] == labels[None, :]) & ~eye
    sims = torch.where(eye, float("-inf"), sims)
    logp = sims - torch.logsumexp(sims, dim=1, keepdim=True)
    pos_count = torch.clamp(pos.sum(dim=1), min=1)
    per_anchor = torch.where(pos, logp, 0.0).sum(dim=1) / pos_count
    has_pos = pos.any(dim=1)
    n_valid = torch.clamp(has_pos.sum(), min=1)
    return -torch.where(has_pos, per_anchor, 0.0).sum() / n_valid


class AdaptiveHybridModel(nn.Module):
    """Backbone -> (SC-GeM, Regional-GeM, Scale-GeM)."""

    def __init__(self, backbone_name: str = "resnet50", outputdim: int = 2048,
                 num_classes: int = 81313, p: float = 3.0,
                 temperature: float = 0.07, dtype=torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.backbone = ResNet(backbone_name, dtype=self.dtype)
        C = self.backbone.outputdim
        self.p, self.temperature = p, temperature
        self.token_learner_fc1 = nn.Linear(C, C // 2)
        self.token_learner_fc2 = nn.Linear(C // 2, C)
        self.proj_sc_gem = nn.Linear(C, outputdim)
        self.proj_regional_gem = nn.Linear(4 * C, outputdim)
        self.proj_scale_gem = nn.Linear(2 * C, outputdim)
        self.classifier = nn.Linear(outputdim, num_classes)

    @fp32_precision()
    def descriptors(self, x: torch.Tensor,
                    valid_hw: torch.Tensor | None = None):
        """(sc_gem, regional_gem, scale_gem), each [B, outputdim] fp32.
        With ``valid_hw`` ([B, 2] pixel extents) every branch pools only
        each image's valid layer4 cells, the 2x2 grid splits at the
        per-image half extents and the half-scale resize runs on each
        image's extent: padded output equals the exact-shape run."""
        fmap = at_least_fp32(self.backbone(x, valid_hw=valid_hw))
        B, H, W, C = fmap.shape
        dev = fmap.device
        if valid_hw is None:
            vh = torch.full((B,), H, dtype=torch.int64, device=dev)
            vw = torch.full((B,), W, dtype=torch.int64, device=dev)
            mask = None
        else:
            ext = stage_extents(valid_hw, 5).long()
            vh, vw = ext[:, 0], ext[:, 1]
            mask = hw_mask(H, W, ext)

        # SC-GeM: global GeM gated by a learned token
        g = gem_pool(fmap, p=self.p, valid_hw=mask)
        gate = torch.sigmoid(self.token_learner_fc2(
            F.relu(self.token_learner_fc1(g))))
        sc = self.proj_sc_gem(g * gate)

        # Regional-GeM: 2x2 grid over each image's valid extent; a
        # degenerate extent (1 cell) falls back to the top-left region
        h2 = torch.clamp(vh // 2, min=1)[:, None, None]  # [B, 1, 1]
        w2 = torch.clamp(vw // 2, min=1)[:, None, None]
        rows = torch.arange(H, device=dev)[None, :, None]
        cols = torch.arange(W, device=dev)[None, None, :]
        in_h = rows < vh[:, None, None]
        in_w = cols < vw[:, None, None]
        m_tl = (rows < h2) & (cols < w2)
        m_tr = (rows < h2) & (cols >= w2) & in_w
        m_bl = (rows >= h2) & in_h & (cols < w2)
        m_br = (rows >= h2) & in_h & (cols >= w2) & in_w
        use_tl_w = vw[:, None, None] <= 1
        use_tl_h = vh[:, None, None] <= 1
        m_tr = torch.where(use_tl_w, m_tl, m_tr)
        m_bl = torch.where(use_tl_h, m_tl, m_bl)
        m_br = torch.where(use_tl_h | use_tl_w, m_tl, m_br)
        regions = [gem_pool(fmap, p=self.p, valid_hw=m)
                   for m in (m_tl, m_tr, m_bl, m_br)]
        regional = self.proj_regional_gem(torch.cat(regions, dim=-1))

        # Scale-GeM: full and half scale
        Hh, Wh = max(H // 2, 1), max(W // 2, 1)
        oh = torch.clamp(vh // 2, min=1)
        ow = torch.clamp(vw // 2, min=1)
        wr = dense_resize_weights(vh, oh, H, Hh).to(fmap.dtype)  # [B, Hh, H]
        wc = dense_resize_weights(vw, ow, W, Wh).to(fmap.dtype)  # [B, Wh, W]
        half = torch.einsum("boh,bhwc->bowc", wr, fmap)
        half = torch.einsum("bow,bhwc->bhoc", wc, half)
        half_mask = (None if valid_hw is None
                     else hw_mask(Hh, Wh, torch.stack([oh, ow], dim=1)))
        scale = self.proj_scale_gem(torch.cat(
            [gem_pool(fmap, p=self.p, valid_hw=mask),
             gem_pool(half, p=self.p, valid_hw=half_mask)], dim=-1))
        return sc, regional, scale

    @fp32_precision()
    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                train: bool | None = None):
        """Train forward ``(loss, logits)``: the contrastive loss plus
        cross entropy over the fused descriptor."""
        train_mode(self, train)
        sc, regional, scale = self.descriptors(x)
        fused = (sc + regional + scale) / 3.0
        logits = self.classifier(fused)
        loss = contrastive_loss(fused, labels, self.temperature)
        return loss + cross_entropy(logits, labels), logits

    @fp32_precision()
    def extract(self, x: torch.Tensor,
                valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """[B, H, W, 3] images (+ [B, 2] bucket extents) -> [B, D] the
        equal-weight fused descriptor, L2-normalized fp32."""
        train_mode(self, False)
        sc, regional, scale = self.descriptors(x, valid_hw)
        return l2_normalize((sc + regional + scale) / 3.0)


register_model(
    "adaptive_hybrid_r50",
    description="AdaptiveHybrid 3-descriptor model with QAFF serving "
                "(reference manus/7)",
    defaults=dict(backbone_name="resnet50"),
    family="adaptive_hybrid",
)(AdaptiveHybridModel)
