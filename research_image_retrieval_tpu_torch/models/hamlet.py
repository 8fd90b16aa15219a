"""HAMLET: hierarchical multi-scale features with cross-scale attention
(port of ``research_image_retrieval_tpu/models/hamlet.py``).

The backbone taps stages 3, 4 and 5 (layer2, layer3, layer4); each tap
is projected to ``hidden`` channels, and each scale's tokens attend
(``CrossScaleAttention``: flax LayerNorm, then ``models/layers.Attention``
with 4 heads and biases, residual) over the other two scales' tokens,
pad keys masked.  A ``ContextEnhancedConv`` (3x3, BN, ReLU, then a
dilation-2 3x3, BN, ReLU, residual; the pad region re-zeroed before
each 3x3; flax's train-mode BN when training), shared by the three
scales, follows; each scale is GeM-pooled over its valid cells and the
three vectors are fused by one Linear.  Training is ``hamlet_loss``:
cross entropy + ``hierarchy_weight`` times the consistency of
consecutive scale descriptors, + ``distill_weight`` times the MSE
between the L2 of ``text_head(fused)`` and of the teacher's row when
``text_features`` are given (``text_head`` exists either way).

The backbone runs in ``dtype`` (its identity blocks on the bottleneck
kernel in eval mode), the heads in fp32; no GeM head (the pools feed a
fusion, not a whitening), so the head kernel does not run.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from research_image_retrieval_tpu_torch.models.backbone import (
    BatchNorm,
    ResNet,
    compute_dtype,
    stage_extents,
    train_mode,
)
from research_image_retrieval_tpu_torch.models.layers import (
    Attention,
    LayerNorm,
)
from research_image_retrieval_tpu_torch.models.registry import register_model
from research_image_retrieval_tpu_torch.ops.losses import cross_entropy
from research_image_retrieval_tpu_torch.ops.masking import hw_mask
from research_image_retrieval_tpu_torch.ops.norm import (
    at_least_fp32,
    l2_normalize,
)
from research_image_retrieval_tpu_torch.ops.pooling import gem_pool
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["ContextEnhancedConv", "CrossScaleAttention", "HAMLETModel",
           "hamlet_loss"]

STAGES = (3, 4, 5)


class CrossScaleAttention(nn.Module):
    """Each of three scales' tokens cross-attends to the other two's."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        for i in range(len(STAGES)):
            self.add_module(f"ln{i}", LayerNorm(dim))
            self.add_module(f"cross{i}", Attention(dim, num_heads=4,
                                                   qkv_bias=True))

    @fp32_precision()
    def forward(self, scale_feats, token_masks=None):
        """``scale_feats``: [B, Hi, Wi, dim] maps; ``token_masks``:
        optional [B, Hi * Wi] validity masks (pad tokens are removed from
        every key set)."""
        tokens = [f.reshape(f.shape[0], -1, self.dim) for f in scale_feats]
        outs = []
        for i, t in enumerate(tokens):
            others = torch.cat([tok for j, tok in enumerate(tokens)
                                if j != i], dim=1)
            key_mask = None
            if token_masks is not None:
                key_mask = torch.cat([m for j, m in enumerate(token_masks)
                                      if j != i], dim=1)
            ln, cross = getattr(self, f"ln{i}"), getattr(self, f"cross{i}")
            outs.append(t + cross(ln(t), others, others, key_mask=key_mask))
        return [o.reshape(f.shape) for o, f in zip(outs, scale_feats)]


class ContextEnhancedConv(nn.Module):
    """Dilated context block on a [B, H, W, dim] map (NHWC in and out);
    ``mask`` [B, H, W] re-zeros the pad region before each 3x3."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3, padding=1)
        self.bn1 = BatchNorm(dim)
        self.conv2 = nn.Conv2d(dim, dim, 3, padding=2, dilation=2)
        self.bn2 = BatchNorm(dim)

    @fp32_precision()
    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        m = None if mask is None else mask.to(x.dtype)[:, None]

        def remask(y):
            return y if m is None else y * m

        xc = x.permute(0, 3, 1, 2)  # NCHW view
        y = F.relu(self.bn1(self.conv1(remask(xc))))
        y = F.relu(self.bn2(self.conv2(remask(y))))
        return x + y.permute(0, 2, 3, 1)


def hamlet_loss(logits, labels, scale_descs, text_features=None,
                student_text=None, distill_weight: float = 0.5,
                hierarchy_weight: float = 0.3):
    """(loss, aux): cross entropy, + the distillation MSE of the L2'd
    student and teacher rows when both are given, + the hierarchy
    consistency of consecutive scale descriptors."""
    loss = cross_entropy(logits, labels)
    aux = {"ce": loss}
    if text_features is not None and student_text is not None:
        t = l2_normalize(text_features)
        s = l2_normalize(student_text)
        distill = ((s - t) ** 2).mean()
        loss = loss + distill_weight * distill
        aux["distill"] = distill
    cons = 0.0
    for a, b in zip(scale_descs[:-1], scale_descs[1:]):
        cons = cons + ((l2_normalize(a) - l2_normalize(b)) ** 2).mean()
    loss = loss + hierarchy_weight * cons
    aux["hierarchy"] = cons
    return loss, aux


class HAMLETModel(nn.Module):
    """Backbone taps 3-5 -> projections -> cross-scale attention ->
    context conv -> GeM per scale -> fusion."""

    def __init__(self, backbone_name: str = "resnet50", outputdim: int = 512,
                 num_classes: int = 81313, hidden: int = 256,
                 distill_weight: float = 0.5, hierarchy_weight: float = 0.3,
                 text_dim: int = 768, dtype=torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.backbone = ResNet(backbone_name, dtype=self.dtype,
                               out_stages=STAGES)
        self.distill_weight = distill_weight
        self.hierarchy_weight = hierarchy_weight
        self.text_dim = text_dim  # the teacher table's width
        c5 = self.backbone.outputdim
        for i, c in enumerate((c5 // 4, c5 // 2, c5)):  # layer2, 3, 4
            self.add_module(f"scale_proj{i}", nn.Linear(c, hidden))
        self.cross_scale = CrossScaleAttention(hidden)
        self.context = ContextEnhancedConv(hidden)
        self.fusion = nn.Linear(3 * hidden, outputdim)
        self.text_head = nn.Linear(outputdim, text_dim)
        self.classifier = nn.Linear(outputdim, num_classes)

    def _multi_scale(self, x, valid_hw=None):
        taps = self.backbone(x, valid_hw=valid_hw)
        feats = [getattr(self, f"scale_proj{i}")(at_least_fp32(taps[s]))
                 for i, s in enumerate(STAGES)]
        masks = tmasks = None
        if valid_hw is not None:
            masks = [hw_mask(f.shape[1], f.shape[2],
                             stage_extents(valid_hw, s))
                     for f, s in zip(feats, STAGES)]
            tmasks = [m.reshape(m.shape[0], -1) for m in masks]
        feats = self.cross_scale(feats, token_masks=tmasks)
        feats = [self.context(f, None if masks is None else masks[i])
                 for i, f in enumerate(feats)]
        descs = [gem_pool(f, p=3.0,
                          valid_hw=None if masks is None else masks[i])
                 for i, f in enumerate(feats)]
        return self.fusion(torch.cat(descs, dim=-1)), descs

    @fp32_precision()
    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                train: bool | None = None,
                text_features: torch.Tensor | None = None):
        """Train forward ``(loss, logits)``; ``text_features``: teacher
        rows, [B, text_dim] or [B, L, text_dim] (mean-pooled)."""
        train_mode(self, train)
        fused, descs = self._multi_scale(x)
        logits = self.classifier(fused)
        student_text = None
        if text_features is not None:
            if text_features.dim() == 3:
                text_features = text_features.mean(dim=1)
            text_features = text_features.detach()
            student_text = self.text_head(fused)
        loss, _ = hamlet_loss(logits, labels, descs, text_features,
                              student_text, self.distill_weight,
                              self.hierarchy_weight)
        return loss, logits

    @fp32_precision()
    def extract(self, x: torch.Tensor,
                valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """[B, H, W, 3] images (+ [B, 2] bucket extents) -> [B, D]
        L2-normalized fp32 descriptors."""
        train_mode(self, False)
        return l2_normalize(self._multi_scale(x, valid_hw)[0])


register_model(
    "hamlet_r50",
    description="HAMLET hierarchical multi-scale + cross-scale attention "
                "prototype (reference manus/2_HAMLET/hamlet_model.py)",
    defaults=dict(backbone_name="resnet50", outputdim=512),
    family="hamlet",
)(HAMLETModel)
