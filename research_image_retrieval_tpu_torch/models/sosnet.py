"""SoSNet: second-order (covariance) pooling
(port of ``research_image_retrieval_tpu/models/sosnet.py``).

Per-position attention (an MLP on each layer4 cell -> sigmoid) scales
the map, a 1x1 ``so_proj`` (with bias) takes it to ``second_order_dim``,
the covariance over the HW tokens (N - 1) gives the upper triangle
(C(C+1)/2 values), L2-normalized, then ``proj_fc1`` -> ReLU -> dropout
-> ``proj_fc2``; training is cross entropy over a Linear classifier.

The backbone runs in ``dtype`` (its identity blocks on the bottleneck
kernel in eval mode); the head runs in fp32, as flax promotes a bf16 map
against its fp32 parameters.  No GeM head here, so the head kernel does
not run.  Dropout draws from the ``generator`` the train step passes
(``models/layers.dropout``).
"""

from __future__ import annotations

import numpy as np
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
from research_image_retrieval_tpu_torch.models.layers import dropout
from research_image_retrieval_tpu_torch.models.registry import register_model
from research_image_retrieval_tpu_torch.ops.losses import cross_entropy
from research_image_retrieval_tpu_torch.ops.masking import hw_mask
from research_image_retrieval_tpu_torch.ops.norm import (
    at_least_fp32,
    l2_normalize,
)
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["SoSNetModel", "second_order_pool"]


@fp32_precision()
def second_order_pool(x: torch.Tensor,
                      valid_hw: torch.Tensor | None = None) -> torch.Tensor:
    """[B, H, W, C] -> [B, C(C+1)/2] upper-triangular covariance,
    L2-normalized.  ``valid_hw`` [B, H, W] restricts mean, centering and
    count to the valid tokens (the exact-shape result)."""
    B, H, W, C = x.shape
    n = H * W
    tokens = at_least_fp32(x).reshape(B, n, C)
    if valid_hw is None:
        centered = tokens - tokens.mean(dim=1, keepdim=True)
        denom = max(n - 1, 1)
    else:
        m = valid_hw.to(tokens.dtype).reshape(B, n, 1)
        cnt = torch.clamp(m.sum(dim=1, keepdim=True), min=1.0)
        mean = (tokens * m).sum(dim=1, keepdim=True) / cnt
        centered = (tokens - mean) * m  # pad tokens out of the covariance
        denom = torch.clamp(cnt - 1.0, min=1.0)  # [B, 1, 1]
    cov = torch.bmm(centered.transpose(1, 2), centered) / denom
    rows, cols = (torch.as_tensor(i, device=cov.device)
                  for i in np.triu_indices(C))
    flat = cov[:, rows, cols]
    return l2_normalize(flat)


class SoSNetModel(nn.Module):
    """Backbone -> attention -> 1x1 -> covariance -> MLP."""

    takes_generator = True  # the train step passes its dropout generator

    def __init__(self, backbone_name: str = "resnet50", outputdim: int = 2048,
                 second_order_dim: int = 512, num_classes: int = 81313,
                 use_attention: bool = True, dropout: float = 0.5,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.backbone = ResNet(backbone_name, dtype=self.dtype)
        C = self.backbone.outputdim
        self.use_attention = use_attention
        self.dropout = dropout
        self.so_proj = nn.Conv2d(C, second_order_dim, 1)
        self.attn_fc1 = nn.Linear(C, 512)
        self.attn_fc2 = nn.Linear(512, 256)
        self.attn_fc3 = nn.Linear(256, 1)
        so = second_order_dim * (second_order_dim + 1) // 2
        self.proj_fc1 = nn.Linear(so, outputdim)
        self.proj_fc2 = nn.Linear(outputdim, outputdim)
        self.classifier = nn.Linear(outputdim, num_classes)

    def _features(self, x, valid_hw=None, generator=None):
        fmap = at_least_fp32(self.backbone(x, valid_hw=valid_hw))
        mask = None
        if valid_hw is not None:
            mask = hw_mask(fmap.shape[1], fmap.shape[2],
                           stage_extents(valid_hw, 5))
        if self.use_attention:
            a = F.relu(self.attn_fc1(fmap))
            a = F.relu(self.attn_fc2(a))
            fmap = fmap * torch.sigmoid(self.attn_fc3(a))  # [B, H, W, 1]
        # so_proj's bias leaks into pad cells; the masked covariance
        # leaves them out exactly
        so = second_order_pool(nchw_conv(self.so_proj, fmap), valid_hw=mask)
        h = dropout(F.relu(self.proj_fc1(so)), self.dropout, self.training,
                    generator)
        return self.proj_fc2(h)

    @fp32_precision()
    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                train: bool | None = None,
                generator: torch.Generator | None = None):
        """Train forward ``(loss, logits)``; in train mode the dropout
        draws from ``generator``."""
        train_mode(self, train)
        logits = self.classifier(self._features(x, generator=generator))
        return cross_entropy(logits, labels), logits

    @fp32_precision()
    def extract(self, x: torch.Tensor,
                valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """[B, H, W, 3] images (+ [B, 2] bucket extents) -> [B, D]
        L2-normalized fp32 descriptors."""
        train_mode(self, False)
        return l2_normalize(self._features(x, valid_hw))


register_model(
    "sosnet_r50",
    description="SoSNet second-order covariance pooling (reference "
                "models/sosnet.py:95)",
    defaults=dict(backbone_name="resnet50", second_order_dim=128),
    family="sosnet",
    table1_names=("R50-SoSNet",),
)(SoSNetModel)
