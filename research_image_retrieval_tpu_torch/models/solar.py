"""SOLAR: second-order attention over layer4, then GeM
(port of ``research_image_retrieval_tpu/models/solar.py``).

SOA block: ``f``, ``g`` = 1x1 -> BN -> ReLU, ``h`` = 1x1, all to C/k;
``attn = softmax(f g^T / sqrt(C/k))`` over the H*W keys (padded keys
masked with a large finite negative), ``z = attn h``, then ``v`` (1x1 back
to C, zero-initialized, so the block starts as the identity) plus the
residual.  Descriptor: GeM (p = 3) -> L2 -> whiten (Linear) -> L2; train
logits are ArcFace with ``s = sqrt(outputdim)``.

The backbone runs in ``dtype`` (its identity blocks on the bottleneck
kernel in eval mode); the head runs in fp32, as flax promotes a bf16 map
against its fp32 parameters.  The head's GeM feeds an L2 before the
whiten projection, which is not the GeM head kernel's function, so it
runs as plain PyTorch.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from research_image_retrieval_tpu_torch.models.backbone import (
    BatchNorm,
    ResNet,
    compute_dtype,
    nchw_conv,
    stage_extents,
    train_mode,
)
from research_image_retrieval_tpu_torch.models.registry import register_model
from research_image_retrieval_tpu_torch.ops.losses import (
    arcface_logits,
    cross_entropy,
)
from research_image_retrieval_tpu_torch.ops.masking import (
    hw_mask,
    mask_attn_logits,
)
from research_image_retrieval_tpu_torch.ops.norm import (
    at_least_fp32,
    l2_normalize,
)
from research_image_retrieval_tpu_torch.ops.pooling import gem_pool
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["SOABlock", "SOLARModel"]


class SOABlock(nn.Module):
    """Second-order attention residual block on an NHWC map."""

    def __init__(self, channels: int, k: int = 2):
        super().__init__()
        mid = channels // k
        self.f = nn.Conv2d(channels, mid, 1)
        self.f_bn = BatchNorm(mid)
        self.g = nn.Conv2d(channels, mid, 1)
        self.g_bn = BatchNorm(mid)
        self.h = nn.Conv2d(channels, mid, 1)
        self.v = nn.Conv2d(mid, channels, 1)
        self.v.zero_init = True  # training_init keeps it zero
        nn.init.zeros_(self.v.weight)
        nn.init.zeros_(self.v.bias)

    def forward(self, x: torch.Tensor,
                token_mask: torch.Tensor | None = None) -> torch.Tensor:
        """x: [B, H, W, C]; ``token_mask`` [B, H*W] drops padded keys."""
        B, H, W, _ = x.shape

        def tokens(y):  # NCHW -> [B, H*W, mid], row-major HW
            return y.permute(0, 2, 3, 1).reshape(B, H * W, -1)

        xc = x.permute(0, 3, 1, 2)
        f = tokens(F.relu(self.f_bn(self.f(xc))))
        g = tokens(F.relu(self.g_bn(self.g(xc))))
        h = tokens(self.h(xc))
        mid = f.shape[-1]
        attn = torch.bmm(f, g.transpose(1, 2)) * mid ** -0.5
        if token_mask is not None:
            attn = mask_attn_logits(attn, token_mask)
        z = torch.bmm(torch.softmax(attn, dim=-1), h).reshape(B, H, W, mid)
        return nchw_conv(self.v, z) + x


class SOLARModel(nn.Module):
    """Backbone -> SOA -> GeM -> L2 -> whiten, with an ArcFace head."""

    def __init__(self, backbone_name: str = "resnet101",
                 outputdim: int = 2048, num_classes: int = 81313,
                 soa_k: int = 2, m: float = 0.15, dtype=torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.backbone = ResNet(backbone_name, dtype=self.dtype)
        self.soa = SOABlock(self.backbone.outputdim, k=soa_k)
        self.whiten = nn.Linear(self.backbone.outputdim, outputdim)
        self.m = m
        self.classifier_w = nn.Parameter(torch.empty(num_classes, outputdim))
        nn.init.xavier_uniform_(self.classifier_w)

    def _descriptor(self, x, valid_hw=None):
        fmap = at_least_fp32(self.backbone(x, valid_hw=valid_hw))
        mask = tmask = None
        if valid_hw is not None:
            mask = hw_mask(fmap.shape[1], fmap.shape[2],
                           stage_extents(valid_hw, 5))
            tmask = mask.reshape(mask.shape[0], -1)
        fmap = self.soa(fmap, token_mask=tmask)
        pooled = gem_pool(fmap, p=3.0, valid_hw=mask)
        return self.whiten(l2_normalize(pooled))

    @fp32_precision()
    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                train: bool | None = None):
        """Train forward ``(loss, logits)``; eval logits carry no margin."""
        train = train_mode(self, train)
        logits = arcface_logits(self._descriptor(x), self.classifier_w,
                                labels, s=math.sqrt(self.whiten.out_features),
                                m=self.m if train else 0.0)
        return cross_entropy(logits, labels), logits

    @fp32_precision()
    def extract(self, x: torch.Tensor,
                valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """[B, H, W, 3] images (+ [B, 2] bucket extents) -> [B, D]
        L2-normalized fp32 descriptors."""
        train_mode(self, False)
        return l2_normalize(self._descriptor(x, valid_hw))


register_model(
    "solar_r101",
    description="SOLAR second-order attention + GeM over ResNet101 "
                "(reference RetrievalNet.py:572)",
    defaults=dict(backbone_name="resnet101", outputdim=2048),
    family="solar",
    paper="Ng et al., SOLAR (ECCV 2020)",
    table1_names=("R101-SOLAR",),
)(SOLARModel)

register_model(
    "solar_r50",
    description="SOLAR over ResNet50",
    defaults=dict(backbone_name="resnet50", outputdim=2048),
    family="solar",
)(SOLARModel)
