"""DELG: a global descriptor and attention-weighted local features
(port of ``research_image_retrieval_tpu/models/delg.py``).

Global: GeM (p = 3, eps 1e-6) over layer4's valid cells -> ``global_proj``
(Linear with bias) -> L2, which is the GeM head's function: ``extract``
runs it through ``ops/gem_head.gem_whiten_l2`` (the hand-written kernel
on CUDA, its plain version on the CPU), the projection weight read in
fp32.  Local: a 1x1 ``local_conv`` gives the local descriptors (each
cell's vector L2-normalized) and a 1x1 ``attention_conv`` + sigmoid their
attention, for the geometric rerank (``index/rerank.py``).  Training is
cross entropy over a Linear ``classifier`` on the projected global
feature.

The backbone runs in ``dtype`` (its identity blocks on the bottleneck
kernel in eval mode); the head reads the map in fp32, as flax promotes a
bf16 map against its fp32 parameters (the head kernel pools a bf16 map
in fp32).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from research_image_retrieval_tpu_torch.models.backbone import (
    ResNet,
    compute_dtype,
    nchw_conv,
    stage_extents,
    train_mode,
)
from research_image_retrieval_tpu_torch.models.registry import register_model
from research_image_retrieval_tpu_torch.ops.gem_head import gem_whiten_l2
from research_image_retrieval_tpu_torch.ops.losses import cross_entropy
from research_image_retrieval_tpu_torch.ops.norm import (
    at_least_fp32,
    l2_normalize,
)
from research_image_retrieval_tpu_torch.ops.pooling import gem_pool
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["DELGModel"]


class DELGModel(nn.Module):
    """DELG global + local features over a ResNet."""

    def __init__(self, backbone_name: str = "resnet50", outputdim: int = 2048,
                 local_dim: int = 1024, num_classes: int = 81313,
                 p: float = 3.0, dtype=torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.backbone = ResNet(backbone_name, dtype=self.dtype)
        C = self.backbone.outputdim
        self.p = p
        self.global_proj = nn.Linear(C, outputdim)
        self.local_conv = nn.Conv2d(C, local_dim, 1)
        self.attention_conv = nn.Conv2d(C, 1, 1)
        self.classifier = nn.Linear(outputdim, num_classes)

    @fp32_precision()
    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                train: bool | None = None):
        """Train forward ``(loss, logits)`` (cross entropy, no margin)."""
        train_mode(self, train)
        fmap = self.backbone(x)
        logits = self.classifier(self.global_proj(gem_pool(fmap, p=self.p)))
        return cross_entropy(logits, labels), logits

    @fp32_precision()
    def extract(self, x: torch.Tensor,
                valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """[B, H, W, 3] images (+ [B, 2] bucket extents) -> [B, D]
        L2-normalized fp32 global descriptors, through the GeM head."""
        train_mode(self, False)
        fmap = self.backbone(x, valid_hw=valid_hw).contiguous()
        ext = None if valid_hw is None else stage_extents(valid_hw, 5)
        return gem_whiten_l2(fmap, self.global_proj.weight,
                             self.global_proj.bias, p=self.p, extents=ext,
                             weight_dtype=torch.float32)

    @fp32_precision()
    def extract_local(self, x: torch.Tensor):
        """(locals [B, H*W, local_dim], each cell L2-normalized;
        attention [B, H*W]), cells in row-major (h, w) order."""
        train_mode(self, False)
        fmap = at_least_fp32(self.backbone(x))
        B, H, W, _ = fmap.shape
        local = nchw_conv(self.local_conv, fmap).reshape(B, H * W, -1)
        att = torch.sigmoid(nchw_conv(self.attention_conv, fmap))
        return l2_normalize(local), att.reshape(B, H * W)


register_model(
    "delg_r50",
    description="DELG global+local features over ResNet50 (reference "
                "models/delg.py:32)",
    defaults=dict(backbone_name="resnet50"),
    family="delg",
    paper="Cao et al., Unifying Deep Local and Global Features (ECCV 2020)",
    table1_names=("R50-DELG",),
)(DELGModel)

register_model(
    "delg_r101",
    description="DELG over ResNet101",
    defaults=dict(backbone_name="resnet101"),
    family="delg",
    table1_names=("R101-DELG",),
)(DELGModel)
