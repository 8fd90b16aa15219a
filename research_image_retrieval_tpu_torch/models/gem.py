"""GeM global-descriptor model
(port of ``research_image_retrieval_tpu/models/gem.py``).

train:   backbone -> GeM -> whiten (Linear) -> ArcFace(s, m) -> cross
         entropy (``forward``; plain PyTorch and cuDNN under autograd, as
         the JAX step is plain XLA under ``jax.value_and_grad``)
extract: backbone -> GeM -> whiten (Linear) -> L2, with the whole head in
the hand-written kernel of ``ops/gem_head.py`` on CUDA.  ``extract`` reads
the whiten weight in fp32 (equal to the JAX ``extract`` at the golden
bars); ``extract_fused`` reads it in bf16, as the Pallas kernel's default.
The ArcFace classifier weight is a parameter; extraction does not use it.

``dtype`` is the backbone's compute dtype (the JAX field): at bf16 the
layer4 map is bf16, GeM pools it in fp32, and the whiten projection, the
classifier and the losses stay fp32 (the JAX model's ``whiten`` Dense is
fp32 whatever ``dtype``).  ``dilation_block5`` and ``stem_s2d`` are the
backbone's (``models/backbone.py``).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from research_image_retrieval_tpu_torch.models.backbone import (
    ResNet,
    compute_dtype,
    stage_extents,
    train_mode,
)
from research_image_retrieval_tpu_torch.models.registry import register_model
from research_image_retrieval_tpu_torch.ops.gem_head import gem_whiten_l2
from research_image_retrieval_tpu_torch.ops.losses import (
    arcface_logits,
    cross_entropy,
)
from research_image_retrieval_tpu_torch.ops.pooling import gem_pool

__all__ = ["GeMModel"]


class GeMModel(nn.Module):
    """ResNet-GeM with a whiten projection and an ArcFace head."""

    def __init__(self, backbone_name: str = "resnet50", outputdim: int = 2048,
                 num_classes: int = 81313, p: float = 3.0,
                 learnable_p: bool = False, s: float = 32.0, m: float = 0.15,
                 dilation_block5: bool = False, stem_s2d: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.dilation_block5 = dilation_block5
        self.backbone = ResNet(backbone_name, dilation_block5=dilation_block5,
                               stem_s2d=stem_s2d, dtype=self.dtype)
        self.whiten = nn.Linear(self.backbone.outputdim, outputdim)
        self.p = p
        self.gem_p = nn.Parameter(torch.tensor([p])) if learnable_p else None
        self.s, self.m = s, m
        self.classifier_w = nn.Parameter(torch.empty(num_classes, outputdim))
        nn.init.xavier_uniform_(self.classifier_w)

    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                train: bool | None = None):
        """Train forward ``(loss, logits)`` of [B, H, W, 3] normalized
        images.  ``train`` (default: the module's mode, which it must
        match) adds the angular margin; eval logits are the scaled cosine
        (m = 0), so argmax accuracy is not penalized on the target."""
        train = train_mode(self, train)
        fmap = self.backbone(x)
        pooled = gem_pool(fmap, p=self.p if self.gem_p is None else self.gem_p)
        logits = arcface_logits(self.whiten(pooled), self.classifier_w,
                                labels, s=self.s, m=self.m if train else 0.0)
        return cross_entropy(logits, labels), logits

    def _head(self, x, valid_hw, weight_dtype):
        train_mode(self, False)  # extraction reads BN's running stats
        fmap = self.backbone(x, valid_hw=valid_hw).contiguous()
        ext = (None if valid_hw is None
               else stage_extents(valid_hw, 5, self.dilation_block5))
        p = self.p if self.gem_p is None else self.gem_p
        return gem_whiten_l2(fmap, self.whiten.weight, self.whiten.bias, p=p,
                             extents=ext, weight_dtype=weight_dtype)

    def extract(self, x: torch.Tensor,
                valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """[B, H, W, 3] images (+ optional [B, 2] valid extents of padded
        buckets) -> [B, D] L2-normalized fp32 descriptors (the backbone in
        ``dtype``, the head in fp32 with an fp32 whiten weight)."""
        return self._head(x, valid_hw, torch.float32)

    def extract_fused(self, x: torch.Tensor,
                      valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """As ``extract`` with the whiten weight read in bf16 (the Pallas
        kernel's default; within 5e-3 of ``extract``)."""
        return self._head(x, valid_hw, torch.bfloat16)


register_model(
    "gem_r50",
    description="ResNet50-GeM global descriptor with ArcFace (reference "
                "RetrievalNet.py:327)",
    defaults=dict(backbone_name="resnet50", outputdim=2048, p=3.0, s=32.0,
                  m=0.15),
    family="gem",
    paper="Radenovic et al., Fine-tuning CNN Image Retrieval with No Human "
          "Annotation (TPAMI 2018)",
    table1_names=("R50-GeM",),
)(GeMModel)

register_model(
    "gem_r101",
    description="ResNet101-GeM global descriptor with ArcFace",
    defaults=dict(backbone_name="resnet101", outputdim=2048, p=3.0, s=32.0,
                  m=0.15),
    family="gem",
    table1_names=("R101-GeM",),
)(GeMModel)
