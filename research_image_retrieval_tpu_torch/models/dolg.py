"""DOLG: orthogonal fusion of local and global features
(port of ``research_image_retrieval_tpu/models/dolg.py``).

Global: GeM (p = 3) of layer4 -> ``fc_t`` (to 1024).  Local: layer3 ->
``SpatialAttention2d`` (optional ASPP, 1x1, BN, each cell's vector
L2-normalized, times a softplus attention).  Fusion: each local vector
minus its projection on the global one, the masked mean of that, then
``fc`` of ``[global, fused]``; train logits are ArcFace (s 30, m 0.15).

The backbone returns both taps (``out_stages=(4, 5)``) in ``dtype`` (its
identity blocks on the bottleneck kernel in eval mode); the head runs in
fp32, as flax promotes a bf16 map against its fp32 parameters.  The
GeM of layer4 feeds ``fc_t`` and the fusion, not an L2, so it is not the
GeM head kernel's function and runs as plain PyTorch.
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
from research_image_retrieval_tpu_torch.models.registry import register_model
from research_image_retrieval_tpu_torch.ops.losses import (
    arcface_logits,
    cross_entropy,
)
from research_image_retrieval_tpu_torch.ops.masking import hw_mask
from research_image_retrieval_tpu_torch.ops.norm import (
    at_least_fp32,
    l2_normalize,
)
from research_image_retrieval_tpu_torch.ops.pooling import (
    avg_pool_all,
    gem_pool,
)
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["ASPP", "DOLGModel", "SpatialAttention2d"]


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling on an NCHW map: an image-pool branch
    (the masked mean of the valid cells), a 1x1 and 3x3s at dilations
    6 / 12 / 18, concatenated and mixed by a 1x1."""

    def __init__(self, in_c: int, mid_c: int = 512, out_c: int = 1024):
        super().__init__()
        self.im_pool_conv = nn.Conv2d(in_c, mid_c, 1)
        self.aspp0 = nn.Conv2d(in_c, mid_c, 1)
        self.aspp1 = nn.Conv2d(in_c, mid_c, 3, padding=6, dilation=6)
        self.aspp2 = nn.Conv2d(in_c, mid_c, 3, padding=12, dilation=12)
        self.aspp3 = nn.Conv2d(in_c, mid_c, 3, padding=18, dilation=18)
        self.conv_after = nn.Conv2d(5 * mid_c, out_c, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        B, _, H, W = x.shape
        pooled = avg_pool_all(x.permute(0, 2, 3, 1), valid_hw=mask)
        pooled = F.relu(self.im_pool_conv(pooled[:, :, None, None]))
        if mask is not None:
            # zero the pad so each dilated 3x3 reads the exact-shape run's
            # zero padding
            x = x * mask[:, None]
        branches = [pooled.expand(-1, -1, H, W), self.aspp0(x),
                    self.aspp1(x), self.aspp2(x), self.aspp3(x)]
        return F.relu(self.conv_after(torch.cat(branches, dim=1)))


class SpatialAttention2d(nn.Module):
    """(L2-normalized map x softplus attention, attention) of an NCHW map."""

    def __init__(self, in_c: int, out_c: int = 1024, with_aspp: bool = False):
        super().__init__()
        self.aspp = ASPP(in_c) if with_aspp else None
        self.conv1 = nn.Conv2d(1024 if with_aspp else in_c, out_c, 1)
        self.bn = BatchNorm(out_c)
        self.conv2 = nn.Conv2d(out_c, 1, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        if self.aspp is not None:
            x = self.aspp(x, mask=mask)
        x = self.bn(self.conv1(x))
        att = self.conv2(F.relu(x))
        att = torch.logaddexp(att, torch.zeros_like(att))  # softplus
        return l2_normalize(x, dim=1) * att, att


class DOLGModel(nn.Module):
    """DOLG with the orthogonal fusion and an ArcFace head."""

    def __init__(self, backbone_name: str = "resnet101", outputdim: int = 512,
                 num_classes: int = 81313, with_aspp: bool = False,
                 s: float = 30.0, m: float = 0.15,
                 scratch_backbone: bool = False, dtype=torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        # scratch_backbone: the MSRA / pycls stride placement of the
        # reference's scratch backbone (``convert.load_pycls_resnet``)
        self.backbone = ResNet(backbone_name, dtype=self.dtype,
                               out_stages=(4, 5),
                               stride_on_conv1=scratch_backbone)
        self.local_attn = SpatialAttention2d(self.backbone.outputdim_block4,
                                             1024, with_aspp=with_aspp)
        self.fc_t = nn.Linear(self.backbone.outputdim, 1024)
        self.fc = nn.Linear(2048, outputdim)
        self.s, self.m = s, m
        self.classifier_w = nn.Parameter(torch.empty(num_classes, outputdim))
        nn.init.xavier_uniform_(self.classifier_w)

    def _descriptor(self, x, valid_hw=None):
        taps = self.backbone(x, valid_hw=valid_hw)
        f4, f5 = at_least_fp32(taps[4]), at_least_fp32(taps[5])
        mask4 = mask5 = None
        if valid_hw is not None:
            mask4 = hw_mask(f4.shape[1], f4.shape[2],
                            stage_extents(valid_hw, 4))
            mask5 = hw_mask(f5.shape[1], f5.shape[2],
                            stage_extents(valid_hw, 5))
        fl, _ = self.local_attn(f4.permute(0, 3, 1, 2), mask=mask4)
        fg = self.fc_t(gem_pool(f5, p=3.0, valid_hw=mask5))  # [B, 1024]
        fg_sq = (fg * fg).sum(dim=-1)
        # each local vector's projection on fg: (fl . fg) fg / ||fg||^2
        coef = torch.einsum("bchw,bc->bhw", fl, fg)
        proj = coef[:, None] * fg[:, :, None, None] / fg_sq[:, None, None,
                                                            None]
        fo = avg_pool_all((fl - proj).permute(0, 2, 3, 1), valid_hw=mask4)
        return self.fc(torch.cat([fg, fo], dim=-1))

    @fp32_precision()
    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                train: bool | None = None):
        """Train forward ``(loss, logits)``; eval logits carry no margin."""
        train = train_mode(self, train)
        logits = arcface_logits(self._descriptor(x), self.classifier_w,
                                labels, s=self.s, m=self.m if train else 0.0)
        return cross_entropy(logits, labels), logits

    @fp32_precision()
    def extract(self, x: torch.Tensor,
                valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """[B, H, W, 3] images (+ [B, 2] bucket extents) -> [B, outputdim]
        L2-normalized fp32 descriptors."""
        train_mode(self, False)
        return l2_normalize(self._descriptor(x, valid_hw))


register_model(
    "dolg_r101",
    description="DOLG orthogonal local/global fusion over ResNet101 "
                "(reference RetrievalNet.py:367)",
    defaults=dict(backbone_name="resnet101", outputdim=512),
    family="dolg",
    paper="Yang et al., DOLG (ICCV 2021)",
    table1_names=("R101-DOLG",),
)(DOLGModel)

register_model(
    "dolg_r50",
    description="DOLG over ResNet50",
    defaults=dict(backbone_name="resnet50", outputdim=512),
    family="dolg",
    table1_names=("R50-DOLG",),
)(DOLGModel)

register_model(
    "dolg_r101_scratch",
    description="DOLG over the reference's scratch pycls-style ResNet101 "
                "(MSRA stride placement; reference "
                "networks/backbone.py:218-346) — checkpoint-portable via "
                "convert_pycls_resnet",
    defaults=dict(backbone_name="resnet101", outputdim=512,
                  scratch_backbone=True),
    family="dolg",
)(DOLGModel)
