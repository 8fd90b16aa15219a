"""SENet-G2+: an SE-ResNet trained from scratch with G2+ pooling
(port of ``research_image_retrieval_tpu/models/senet_g2.py``).

An SE-bottleneck ResNet (a squeeze-and-excitation gate on conv3's
output, before the residual add), G2+ pooling (GeM with a learnable
power ``gem_p``, then the learnable affine ``g2_alpha * x + g2_beta``),
``feature_proj``; training is cross entropy over a Linear classifier.
Its modules sit at the top level under the JAX names (``conv1``,
``bn1``, ``layer{i}_{j}``, no ``backbone``), so the state dict is the
converter's output of the flax tree as it is.

Neither hand-written kernel runs here: the SE gate sits inside the
residual branch, between bn3 and the add, so a block is not the fused
bottleneck's function; and G2+'s affine sits between the pool and the
projection, so the head is not the GeM head's function.

The JAX model has a ``dtype`` field that it never uses (every layer is
fp32); ``dtype`` is accepted here for the same signature and the model
computes in fp32 whatever it says.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from research_image_retrieval_tpu_torch.models.backbone import (
    BatchNorm,
    Conv2d,
    train_mode,
)
from research_image_retrieval_tpu_torch.models.registry import register_model
from research_image_retrieval_tpu_torch.ops.losses import cross_entropy
from research_image_retrieval_tpu_torch.ops.masking import ceil_half, hw_mask
from research_image_retrieval_tpu_torch.ops.norm import l2_normalize
from research_image_retrieval_tpu_torch.ops.pooling import (
    avg_pool_all,
    gem_pool,
)
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["SEBlock", "SEBottleneck", "SENetG2Model"]


def _remask(y: torch.Tensor, extents: torch.Tensor | None) -> torch.Tensor:
    """Zero the padded region of an NCHW tensor."""
    if extents is None:
        return y
    return y * hw_mask(y.shape[2], y.shape[3], extents, dtype=y.dtype)[:, None]


class SEBlock(nn.Module):
    """Squeeze-and-excitation gate of an NCHW map; the squeeze mean runs
    over the valid cells of ``mask`` [B, H, W] when given."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc1 = nn.Linear(channels, channels // reduction, bias=False)
        self.fc2 = nn.Linear(channels // reduction, channels, bias=False)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        y = avg_pool_all(x.permute(0, 2, 3, 1), valid_hw=mask)  # [B, C]
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(y))))
        return x * y[:, :, None, None]


class SEBottleneck(nn.Module):
    """SE bottleneck, stride on the 3x3; a projection skip
    (``down_conv`` / ``down_bn``) when the shape changes."""

    def __init__(self, in_ch: int, width: int, stride: int = 1,
                 reduction: int = 16):
        super().__init__()
        out_ch = 4 * width
        self.stride = stride
        self.conv1 = Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = BatchNorm(width)
        self.conv2 = Conv2d(width, width, 3, stride=stride, padding=1,
                            bias=False)
        self.bn2 = BatchNorm(width)
        self.conv3 = Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = BatchNorm(out_ch)
        self.se = SEBlock(out_ch, reduction)
        self.down = in_ch != out_ch or stride != 1
        if self.down:
            self.down_conv = Conv2d(in_ch, out_ch, 1, stride=stride,
                                    bias=False)
            self.down_bn = BatchNorm(out_ch)

    def forward(self, x: torch.Tensor, extents=None) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        # BN's bias leaks into the pad: re-zero before the only spatial
        # conv so its boundary reads are exact zero padding
        y = F.relu(self.bn2(self.conv2(_remask(y, extents))))
        out_ext = (ceil_half(extents)
                   if extents is not None and self.stride == 2 else extents)
        y = self.bn3(self.conv3(y))
        se_mask = (None if out_ext is None
                   else hw_mask(y.shape[2], y.shape[3], out_ext))
        y = self.se(y, mask=se_mask)
        idt = self.down_bn(self.down_conv(x)) if self.down else x
        return F.relu(y + idt)


class SENetG2Model(nn.Module):
    """SE-ResNet + G2+ pooling + projection."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 outputdim: int = 2048, num_classes: int = 81313,
                 reduction: int = 16, gem_p: float = 3.0,
                 dtype=torch.float32):
        super().__init__()
        del dtype  # unused by the JAX model too: every layer is fp32
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        self.block_names = []
        in_ch = 64
        for i, (d, w) in enumerate(zip(layers, (64, 128, 256, 512))):
            for j in range(d):
                name = f"layer{i + 1}_{j}"
                self.add_module(name, SEBottleneck(
                    in_ch, w, stride=2 if (j == 0 and i > 0) else 1,
                    reduction=reduction))
                self.block_names.append(name)
                in_ch = 4 * w
        self.gem_p = nn.Parameter(torch.tensor([gem_p], dtype=torch.float32))
        self.g2_alpha = nn.Parameter(torch.ones(1))
        self.g2_beta = nn.Parameter(torch.zeros(1))
        self.feature_proj = nn.Linear(in_ch, outputdim)
        self.classifier = nn.Linear(outputdim, num_classes)
        self.to(memory_format=torch.channels_last)

    @torch.no_grad()
    def reset_flax(self, generator: torch.Generator | None):
        """The JAX initializers of G2+: ``g2_alpha`` 1, ``g2_beta`` 0
        (``gem_p`` keeps its value)."""
        self.g2_alpha.fill_(1.0)
        self.g2_beta.fill_(0.0)

    def stem(self, x: torch.Tensor, ext=None) -> torch.Tensor:
        """conv1 -> BN -> ReLU (-> mask) -> 3x3/2 max pool of an NCHW
        batch."""
        y = F.relu(self.bn1(self.conv1(x)))
        if ext is not None:
            # post-ReLU values are >= 0: zeroed padding never wins the max
            y = _remask(y, ceil_half(ext))
        return F.max_pool2d(y, 3, stride=2, padding=1)

    def _features(self, x, valid_hw=None):
        if valid_hw is not None and self.training:
            raise ValueError("masked extraction requires eval mode")
        ext = None if valid_hw is None else valid_hw.to(torch.int32)
        y = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        y = self.stem(_remask(y, ext), ext)
        if ext is not None:
            ext = ceil_half(ceil_half(ext))
        for name in self.block_names:
            block = getattr(self, name)
            y = block(y, extents=ext)
            if ext is not None and block.stride == 2:
                ext = ceil_half(ext)
        fmap = y.permute(0, 2, 3, 1)
        mask = (None if ext is None
                else hw_mask(fmap.shape[1], fmap.shape[2], ext))
        pooled = (self.g2_alpha * gem_pool(fmap, p=self.gem_p, valid_hw=mask)
                  + self.g2_beta)
        return self.feature_proj(pooled)

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
        """[B, H, W, 3] images (+ [B, 2] bucket extents) -> [B, D]
        L2-normalized fp32 descriptors."""
        train_mode(self, False)
        return l2_normalize(self._features(x, valid_hw))


register_model(
    "senet_g2_r50",
    description="SE-ResNet50 with G2+ learnable-affine GeM pooling "
                "(reference models/senet_g2.py:156)",
    defaults=dict(layers=(3, 4, 6, 3)),
    family="senet_g2",
    table1_names=("SENet-G2+",),
)(SENetG2Model)
