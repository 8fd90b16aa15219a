"""SpoC: spatial-pyramid pooling with contextual attention
(port of ``research_image_retrieval_tpu/models/spoc.py``).

A context encoder (two 3x3 conv + BN + ReLU, a sigmoid attention, the
attended map and the context concatenated and mixed by a 1x1
``refine_conv``), a max-pool pyramid over levels (1, 2, 4), a per-region
Linear (``agg_proj``, the reference's Conv1d) + token BN + ReLU, the max
over regions, then ``proj_fc1`` -> ReLU -> dropout -> ``proj_fc2``;
training is cross entropy over a Linear classifier.

On padded buckets the pyramid is computed per image
(``masked_spatial_pyramid_pool``): the regions the exact-shape run would
make, and only those, take part in the region max.  Maps must be at
least ``max(levels)`` on each side for that to be region-exact.

The backbone runs in ``dtype`` (its identity blocks on the bottleneck
kernel in eval mode); the head runs in fp32, as flax promotes a bf16 map
against its fp32 parameters.  No GeM head here, so the head kernel does
not run.  Dropout draws from the ``generator`` the train step passes.
"""

from __future__ import annotations

from typing import Sequence

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
    TokenBatchNorm,
    dropout,
)
from research_image_retrieval_tpu_torch.models.registry import register_model
from research_image_retrieval_tpu_torch.ops.losses import cross_entropy
from research_image_retrieval_tpu_torch.ops.masking import hw_mask
from research_image_retrieval_tpu_torch.ops.norm import (
    at_least_fp32,
    l2_normalize,
)
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["SpoCModel", "masked_spatial_pyramid_pool", "spatial_pyramid_pool"]


def spatial_pyramid_pool(x: torch.Tensor,
                         levels: Sequence[int] = (1, 2, 4)) -> torch.Tensor:
    """[B, H, W, C] -> [B, regions, C]: per level a VALID max pool with
    kernel = stride = ``max(dim // level, 1)``, regions row-major."""
    B, H, W, C = x.shape
    xc = x.permute(0, 3, 1, 2)
    outs = []
    for level in levels:
        k = (max(H // level, 1), max(W // level, 1))
        pooled = F.max_pool2d(xc, k, stride=k)
        outs.append(pooled.permute(0, 2, 3, 1).reshape(B, -1, C))
    return torch.cat(outs, dim=1)


def masked_spatial_pyramid_pool(x: torch.Tensor, extents: torch.Tensor,
                                levels: Sequence[int] = (1, 2, 4)):
    """Per-image pyramid over a padded bucket: the regions of
    ``spatial_pyramid_pool`` on each image's valid ``[B, 2]`` extent
    (up to ``2 * level - 1`` per side; remainder cells belong to none).

    Returns ``(pyr [B, sum((2 level - 1)^2), C], participate [B, ...]
    bool)``: a region that does not exist keeps ``-inf`` (as JAX's
    segment max of no member) and is False in ``participate``."""
    B, H, W, C = x.shape
    flat_x = at_least_fp32(x).reshape(B, H * W, C)
    dev = x.device
    h_t, w_t = extents[:, 0].long(), extents[:, 1].long()
    rows = torch.arange(H, device=dev)[None, :]
    cols = torch.arange(W, device=dev)[None, :]
    pyr, parts = [], []
    for level in levels:
        side = 2 * level - 1  # most regions per side at this level
        nseg = side * side
        kh = torch.clamp(h_t // level, min=1)[:, None]  # [B, 1]
        kw = torch.clamp(w_t // level, min=1)[:, None]
        nr = torch.clamp(h_t[:, None] // kh, max=side)  # real row regions
        nc = torch.clamp(w_t[:, None] // kw, max=side)
        ri, ci = rows // kh, cols // kw  # [B, H], [B, W]
        r_ok = (ri < nr) & (rows < h_t[:, None])
        c_ok = (ci < nc) & (cols < w_t[:, None])
        seg = ri[:, :, None] * side + ci[:, None, :]
        seg = torch.where(r_ok[:, :, None] & c_ok[:, None, :], seg, nseg)
        index = seg.reshape(B, H * W, 1).expand(B, H * W, C)
        out = torch.full((B, nseg + 1, C), float("-inf"),
                         dtype=flat_x.dtype, device=dev)
        out = out.scatter_reduce(1, index, flat_x, "amax", include_self=False)
        pyr.append(out[:, :nseg])  # the last slot is the trash segment
        grid = torch.arange(side, device=dev)
        part = ((grid[None, :, None] < nr[:, :, None])
                & (grid[None, None, :] < nc[:, :, None]))
        parts.append(part.reshape(B, nseg))
    return torch.cat(pyr, dim=1), torch.cat(parts, dim=1)


class SpoCModel(nn.Module):
    """Backbone -> context -> pyramid -> region aggregation -> MLP."""

    takes_generator = True  # the train step passes its dropout generator

    def __init__(self, backbone_name: str = "resnet50", outputdim: int = 2048,
                 context_dim: int = 512, pyramid_levels: tuple = (1, 2, 4),
                 use_context: bool = True, num_classes: int = 81313,
                 dropout: float = 0.5, dtype=torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.backbone = ResNet(backbone_name, dtype=self.dtype)
        C = self.backbone.outputdim
        self.pyramid_levels = tuple(pyramid_levels)
        self.use_context = use_context
        self.dropout = dropout
        self.ctx_conv1 = nn.Conv2d(C, context_dim, 3, padding=1)
        self.ctx_bn1 = BatchNorm(context_dim)
        self.ctx_conv2 = nn.Conv2d(context_dim, context_dim, 3, padding=1)
        self.ctx_bn2 = BatchNorm(context_dim)
        self.ctx_attn = nn.Conv2d(context_dim, 1, 1)
        self.refine_conv = nn.Conv2d(C + context_dim, C, 1)
        self.agg_proj = nn.Linear(C, outputdim)
        self.agg_bn = TokenBatchNorm(outputdim)
        self.proj_fc1 = nn.Linear(outputdim, outputdim)
        self.proj_fc2 = nn.Linear(outputdim, outputdim)
        self.classifier = nn.Linear(outputdim, num_classes)

    def _context(self, fmap: torch.Tensor, mask=None) -> torch.Tensor:
        """NHWC in and out; the convolutions run NCHW views."""
        x = fmap.permute(0, 3, 1, 2)
        # re-zero the pad before each 3x3 so its boundary reads match the
        # exact-shape run's zero padding
        remask = (lambda y: y) if mask is None else (lambda y: y * mask[:, None])
        ctx = F.relu(self.ctx_bn1(self.ctx_conv1(remask(x))))
        ctx = F.relu(self.ctx_bn2(self.ctx_conv2(remask(ctx))))
        att = torch.sigmoid(self.ctx_attn(ctx))
        refined = self.refine_conv(torch.cat([x * att, ctx], dim=1))
        return refined.permute(0, 2, 3, 1)

    def _features(self, x, valid_hw=None, generator=None):
        fmap = at_least_fp32(self.backbone(x, valid_hw=valid_hw))
        mask = ext = None
        if valid_hw is not None:
            ext = stage_extents(valid_hw, 5)
            mask = hw_mask(fmap.shape[1], fmap.shape[2], ext)
        if self.use_context:
            fmap = self._context(fmap, mask=mask)
        part = None
        if ext is None:
            pyr = spatial_pyramid_pool(fmap, self.pyramid_levels)
        else:
            pyr, part = masked_spatial_pyramid_pool(fmap, ext,
                                                    self.pyramid_levels)
            # regions that do not exist hold -inf: zero them so the Linear
            # and BN stay finite (the region max leaves them out)
            pyr = torch.where(part[..., None], pyr, 0.0)
        agg = F.relu(self.agg_bn(self.agg_proj(pyr)))  # [B, R, outputdim]
        if part is not None:
            agg = torch.where(part[..., None], agg, float("-inf"))
        feat = agg.amax(dim=1)  # adaptive max pool over regions
        h = dropout(F.relu(self.proj_fc1(feat)), self.dropout, self.training,
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
    "spoc_r50",
    description="SpoC spatial pyramid + contextual attention (reference "
                "models/spoc.py:97)",
    defaults=dict(backbone_name="resnet50"),
    family="spoc",
    table1_names=("R50-SpoC",),
)(SpoCModel)
