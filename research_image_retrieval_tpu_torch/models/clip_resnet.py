"""CLIP's ModifiedResNet visual tower with attention pooling
(port of ``research_image_retrieval_tpu/models/clip_resnet.py``).

* A three-convolution stem (3x3/2, 3x3, 3x3; BN + ReLU each) and a 2x2
  average pool in place of torchvision's 7x7 + max pool.
* Anti-aliased striding: a stride-2 bottleneck runs its convolutions at
  stride 1 and average-pools after the 3x3 (and before the projection's
  1x1).  The stride-1 identity blocks are the port's ``BottleneckBlock``
  and run the fused bottleneck kernel (``ops/resblock.py``) in eval
  mode, with per-image extents in padded buckets.
* ``AttentionPool2d``: the mean token (prepended) is the one query over
  the HW tokens plus a learned position embedding; separate q / k / v
  projections, multi-head, then ``c_proj`` to ``output_dim``.

Module and parameter names follow OpenAI's CLIP checkpoints
(``conv1``..``conv3``, ``layer{i}.{j}``, ``downsample.0`` / ``.1``,
``attnpool.{q,k,v,c}_proj``), so a ``visual.*`` state dict of that layout
loads as it is (``models/clip_convert.py``).

Masked buckets (``valid_hw`` [B, 2] input-pixel extents, eval mode): the
input is masked, the strided stem convolution ceil-halves the extents,
each 3x3 reads a re-zeroed input, every average pool floor-halves them
(``floor_half``: its windows read only cells below twice the floor
half), and the attention pool averages and attends over the valid cells
only, with its position embedding resized per image to each valid grid.

``dtype`` is the backbone's compute dtype with flax's semantics, as in
``models/backbone.py`` (at bf16 the identity blocks run the kernel's
bf16 form); the attention pool takes its input to fp32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from research_image_retrieval_tpu_torch.models.backbone import (
    BatchNorm,
    BottleneckBlock,
    Conv2d,
    _apply_mask,
    compute_dtype,
)
from research_image_retrieval_tpu_torch.models.vit import (
    per_image_grid,
    resize_grid,
)
from research_image_retrieval_tpu_torch.ops.masking import (
    ceil_half,
    floor_half,
    mask_attn_logits,
    token_mask,
)
from research_image_retrieval_tpu_torch.ops.norm import at_least_fp32
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["AttentionPool2d", "CLIPBottleneck", "CLIP_RESNET_CONFIGS",
           "ModifiedResNet"]

CLIP_RESNET_CONFIGS = {
    "r50": dict(layers=(3, 4, 6, 3), width=64),
    "r101": dict(layers=(3, 4, 23, 3), width=64),
    # tiny config for tests
    "rtest": dict(layers=(1, 1, 1, 1), width=8),
}


class CLIPBottleneck(BottleneckBlock):
    """Anti-aliased bottleneck: ``BottleneckBlock`` with its convolutions
    at stride 1; ``stride`` > 1 average-pools after the 3x3 and in front
    of the projection.  A stride-1 block whose input already has
    ``4 * planes`` channels is an identity block: the fused kernel in
    eval mode, the module path otherwise, both ``BottleneckBlock``'s."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__(in_ch, planes, 4 * planes, stride=1)
        self.stride = stride
        if stride > 1 and self.downsample is None:
            self.downsample = nn.Sequential(
                Conv2d(in_ch, 4 * planes, 1, bias=False),
                BatchNorm(4 * planes))
            self.fusable = False

    def forward(self, x: torch.Tensor, extents: torch.Tensor | None = None):
        if self.stride == 1:
            return super().forward(x, extents)
        y = F.relu(self.bn1(self.conv1(x)))
        y = _apply_mask(y, extents)
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(F.avg_pool2d(y, self.stride)))
        identity = self.downsample(F.avg_pool2d(x, self.stride))
        return F.relu(y + identity)


class AttentionPool2d(nn.Module):
    """Single-query attention pool over an NHWC map; fp32."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int):
        super().__init__()
        self.spacial_dim, self.embed_dim = spacial_dim, embed_dim
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.zeros(spacial_dim ** 2 + 1, embed_dim))
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)

    def reset_flax(self, generator: torch.Generator):
        """flax's ``normal(embed_dim ** -0.5)`` for the position embedding
        (``training_init``)."""
        with torch.no_grad():
            p = self.positional_embedding
            p.copy_(self.embed_dim ** -0.5
                    * torch.randn(p.shape, generator=generator))

    @fp32_precision()
    def forward(self, x: torch.Tensor,
                grid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """[B, H, W, C] map (+ [B, 2] valid grid extents) -> [B,
        output_dim]."""
        B, H, W, C = x.shape
        tokens = at_least_fp32(x).reshape(B, H * W, C)
        S = self.spacial_dim
        pos = self.positional_embedding.to(tokens.dtype)
        grid = pos[1:].reshape(S, S, C)
        kmask = None
        if grid_hw is None:
            mean = tokens.mean(dim=1, keepdim=True)
            pgrid = grid if (H, W) == (S, S) else resize_grid(grid, H, W)
            pos_b = torch.cat([pos[:1], pgrid.reshape(H * W, C)])[None]
        else:
            tmask = token_mask(H, W, grid_hw, dtype=tokens.dtype)
            cnt = torch.clamp(tmask.sum(dim=1, keepdim=True), min=1.0)
            mean = ((tokens * tmask[..., None]).sum(dim=1, keepdim=True)
                    / cnt[..., None])
            pimg = per_image_grid(grid, H, W, grid_hw).to(tokens.dtype)
            pos_b = torch.cat([pos[:1].expand(B, 1, C),
                               pimg.reshape(B, H * W, C)], dim=1)
            kmask = torch.cat([torch.ones_like(tmask[:, :1]), tmask], dim=1)
        tokens = torch.cat([mean, tokens], dim=1) + pos_b
        h = self.num_heads
        hd = C // h
        q = self.q_proj(tokens[:, :1]).reshape(B, 1, h, hd).transpose(1, 2)
        k = self.k_proj(tokens).reshape(B, -1, h, hd).transpose(1, 2)
        v = self.v_proj(tokens).reshape(B, -1, h, hd).transpose(1, 2)
        attn = torch.matmul(q, k.transpose(-1, -2)) * (hd ** -0.5)
        if kmask is not None:
            attn = mask_attn_logits(attn, kmask)
        out = torch.matmul(torch.softmax(attn, dim=-1), v)
        return self.c_proj(out.transpose(1, 2).reshape(B, C))


class ModifiedResNet(nn.Module):
    """CLIP's anti-aliased ResNet with attention pooling; NHWC images in,
    ``[B, output_dim]`` fp32 out."""

    def __init__(self, layers=(3, 4, 6, 3), width: int = 64,
                 output_dim: int = 1024, heads: int | None = None,
                 input_resolution: int = 224, dtype=torch.float32):
        super().__init__()
        self.layers, self.width = tuple(layers), width
        self.dtype = compute_dtype(dtype)
        half = width // 2
        self.conv1 = Conv2d(3, half, 3, stride=2, padding=1, bias=False)
        self.bn1 = BatchNorm(half)
        self.conv2 = Conv2d(half, half, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(half)
        self.conv3 = Conv2d(half, width, 3, padding=1, bias=False)
        self.bn3 = BatchNorm(width)
        in_ch = width
        for i, depth in enumerate(self.layers):
            planes = width * 2 ** i
            blocks = []
            for j in range(depth):
                blocks.append(CLIPBottleneck(in_ch, planes,
                                             2 if (j == 0 and i > 0) else 1))
                in_ch = 4 * planes
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        embed_dim = width * 32
        self.attnpool = AttentionPool2d(
            input_resolution // 32, embed_dim,
            heads if heads is not None else embed_dim // 64, output_dim)
        self.to(memory_format=torch.channels_last)

    @fp32_precision()
    def forward(self, x: torch.Tensor,
                valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """x: [B, H, W, 3] (zero-padded bottom/right when ``valid_hw``
        [B, 2] is given; eval mode only)."""
        if valid_hw is not None and self.training:
            raise ValueError("masked extraction requires eval mode")
        ext = valid_hw
        y = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        y = _apply_mask(y, ext)
        if self.dtype == torch.bfloat16:
            y = y.to(self.dtype)
        y = F.relu(self.bn1(self.conv1(y)))
        if ext is not None:
            ext = ceil_half(ext)
        y = F.relu(self.bn2(self.conv2(_apply_mask(y, ext))))
        y = F.relu(self.bn3(self.conv3(_apply_mask(y, ext))))
        y = F.avg_pool2d(y, 2)
        if ext is not None:
            ext = floor_half(ext)
        for i in range(len(self.layers)):
            for block in getattr(self, f"layer{i + 1}"):
                y = block(y, extents=ext)
                if ext is not None and block.stride == 2:
                    ext = floor_half(ext)
        return self.attnpool(y.permute(0, 2, 3, 1), grid_hw=ext)
