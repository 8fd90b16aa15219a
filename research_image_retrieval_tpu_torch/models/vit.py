"""Vision Transformer backbone and the ViT global-descriptor model
(port of ``research_image_retrieval_tpu/models/vit.py``).

``VisionTransformer``: a stride-``patch`` patch convolution (flax
``SAME`` padding, none when the input is a multiple of the patch), a
learned CLS token and position embedding (bilinearly resized, with
antialias, to a non-native patch grid), optional prompt tokens after the
patches, CLIP's ``ln_pre`` with ``quick_gelu``, pre-norm blocks (LN ->
multi-head attention -> LN -> MLP, exact GELU or CLIP's quick GELU),
``ln_post``.  It returns (CLS token, patch tokens).

Padded buckets (``valid_hw`` [B, 2] true extents, multiples of the patch
size: ``extract_vectors`` snaps them to ``extent_multiple``): the patch
tokens past each image's grid are removed from every key set, and the
position embedding is resized per image to its TRUE grid
(``dynamic_resize_weights``) and placed in the top-left of the canvas,
as the exact-shape run resizes it to its own grid.

``ViTGlobalModel``: descriptor ``whiten(concat(cls, GeM over the valid
patch tokens))`` then L2; ArcFace with the margin in training only.
The backbone computes in ``dtype`` (fp32 or bf16; the attention softmax
in fp32); the GeM, the whitening and the loss stay fp32.

Spans (``utils.profiling.span``, recorded while a profiler records):
``vit.embed`` (the patch convolution, the position grids, the token
assembly and CLIP's ``ln_pre``), ``vit.blocks`` (the blocks and
``ln_post``, with counts ``tokens`` = B x N, ``pairs`` = B x heads x
N^2 query-key pairs a block computes, and ``layers``; all from shapes),
and ``vit.head`` (``ViTGlobalModel``'s GeM, whitening and L2).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from research_image_retrieval_tpu_torch.models.backbone import (
    Conv2d,
    compute_dtype,
    same_conv,
    train_mode,
)
from research_image_retrieval_tpu_torch.models.layers import (
    Dense,
    LayerNorm,
    MultiHeadAttention,
)
from research_image_retrieval_tpu_torch.models.registry import register_model
from research_image_retrieval_tpu_torch.ops.losses import (
    arcface_logits,
    cross_entropy,
)
from research_image_retrieval_tpu_torch.ops.masking import (
    dynamic_resize_weights,
    token_mask,
)
from research_image_retrieval_tpu_torch.ops.norm import (
    at_least_fp32,
    l2_normalize,
)
from research_image_retrieval_tpu_torch.ops.resize import dense_resize_weights
from research_image_retrieval_tpu_torch.utils.device import fp32_precision
from research_image_retrieval_tpu_torch.utils.profiling import span

__all__ = ["VIT_CONFIGS", "ViTBlock", "ViTGlobalModel", "VisionTransformer",
           "per_image_grid", "resize_grid"]

VIT_CONFIGS = {
    "ti16": dict(dim=192, depth=12, heads=3, patch=16),
    "s16": dict(dim=384, depth=12, heads=6, patch=16),
    "b16": dict(dim=768, depth=12, heads=12, patch=16),
    "b32": dict(dim=768, depth=12, heads=12, patch=32),
    "l14": dict(dim=1024, depth=24, heads=16, patch=14),
    # tiny config for tests
    "test": dict(dim=32, depth=2, heads=2, patch=8),
}


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's GELU: ``x * sigmoid(1.702 x)``."""
    return x * torch.sigmoid(1.702 * x)


def resize_grid(grid: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[S, S', C] -> [h, w, C] bilinear resize with antialias
    (``jax.image.resize(..., "bilinear")``), in fp32 or the grid's
    float64 (weights too)."""
    dev = grid.device
    g = at_least_fp32(grid)

    def weights(n_out, n_in):
        one = lambda v: torch.full((1,), v, dtype=torch.int32, device=dev)
        return dense_resize_weights(one(n_in), one(n_out), n_in, n_out,
                                    dtype=g.dtype)[0]

    wh = weights(h, grid.shape[0])
    ww = weights(w, grid.shape[1])
    return torch.einsum("hp,pqc,wq->hwc", wh, g, ww)


def per_image_grid(grid: torch.Tensor, h: int, w: int,
                   extents: torch.Tensor) -> torch.Tensor:
    """[S, S', C] -> [B, h, w, C]: ``grid`` resized to each image's true
    ``extents`` ([B, 2] cells) in the top-left of an h x w canvas, zero
    elsewhere (``dynamic_resize_weights``)."""
    g = at_least_fp32(grid)
    wh = dynamic_resize_weights(h, grid.shape[0], extents[:, 0], g.dtype)
    ww = dynamic_resize_weights(w, grid.shape[1], extents[:, 1], g.dtype)
    return torch.einsum("bhp,pqc,bwq->bhwc", wh, g, ww)


class ViTBlock(nn.Module):
    """Pre-norm transformer block (LN -> MHA -> LN -> MLP, residual)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0,
                 quick_gelu: bool = False):
        super().__init__()
        self.quick_gelu = quick_gelu
        self.ln1 = LayerNorm(dim)
        self.attn = MultiHeadAttention(dim, heads)
        self.ln2 = LayerNorm(dim)
        self.mlp_fc1 = Dense(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = Dense(int(dim * mlp_ratio), dim)

    @fp32_precision()
    def forward(self, x: torch.Tensor, token_mask: torch.Tensor | None = None,
                causal: bool = False) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), key_mask=token_mask, causal=causal)
        h = self.mlp_fc1(self.ln2(x))
        h = quick_gelu(h) if self.quick_gelu else F.gelu(h, approximate="none")
        return x + self.mlp_fc2(h)


class VisionTransformer(nn.Module):
    """ViT backbone returning ``(cls [B, dim], patch tokens [B, gh*gw,
    dim])`` in ``dtype``; ``num_prompt_tokens`` learned tokens follow the
    patches (CLIP's prompt option)."""

    def __init__(self, dim: int = 384, depth: int = 12, heads: int = 6,
                 patch: int = 16, img_size: int = 224,
                 num_prompt_tokens: int = 0, quick_gelu: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.dim, self.depth, self.patch = dim, depth, patch
        self.heads = heads
        self.img_size, self.quick_gelu = img_size, quick_gelu
        self.num_prompt_tokens = num_prompt_tokens
        self.dtype = compute_dtype(dtype)
        self.patch_embed = Conv2d(3, dim, patch, stride=patch, bias=False)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        native = img_size // patch
        self.pos_embed = nn.Parameter(torch.zeros(1, native ** 2 + 1, dim))
        if num_prompt_tokens:
            self.prompt_tokens = nn.Parameter(
                torch.zeros(1, num_prompt_tokens, dim))
        if quick_gelu:  # CLIP
            self.ln_pre = LayerNorm(dim)
        for i in range(depth):
            self.add_module(f"block{i}",
                            ViTBlock(dim, heads, quick_gelu=quick_gelu))
        self.ln_post = LayerNorm(dim)

    def reset_flax(self, generator: torch.Generator):
        """flax's ``normal(0.02)`` for the CLS token, the position
        embedding and the prompt tokens (``training_init``)."""
        with torch.no_grad():
            for p in (self.cls_token, self.pos_embed,
                      getattr(self, "prompt_tokens", None)):
                if p is not None:
                    p.copy_(0.02 * torch.randn(p.shape, generator=generator))

    def _embed(self, x: torch.Tensor, valid_hw: torch.Tensor | None):
        """The tokens ``[B, 1 + gh*gw (+ prompts), dim]``, their key mask
        (None without ``valid_hw``) and the patch grid (gh, gw)."""
        B = x.shape[0]
        y = x.to(self.dtype) if self.dtype == torch.bfloat16 else x
        y = same_conv(self.patch_embed, y)
        gh, gw = y.shape[1], y.shape[2]
        y = y.reshape(B, gh * gw, self.dim)
        native = self.img_size // self.patch
        grid = self.pos_embed[0, 1:].reshape(native, native, self.dim)
        pmask = None
        if valid_hw is not None:
            ext = torch.div(valid_hw, self.patch, rounding_mode="floor")
            pmask = token_mask(gh, gw, ext)
            pos = per_image_grid(grid, gh, gw, ext).reshape(B, gh * gw, -1)
        elif (gh, gw) != (native, native):
            pos = resize_grid(grid, gh, gw).reshape(1, gh * gw, -1)
        else:
            pos = grid.reshape(1, gh * gw, -1)
        y = y + pos.to(y.dtype)
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(B, 1, -1)
        tokens = [cls.to(y.dtype), y]
        if self.num_prompt_tokens:
            tokens.append(self.prompt_tokens.expand(B, -1, -1).to(y.dtype))
        y = torch.cat(tokens, dim=1)
        tmask = None
        if pmask is not None:
            ones = torch.ones(B, 1, dtype=pmask.dtype, device=pmask.device)
            parts = [ones, pmask]  # the CLS token is always valid
            if self.num_prompt_tokens:
                parts.append(ones.expand(B, self.num_prompt_tokens))
            tmask = torch.cat(parts, dim=1)
        if self.quick_gelu:
            y = self.ln_pre(y)
        return y, tmask, gh, gw

    @fp32_precision()
    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor | None = None):
        """x: [B, H, W, 3] (zero-padded bottom/right when ``valid_hw``
        [B, 2] is given; the extents must be multiples of ``patch``)."""
        B = x.shape[0]
        with span("vit.embed"):
            y, tmask, gh, gw = self._embed(x, valid_hw)
        with span("vit.blocks", tokens=B * y.shape[1],
                  pairs=B * self.heads * y.shape[1] ** 2, layers=self.depth):
            for i in range(self.depth):
                y = getattr(self, f"block{i}")(y, token_mask=tmask)
            y = self.ln_post(y)
        return y[:, 0], y[:, 1:1 + gh * gw]


class ViTGlobalModel(nn.Module):
    """ViT + GeM-token descriptor + ArcFace (BASELINE config 3)."""

    def __init__(self, variant: str = "s16", outputdim: int = 512,
                 num_classes: int = 81313, p: float = 3.0, s: float = 32.0,
                 m: float = 0.15, img_size: int = 224,
                 quick_gelu: bool = False, dtype=torch.float32):
        super().__init__()
        cfg = VIT_CONFIGS[variant]
        self.variant, self.p, self.s, self.m = variant, p, s, m
        self.dtype = compute_dtype(dtype)
        self.backbone = VisionTransformer(img_size=img_size,
                                          quick_gelu=quick_gelu,
                                          dtype=self.dtype, **cfg)
        self.whiten = nn.Linear(2 * cfg["dim"], outputdim)
        self.classifier_w = nn.Parameter(torch.empty(num_classes, outputdim))
        nn.init.xavier_uniform_(self.classifier_w)

    @property
    def extent_multiple(self) -> int:
        """The patch size: bucketed extents must be multiples of it."""
        return VIT_CONFIGS[self.variant]["patch"]

    def _descriptor(self, x, valid_hw=None, normalize: bool = False):
        cls, patches = self.backbone(x, valid_hw=valid_hw)
        with span("vit.head"):
            cls = at_least_fp32(cls)
            xp = torch.clamp(at_least_fp32(patches), min=1e-6) ** self.p
            if valid_hw is None:
                gem = xp.mean(dim=1) ** (1.0 / self.p)
            else:
                pt = self.backbone.patch
                pm = token_mask(x.shape[1] // pt, x.shape[2] // pt,
                                torch.div(valid_hw, pt, rounding_mode="floor"),
                                dtype=xp.dtype)
                cnt = torch.clamp(pm.sum(dim=1, keepdim=True), min=1.0)
                gem = ((xp * pm[..., None]).sum(dim=1) / cnt) \
                    ** (1.0 / self.p)
            feat = self.whiten(torch.cat([cls, gem], dim=-1))
            return l2_normalize(feat) if normalize else feat

    @fp32_precision()
    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                train: bool | None = None):
        """``(loss, logits)``: ArcFace, the margin in training only."""
        train = train_mode(self, train)
        feat = self._descriptor(x)
        logits = arcface_logits(feat, self.classifier_w, labels, s=self.s,
                                m=self.m if train else 0.0)
        return cross_entropy(logits, labels), logits

    @fp32_precision()
    def extract(self, x: torch.Tensor,
                valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """[B, H, W, 3] (+ [B, 2] extents, multiples of the patch size)
        -> [B, outputdim] L2-normalized fp32 descriptors."""
        train_mode(self, False)
        return self._descriptor(x, valid_hw, normalize=True)


register_model(
    "vit_s16",
    description="ViT-S/16 global descriptor (CLS + GeM tokens) with ArcFace",
    defaults=dict(variant="s16", outputdim=512),
    family="vit",
    paper="ViT/DINOv2-style transformer global descriptor (BASELINE config 3)",
)(ViTGlobalModel)

register_model(
    "vit_b16",
    description="ViT-B/16 global descriptor",
    defaults=dict(variant="b16", outputdim=768),
    family="vit",
)(ViTGlobalModel)

# clip_vit_b32 / clip_r50 are registered in models/clip.py
