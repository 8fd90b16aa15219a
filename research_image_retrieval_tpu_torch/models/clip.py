"""CLIP: the dual-tower image / text model and its retrieval model
(port of ``research_image_retrieval_tpu/models/clip.py``).

``CLIP``: a visual tower (a ``VIT_CONFIGS`` key builds the quick-GELU
``VisionTransformer`` with ``ln_pre`` and a ``visual_projection``; a
``CLIP_RESNET_CONFIGS`` key builds the attention-pooled
``ModifiedResNet``, whose ``c_proj`` already projects), a causal text
transformer over token ids (the feature at the highest id, CLIP's EOT
rule), a learned ``logit_scale`` and the symmetric contrastive loss.
``CLIPGlobalModel``: the visual tower + ArcFace as a registry retrieval
model (``clip_vit_b32``, ``clip_r50``); its tower has ``CLIP``'s names,
so ``clip_convert.load_clip_visual_into`` drops an OpenAI-layout
checkpoint's visual weights in.

The tower computes in ``dtype`` (fp32 or bf16); the projection, the L2
normalization and the loss run in fp32.  The ViT towers take bucket
extents that are multiples of the patch size (``extent_multiple``); the
ModifiedResNet tower takes any extents.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from research_image_retrieval_tpu_torch.models.backbone import (
    compute_dtype,
    train_mode,
)
from research_image_retrieval_tpu_torch.models.clip_resnet import (
    CLIP_RESNET_CONFIGS,
    ModifiedResNet,
)
from research_image_retrieval_tpu_torch.models.layers import LayerNorm
from research_image_retrieval_tpu_torch.models.registry import register_model
from research_image_retrieval_tpu_torch.models.vit import (
    VIT_CONFIGS,
    ViTBlock,
    VisionTransformer,
)
from research_image_retrieval_tpu_torch.ops.losses import (
    arcface_logits,
    cross_entropy,
)
from research_image_retrieval_tpu_torch.ops.norm import (
    at_least_fp32,
    l2_normalize,
)
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["CLIP", "CLIPGlobalModel", "CLIPTextBlock", "CLIPTextEncoder",
           "clip_contrastive_loss"]


class CLIPTextBlock(ViTBlock):
    """Pre-norm causal block of the text tower (quick GELU)."""

    def __init__(self, dim: int, heads: int):
        super().__init__(dim, heads, quick_gelu=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x, causal=True)


class CLIPTextEncoder(nn.Module):
    """Causal text transformer over ``[B, T]`` token ids (0-padded after
    the EOT token, which has the highest id)."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 dim: int = 512, depth: int = 12, heads: int = 8,
                 embed_dim: int = 512):
        super().__init__()
        self.depth = depth
        self.token_embedding = nn.Embedding(vocab_size, dim)
        self.positional_embedding = nn.Parameter(
            torch.zeros(context_length, dim))
        for i in range(depth):
            self.add_module(f"block{i}", CLIPTextBlock(dim, heads))
        self.ln_final = LayerNorm(dim)
        self.text_projection = nn.Linear(dim, embed_dim, bias=False)

    def reset_flax(self, generator: torch.Generator):
        """flax's laws for the embeddings: ``Embed``'s unit-variance
        normal over the fan-in axis and ``normal(0.01)`` positions."""
        with torch.no_grad():
            emb = self.token_embedding.weight
            emb.copy_(torch.randn(emb.shape, generator=generator)
                      / math.sqrt(emb.shape[1]))
            pos = self.positional_embedding
            pos.copy_(0.01 * torch.randn(pos.shape, generator=generator))

    @fp32_precision()
    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        B, T = token_ids.shape
        x = self.token_embedding(token_ids.long()) \
            + self.positional_embedding[:T]
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        x = self.ln_final(x)
        eot = torch.argmax(token_ids, dim=1)
        return self.text_projection(x[torch.arange(B, device=x.device), eot])


def clip_contrastive_loss(image_features: torch.Tensor,
                          text_features: torch.Tensor,
                          logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over an aligned image / text batch."""
    im = l2_normalize(at_least_fp32(image_features))
    tx = l2_normalize(at_least_fp32(text_features))
    logits = logit_scale * torch.matmul(im, tx.t())
    diag = torch.diagonal(logits)
    return 0.5 * ((torch.logsumexp(logits, dim=1) - diag).mean()
                  + (torch.logsumexp(logits, dim=0) - diag).mean())


def _tower(variant: str, embed_dim: int, img_size: int, dtype):
    """(visual tower, its projection or None) of a CLIP variant."""
    if variant in CLIP_RESNET_CONFIGS:
        return ModifiedResNet(output_dim=embed_dim, input_resolution=img_size,
                              dtype=dtype, **CLIP_RESNET_CONFIGS[variant]), \
            None
    cfg = VIT_CONFIGS[variant]
    return (VisionTransformer(img_size=img_size, quick_gelu=True, dtype=dtype,
                              **cfg),
            nn.Linear(cfg["dim"], embed_dim, bias=False))


class CLIP(nn.Module):
    """Dual-tower CLIP; ``image_features`` doubles as a retrieval
    descriptor."""

    def __init__(self, visual_variant: str = "b32", embed_dim: int = 512,
                 vocab_size: int = 49408, context_length: int = 77,
                 text_dim: int = 512, text_depth: int = 12,
                 text_heads: int = 8, img_size: int = 224):
        super().__init__()
        self.visual_variant = visual_variant
        self.visual, proj = _tower(visual_variant, embed_dim, img_size,
                                   torch.float32)
        if proj is not None:
            self.visual_projection = proj
        self.text = CLIPTextEncoder(vocab_size, context_length, text_dim,
                                    text_depth, text_heads, embed_dim)
        self.logit_scale = nn.Parameter(
            torch.tensor(math.log(1 / 0.07), dtype=torch.float32))

    def image_features(self, images: torch.Tensor,
                       valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        if not hasattr(self, "visual_projection"):
            return self.visual(images, valid_hw=valid_hw)
        cls, _ = self.visual(images, valid_hw=valid_hw)
        return self.visual_projection(cls)

    def text_features(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self.text(token_ids)

    @fp32_precision()
    def forward(self, images: torch.Tensor, token_ids: torch.Tensor):
        """``(loss, (image features, text features))``."""
        im = self.image_features(images)
        tx = self.text_features(token_ids)
        loss = clip_contrastive_loss(im, tx, torch.exp(self.logit_scale))
        return loss, (im, tx)

    @fp32_precision()
    def extract(self, images: torch.Tensor,
                valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """L2-normalized image embedding (``valid_hw``: bucket extents,
        patch multiples for a ViT tower)."""
        return l2_normalize(self.image_features(images, valid_hw=valid_hw))


class CLIPGlobalModel(nn.Module):
    """CLIP visual tower + ArcFace as a registry retrieval model."""

    def __init__(self, variant: str = "b32", outputdim: int = 512,
                 num_classes: int = 81313, s: float = 32.0, m: float = 0.15,
                 img_size: int = 224, dtype=torch.float32):
        super().__init__()
        self.variant, self.s, self.m = variant, s, m
        self.dtype = compute_dtype(dtype)
        self.visual, proj = _tower(variant, outputdim, img_size, self.dtype)
        if proj is not None:
            self.visual_projection = proj
        self.classifier_w = nn.Parameter(torch.empty(num_classes, outputdim))
        nn.init.xavier_uniform_(self.classifier_w)

    @property
    def extent_multiple(self) -> int:
        """The patch size of a ViT tower; 1 for the ModifiedResNet, whose
        masked path follows any extents."""
        if self.variant in CLIP_RESNET_CONFIGS:
            return 1
        return VIT_CONFIGS[self.variant]["patch"]

    def _descriptor(self, x, valid_hw=None):
        if not hasattr(self, "visual_projection"):
            return at_least_fp32(self.visual(x, valid_hw=valid_hw))
        cls, _ = self.visual(x, valid_hw=valid_hw)
        return self.visual_projection(at_least_fp32(cls))

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
        """[B, H, W, 3] (+ [B, 2] extents) -> [B, outputdim] L2-normalized
        fp32 descriptors."""
        train_mode(self, False)
        return l2_normalize(self._descriptor(x, valid_hw))


register_model(
    "clip_vit_b32",
    description="CLIP ViT-B/32 visual tower + ArcFace; loads OpenAI-layout "
                "checkpoints via clip_convert (reference "
                "networks/model.py:206-243)",
    defaults=dict(variant="b32", outputdim=512),
    family="clip_vit",
)(CLIPGlobalModel)

register_model(
    "clip_r50",
    description="CLIP ModifiedResNet-50 (attention-pooled) + ArcFace; loads "
                "OpenAI-layout checkpoints via clip_convert (reference "
                "networks/model.py:94-154)",
    defaults=dict(variant="r50", outputdim=1024),
    family="clip_rn",
)(CLIPGlobalModel)
