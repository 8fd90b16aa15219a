"""Token: transformer-refined object tokens over a ResNet's layer4
(port of ``research_image_retrieval_tpu/models/token.py``).

``TokenRefine``: a 1x1 convolution (with bias) and flax BN take layer4 to
``mid_dim``; its HW tokens pass ``Encoder`` layers; ``num_object``
learned queries attend over them with a softmax over the OBJECT axis
(per token, so a padded token's weights are zeroed after the softmax);
the object tokens go through Linear + flax LayerNorm, ``Decoder`` layers
(cross-attention to the HW tokens, padded keys masked), then their
concatenation through ``proj`` and flax BN.  ``TokenModel``: ResNet
(layer4 tap) + ``TokenRefine`` + ArcFace with ``s = sqrt(outputdim)``;
eval logits carry no margin.

``use_delg_arcface`` (RetrievalNet) trains with DELG's ArcFace, whose
hard-example threshold ``t`` is an EMA kept in the persistent ``[1]``
buffer ``arcface_t`` (JAX: the ``model_state`` collection).  A
train-mode forward returns ``(loss, logits, {"arcface_t": new_t})``
and changes nothing: the train step (``train/loop.py``) writes the new
value, so init, eval and extraction never move it.

The backbone runs in ``dtype`` (its identity blocks on the bottleneck
kernel in eval mode); the head runs in fp32.  Its dropout, attention
dropout and drop-path (0.1 each, as in JAX) draw from the ``generator``
the train step passes.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from research_image_retrieval_tpu_torch.models.backbone import (
    BatchNorm,
    ResNet,
    compute_dtype,
    stage_extents,
    train_mode,
)
from research_image_retrieval_tpu_torch.models.layers import (
    Decoder,
    Encoder,
    LayerNorm,
)
from research_image_retrieval_tpu_torch.models.registry import register_model
from research_image_retrieval_tpu_torch.ops.losses import (
    arcface_delg_logits,
    arcface_logits,
    cross_entropy,
)
from research_image_retrieval_tpu_torch.ops.masking import token_mask
from research_image_retrieval_tpu_torch.ops.norm import (
    at_least_fp32,
    l2_normalize,
)
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["TokenModel", "TokenRefine"]


class TokenRefine(nn.Module):
    """Object-query token refinement head over an NHWC map."""

    def __init__(self, in_dim: int, num_heads: int = 8, num_object: int = 4,
                 mid_dim: int = 1024, encoder_layers: int = 1,
                 decoder_layers: int = 2, qkv_bias: bool = True,
                 drop: float = 0.1, attn_drop: float = 0.1,
                 drop_path: float = 0.1, out_dim: int = 1024):
        super().__init__()
        self.num_object, self.mid_dim = num_object, mid_dim
        self.encoder_layers, self.decoder_layers = encoder_layers, \
            decoder_layers
        self.conv = nn.Conv2d(in_dim, mid_dim, 1)
        self.conv_bn = BatchNorm(mid_dim)
        blocks = (mid_dim, num_heads, qkv_bias, drop, attn_drop, drop_path)
        for i in range(encoder_layers):
            self.add_module(f"encoder{i}", Encoder(*blocks))
        self.query = nn.Parameter(torch.randn(1, num_object, mid_dim))
        self.token_norm_fc = nn.Linear(mid_dim, mid_dim)
        self.token_norm_ln = LayerNorm(mid_dim)
        for i in range(decoder_layers):
            self.add_module(f"decoder{i}", Decoder(*blocks))
        self.proj = nn.Linear(mid_dim * num_object, out_dim)
        self.proj_bn = BatchNorm(out_dim)

    def reset_flax(self, generator: torch.Generator):
        """flax's ``normal(1.0)`` law for the queries (``training_init``)."""
        with torch.no_grad():
            self.query.copy_(torch.randn(self.query.shape,
                                         generator=generator))

    @fp32_precision()
    def forward(self, fmap: torch.Tensor, token_mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """[B, H, W, C] map (+ [B, H*W] token validity) -> [B, out_dim]."""
        B, H, W, _ = fmap.shape
        x = self.conv_bn(self.conv(fmap.permute(0, 3, 1, 2)))
        x = x.permute(0, 2, 3, 1).reshape(B, H * W, self.mid_dim)
        for i in range(self.encoder_layers):
            x = getattr(self, f"encoder{i}")(x, key_mask=token_mask,
                                             generator=generator)
        q = self.query.expand(B, -1, -1)
        # softmax over the objects, per token
        attns = torch.softmax(torch.einsum("bod,bnd->bon", q, x), dim=1)
        if token_mask is not None:
            attns = attns * token_mask[:, None, :].to(attns.dtype)
        token = torch.einsum("bon,bnd->bod", attns, x)
        token = self.token_norm_ln(self.token_norm_fc(token))
        for i in range(self.decoder_layers):
            token = getattr(self, f"decoder{i}")(token, x, key_mask=token_mask,
                                                 generator=generator)
        token = self.proj(token.reshape(B, self.num_object * self.mid_dim))
        return self.proj_bn(token[:, :, None, None])[:, :, 0, 0]


class TokenModel(nn.Module):
    """ResNet + ``TokenRefine`` + ArcFace (DELG's with
    ``use_delg_arcface``)."""

    takes_generator = True  # the train step passes its dropout generator

    def __init__(self, backbone_name: str = "resnet101", outputdim: int = 1024,
                 num_classes: int = 81313, num_object: int = 4,
                 m: float = 0.2, use_delg_arcface: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.outputdim, self.m = outputdim, m
        self.use_delg_arcface = use_delg_arcface
        self.backbone = ResNet(backbone_name, dtype=self.dtype)
        self.tr = TokenRefine(self.backbone.outputdim, mid_dim=outputdim,
                              num_object=num_object, out_dim=outputdim)
        self.classifier_w = nn.Parameter(torch.empty(num_classes, outputdim))
        nn.init.xavier_uniform_(self.classifier_w)
        if use_delg_arcface:
            self.register_buffer("arcface_t", torch.zeros(1))

    def _descriptor(self, x, valid_hw=None, generator=None):
        fmap = at_least_fp32(self.backbone(x, valid_hw=valid_hw))
        tmask = None
        if valid_hw is not None:
            tmask = token_mask(fmap.shape[1], fmap.shape[2],
                               stage_extents(valid_hw, 5))
        return self.tr(fmap, token_mask=tmask, generator=generator)

    @fp32_precision()
    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                train: bool | None = None,
                generator: torch.Generator | None = None):
        """``(loss, logits)``; a RetrievalNet train forward returns
        ``(loss, logits, {"arcface_t": new_t})`` for the train step to
        store.  In train mode the dropout draws from ``generator``."""
        train = train_mode(self, train)
        feat = self._descriptor(x, generator=generator)
        s = float(self.outputdim) ** 0.5
        if self.use_delg_arcface and train:
            logits, new_t = arcface_delg_logits(
                feat, self.classifier_w, labels,
                t_state=self.arcface_t.to(feat.dtype), s=s, m=self.m)
            return cross_entropy(logits, labels), logits, \
                {"arcface_t": new_t}
        logits = arcface_logits(feat, self.classifier_w, labels, s=s,
                                m=self.m if train else 0.0)
        return cross_entropy(logits, labels), logits

    @fp32_precision()
    def extract(self, x: torch.Tensor,
                valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """[B, H, W, 3] images (+ [B, 2] bucket extents) -> [B, outputdim]
        L2-normalized fp32 descriptors."""
        train_mode(self, False)
        return l2_normalize(self._descriptor(x, valid_hw))


register_model(
    "token_r101",
    description="Token: transformer-refined object tokens over ResNet101 "
                "(reference RetrievalNet.py:290)",
    defaults=dict(backbone_name="resnet101", outputdim=1024),
    family="token",
    paper="Token-based representation (Wu et al.)",
    table1_names=("R101-Token",),
)(TokenModel)

register_model(
    "retrievalnet_r101",
    description="RetrievalNet: Token head with ArcFace-DELG hard-example "
                "EMA (reference RetrievalNet.py:263-286)",
    defaults=dict(backbone_name="resnet101", outputdim=1024,
                  use_delg_arcface=True),
    family="token",
)(TokenModel)

register_model(
    "token_r50",
    description="Token head over ResNet50",
    defaults=dict(backbone_name="resnet50", outputdim=1024),
    family="token",
    table1_names=("R50-Token",),
)(TokenModel)
