"""SPARSE: adaptive sparse encoding + semantic-preserving quantization
(port of ``research_image_retrieval_tpu/models/sparse.py``).

* ``AdaptiveSparseEncoder`` — an MLP predicts each sample's sparsity in
  [0.05, 0.3]; ``k = clip(round(D (1 - sparsity)), 1, D)`` and the
  coordinates whose |value| is not above the k-th smallest |value| are
  zeroed (``sparse_select``); an L1 term on what is left.
* ``SemanticPreservingQuantization`` — an importance MLP gives
  ``bits = round(2 + 6 importance)`` per coordinate, and the affine
  codes ``round(clip(x / scale + zero_point, 0, 2^bits - 1))``
  (``quantize_codes``) are dequantized; the straight-through value is
  ``x + (x_deq - x).detach()``, as JAX's ``x + stop_gradient(x_deq -
  x)`` (it rounds as JAX's does, which ``x_deq`` itself would not).
* ``LLMKnowledgeDistillation`` — projection MLPs (flax's LayerNorm and
  tanh-approximated GELU) and an InfoNCE term against precomputed
  teacher text embeddings (``data/teacher.py``, gathered by label in
  the train step).  ``text_proj`` exists whether or not a teacher is
  used, so the parameter set is the same with and without one.

``sparse_select`` and ``quantize_codes`` are the step functions on the
extraction path; they are module functions so that a check can record
their inputs.  The backbone runs in ``dtype`` (its identity blocks on
the bottleneck kernel in eval mode), the heads in fp32; the sparse and
quantized vector sits between the projection and the norm, so the head
kernel does not run.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from research_image_retrieval_tpu_torch.models.backbone import (
    ResNet,
    compute_dtype,
    stage_extents,
    train_mode,
)
from research_image_retrieval_tpu_torch.models.layers import LayerNorm
from research_image_retrieval_tpu_torch.models.registry import register_model
from research_image_retrieval_tpu_torch.ops.losses import cross_entropy
from research_image_retrieval_tpu_torch.ops.masking import hw_mask
from research_image_retrieval_tpu_torch.ops.norm import l2_normalize
from research_image_retrieval_tpu_torch.ops.pooling import gem_pool
from research_image_retrieval_tpu_torch.utils import collectives
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["AdaptiveSparseEncoder", "LLMKnowledgeDistillation",
           "SemanticPreservingQuantization", "SparseRetrievalModel",
           "quantize_codes", "sparse_select"]


def sparse_select(x: torch.Tensor, sparsity: torch.Tensor):
    """(k [B], threshold [B, 1], mask [B, D] in ``x``'s dtype): ``k =
    clip(round(D (1 - sparsity)), 1, D)``, the threshold the k-th
    smallest |x| of each row, the mask ``|x| > threshold``."""
    D = x.shape[1]
    abs_x = x.abs()
    sorted_abs = torch.sort(abs_x, dim=1).values
    k = torch.clamp(torch.round(D * (1.0 - sparsity[:, 0])).to(torch.int64),
                    1, D)
    threshold = torch.gather(sorted_abs, 1, (k - 1)[:, None])
    return k, threshold, (abs_x > threshold).to(x.dtype)


def quantize_codes(x_scaled: torch.Tensor, importance: torch.Tensor,
                   min_bits: int, max_bits: int):
    """(bits, codes): ``bits = round(min + (max - min) importance)`` and
    ``round(clip(x_scaled, 0, 2^bits - 1))`` (no gradient through the
    rounding, as in JAX)."""
    bits = torch.round(min_bits + (max_bits - min_bits) * importance)
    qmax = 2.0 ** bits - 1.0
    codes = torch.round(torch.minimum(torch.clamp(x_scaled, min=0.0), qmax))
    return bits, codes


class _ProjMLP(nn.Module):
    """Linear -> LayerNorm -> GELU (tanh) -> Linear."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, 2 * out_dim)
        self.ln = LayerNorm(2 * out_dim)
        self.fc2 = nn.Linear(2 * out_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.ln(self.fc1(x)), approximate="tanh"))


class LLMKnowledgeDistillation(nn.Module):
    """Contrastive distillation from teacher text embeddings
    (``text_features`` [B, text_dim], or [B, L, text_dim] mean-pooled):
    InfoNCE over the cosines of the distillation head's output and the
    projected teacher rows, at ``temperature``, against the diagonal."""

    def __init__(self, in_dim: int, embed_dim: int = 256,
                 text_dim: int = 768, temperature: float = 2.0):
        super().__init__()
        self.text_dim = text_dim
        self.temperature = temperature
        self.visual_proj = _ProjMLP(in_dim, embed_dim)
        self.distill_head = _ProjMLP(embed_dim, embed_dim)
        self.text_proj = _ProjMLP(text_dim, embed_dim)

    @fp32_precision()
    def forward(self, visual_features: torch.Tensor,
                text_features: torch.Tensor | None = None) -> dict:
        if visual_features.dim() == 4:  # [B, H, W, C] map -> GAP
            visual_features = visual_features.mean(dim=(1, 2))
        visual_embed = self.visual_proj(visual_features)
        distill_embed = self.distill_head(visual_embed)
        zero = torch.zeros((), dtype=torch.float32,
                           device=visual_embed.device)
        out = {"visual_embed": visual_embed, "distill_embed": distill_embed,
               "distill_loss": zero}
        if text_features is None:
            return out
        if text_features.dim() == 3:
            text_features = text_features.mean(dim=1)
        text_features = text_features.detach().to(
            torch.promote_types(text_features.dtype, visual_embed.dtype))
        text_embed = self.text_proj(text_features)
        # under a multi-GPU layout: the global batch's pairs
        t = l2_normalize(collectives.data_gather_grad(text_embed))
        d = l2_normalize(collectives.data_gather_grad(distill_embed))
        sim = (d @ t.T) / self.temperature
        labels = torch.arange(sim.shape[0], device=sim.device)
        out.update(text_embed=text_embed,
                   distill_loss=cross_entropy(sim, labels))
        return out


class AdaptiveSparseEncoder(nn.Module):
    """Learned per-sample sparsification of a [B, D] vector."""

    def __init__(self, input_dim: int, min_sparsity: float = 0.05,
                 max_sparsity: float = 0.3):
        super().__init__()
        self.min_sparsity = min_sparsity
        self.max_sparsity = max_sparsity
        self.sp_fc1 = nn.Linear(input_dim, input_dim // 4)
        self.sp_fc2 = nn.Linear(input_dim // 4, 1)

    @fp32_precision()
    def forward(self, x: torch.Tensor) -> dict:
        s = torch.sigmoid(self.sp_fc2(F.relu(self.sp_fc1(x))))  # [B, 1]
        sparsity = self.min_sparsity \
            + (self.max_sparsity - self.min_sparsity) * s
        k, threshold, mask = sparse_select(x, sparsity)
        sparse_x = x * mask
        return {"sparse_features": sparse_x, "mask": mask,
                "sparsity": sparsity, "k": k, "threshold": threshold,
                "actual_sparsity": mask.sum(dim=1) / x.shape[1],
                "l1_reg": sparse_x.abs().sum(dim=1).mean()}


class SemanticPreservingQuantization(nn.Module):
    """Mixed 2-8 bit straight-through quantization of a [B, D] vector;
    ``scale`` and ``zero_point`` are learned scalars (init 1 and 0)."""

    def __init__(self, input_dim: int, min_bits: int = 2, max_bits: int = 8,
                 semantic_weight: float = 0.5):
        super().__init__()
        self.min_bits, self.max_bits = min_bits, max_bits
        self.semantic_weight = semantic_weight
        self.imp_fc1 = nn.Linear(input_dim, input_dim // 2)
        self.imp_fc2 = nn.Linear(input_dim // 2, input_dim)
        self.scale = nn.Parameter(torch.ones(1))
        self.zero_point = nn.Parameter(torch.zeros(1))

    @fp32_precision()
    def forward(self, x: torch.Tensor) -> dict:
        importance = torch.sigmoid(self.imp_fc2(F.relu(self.imp_fc1(x))))
        scale = self.scale.abs() + 1e-6
        zp = self.zero_point
        bits, codes = quantize_codes(x / scale + zp, importance,
                                     self.min_bits, self.max_bits)
        x_deq = (codes - zp) * scale
        x_ste = x + (x_deq - x).detach()  # straight-through
        recon = ((x_deq - x) ** 2).mean()
        semantic = (importance * (x_deq - x).abs()).sum(dim=1).mean()
        return {"quantized_features": x_ste, "importance": importance,
                "bits": bits, "codes": codes, "avg_bits": bits.mean(),
                "recon_loss": recon, "semantic_loss": semantic,
                "quant_loss": recon + self.semantic_weight * semantic}


class SparseRetrievalModel(nn.Module):
    """Backbone -> GeM -> projection -> sparse encoding -> quantization;
    the descriptor is the L2 of the quantized sparse vector."""

    def __init__(self, backbone_name: str = "resnet50", outputdim: int = 512,
                 num_classes: int = 81313, l1_weight: float = 1e-4,
                 quant_weight: float = 0.1, distill_weight: float = 0.5,
                 distill_dim: int = 256, text_dim: int = 768,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.backbone = ResNet(backbone_name, dtype=self.dtype)
        self.l1_weight, self.quant_weight = l1_weight, quant_weight
        self.distill_weight = distill_weight
        self.text_dim = text_dim  # the teacher table's width
        self.proj = nn.Linear(self.backbone.outputdim, outputdim)
        self.sparse = AdaptiveSparseEncoder(outputdim)
        self.quant = SemanticPreservingQuantization(outputdim)
        self.distill = LLMKnowledgeDistillation(outputdim, distill_dim,
                                                text_dim)
        self.classifier = nn.Linear(outputdim, num_classes)

    def _encode(self, x, valid_hw=None):
        fmap = self.backbone(x, valid_hw=valid_hw)
        mask = None
        if valid_hw is not None:
            mask = hw_mask(fmap.shape[1], fmap.shape[2],
                           stage_extents(valid_hw, 5))
        feat = self.proj(gem_pool(fmap, p=3.0, valid_hw=mask))
        sp = self.sparse(feat)
        q = self.quant(sp["sparse_features"])
        return q["quantized_features"], sp, q

    @fp32_precision()
    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                train: bool | None = None,
                text_features: torch.Tensor | None = None):
        """Train forward ``(loss, logits)``: cross entropy + the L1 and
        quantization terms, + the distillation term when
        ``text_features`` (teacher rows, [B, text_dim] or [B, L,
        text_dim]) are given."""
        train_mode(self, train)
        feat, sp, q = self._encode(x)
        logits = self.classifier(feat)
        loss = (cross_entropy(logits, labels)
                + self.l1_weight * sp["l1_reg"]
                + self.quant_weight * q["quant_loss"])
        if text_features is not None:
            loss = loss + self.distill_weight * self.distill(
                feat, text_features)["distill_loss"]
        return loss, logits

    @fp32_precision()
    def extract(self, x: torch.Tensor,
                valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """[B, H, W, 3] images (+ [B, 2] bucket extents) -> [B, D]
        L2-normalized fp32 descriptors."""
        train_mode(self, False)
        return l2_normalize(self._encode(x, valid_hw)[0])


register_model(
    "sparse_r50",
    description="SPARSE adaptive sparse + mixed-bit quantized descriptors "
                "(reference manus/1_SPARSE/sparse_model.py)",
    defaults=dict(backbone_name="resnet50", outputdim=512),
    family="sparse",
)(SparseRetrievalModel)
