"""SPECTRUM: batch-level attention over a CNN backbone
(port of ``research_image_retrieval_tpu/models/spectrum.py``).

* ``BatchCASTLE`` — samples attend to each other (8 heads), gated by a
  learned causal mask: an MLP over each pair's |feature difference| ->
  sigmoid, thresholded, the diagonal forced to 1, masked pairs at -1e9.
* ``PRISM`` — the visual vector attends to text tokens (flax
  ``MultiHeadDotProductAttention``, 4 heads); without text a
  ``mock_text`` projection of the visual vector stands in.
* ``BatchNEXUS`` — each sample keeps its top-w most similar peers (w
  predicted per sample, 1..min(8, B)) through a double stable
  ``argsort``, as JAX's, and attends over them.
* ``HARMONY`` — a softmax gate over the module outputs, then flax's
  LayerNorm (``models/layers.LayerNorm``).

Training is cross entropy plus ``consistency_weight`` times the mean
squared gap between the L2 of the fused and of the base vector.  Under a
multi-GPU layout CASTLE and NEXUS attend over the global batch
(``utils.collectives.data_gather_grad``), as JAX's GSPMD step does.
``extract`` runs PRISM and HARMONY only, with CASTLE and NEXUS as the
identity (``[base, base, prism, base]``): each image's descriptor is
independent of its batch, so bucketed extraction stays per-image.  The
backbone runs in ``dtype`` (its identity blocks on the bottleneck
kernel in eval mode); the heads in fp32.  No GeM head here: a
projection sits between the pool and the norm, so the head kernel does
not run.
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
from research_image_retrieval_tpu_torch.models.layers import (
    LayerNorm,
    MultiHeadAttention,
)
from research_image_retrieval_tpu_torch.models.registry import register_model
from research_image_retrieval_tpu_torch.ops.losses import cross_entropy
from research_image_retrieval_tpu_torch.ops.masking import hw_mask
from research_image_retrieval_tpu_torch.ops.norm import l2_normalize
from research_image_retrieval_tpu_torch.ops.pooling import gem_pool
from research_image_retrieval_tpu_torch.utils import collectives
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["HARMONY", "PRISM", "BatchCASTLE", "BatchNEXUS", "SPECTRUMModel"]


class BatchCASTLE(nn.Module):
    """Causal selective batch attention: ``[B, D] -> ([B, D], mask)``,
    ``mask`` [B, B] bool with a true diagonal."""

    def __init__(self, dim: int, num_heads: int = 8,
                 causal_threshold: float = 0.5):
        super().__init__()
        self.num_heads = num_heads
        self.causal_threshold = causal_threshold
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.mask_fc1 = nn.Linear(dim, dim // 2)
        self.mask_fc2 = nn.Linear(dim // 2, 1)
        self.proj = nn.Linear(dim, dim)

    @fp32_precision()
    def forward(self, features: torch.Tensor):
        B, D = features.shape
        h = self.num_heads
        hd = D // h
        q, k, v = (a.reshape(B, h, hd)
                   for a in self.qkv(features).split(D, dim=1))
        scores = torch.einsum("ihd,jhd->hij", q, k) * hd ** -0.5
        diff = (features[:, None, :] - features[None, :, :]).abs()
        causal = torch.sigmoid(self.mask_fc2(F.relu(self.mask_fc1(diff))))
        eye = torch.eye(B, dtype=torch.bool, device=features.device)
        mask = (causal[..., 0] > self.causal_threshold) | eye
        scores = torch.where(mask[None], scores, -1e9)
        attn = torch.softmax(scores, dim=-1)
        out = torch.einsum("hij,jhd->ihd", attn, v).reshape(B, D)
        return self.proj(out), mask


class PRISM(nn.Module):
    """Cross-modal (visual <- text) attention: ``visual`` [B, D], ``text``
    [B, T, text_dim] or None (the mock text)."""

    def __init__(self, dim: int, num_heads: int = 4, text_dim: int = 384):
        super().__init__()
        self.mock_text = nn.Linear(dim, text_dim)
        self.text_proj = nn.Linear(text_dim, dim)
        self.cross = MultiHeadAttention(dim, num_heads)
        self.fuse = nn.Linear(2 * dim, dim)

    @fp32_precision()
    def forward(self, visual: torch.Tensor,
                text: torch.Tensor | None = None) -> dict:
        if text is None:
            text = self.mock_text(visual)[:, None, :]
        t = self.text_proj(text)  # [B, T, D]
        att = self.cross(visual[:, None, :], kv=t)
        fused = self.fuse(torch.cat([visual, att[:, 0]], dim=-1))
        return {"fused": fused, "text_proj": t}


class BatchNEXUS(nn.Module):
    """Adaptive-window sparse batch attention: ``[B, D] -> ([B, D],
    keep)``, ``keep`` [B, B] bool (each row's top-w peers, itself
    first)."""

    def __init__(self, dim: int, max_window: int = 8):
        super().__init__()
        self.max_window = max_window
        self.window_pred = nn.Linear(dim, 1)
        self.proj = nn.Linear(dim, dim)

    @fp32_precision()
    def forward(self, features: torch.Tensor):
        B, D = features.shape
        w = torch.sigmoid(self.window_pred(features))  # [B, 1]
        window = torch.clamp(torch.round(w * self.max_window), 1,
                             min(self.max_window, B))
        f = l2_normalize(features)
        sims = f @ f.T
        # each peer's rank in its row (0 = most similar), ties in index
        # order as JAX's stable argsort breaks them
        order = torch.argsort(-sims, dim=1, stable=True)
        ranks = torch.argsort(order, dim=1, stable=True).to(sims.dtype)
        keep = ranks < window
        scores = sims / D ** 0.5
        scores = torch.where(keep, scores, -1e9)
        out = torch.softmax(scores, dim=-1) @ features
        return self.proj(out), keep


class HARMONY(nn.Module):
    """Gated fusion of the four module outputs (4 x [B, D]) -> [B, D],
    LayerNorm'd."""

    def __init__(self, dim: int):
        super().__init__()
        self.gate = nn.Linear(dim, 4)
        self.ln = LayerNorm(dim)

    @fp32_precision()
    def forward(self, branches) -> torch.Tensor:
        stack = torch.stack(branches, dim=1)  # [B, M, D]
        gate = torch.softmax(self.gate(stack.mean(dim=1)), dim=-1)
        return self.ln(torch.einsum("bm,bmd->bd", gate, stack))


class SPECTRUMModel(nn.Module):
    """Backbone -> GeM -> projection -> CASTLE / PRISM / NEXUS ->
    HARMONY (see the module docstring)."""

    def __init__(self, backbone_name: str = "resnet50", outputdim: int = 512,
                 num_classes: int = 81313, consistency_weight: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.backbone = ResNet(backbone_name, dtype=self.dtype)
        self.consistency_weight = consistency_weight
        self.proj = nn.Linear(self.backbone.outputdim, outputdim)
        self.castle = BatchCASTLE(outputdim)
        self.prism = PRISM(outputdim)
        self.nexus = BatchNEXUS(outputdim)
        self.harmony = HARMONY(outputdim)
        self.classifier = nn.Linear(outputdim, num_classes)

    def _base(self, x, valid_hw=None):
        fmap = self.backbone(x, valid_hw=valid_hw)
        mask = None
        if valid_hw is not None:
            mask = hw_mask(fmap.shape[1], fmap.shape[2],
                           stage_extents(valid_hw, 5))
        return self.proj(gem_pool(fmap, p=3.0, valid_hw=mask))

    @fp32_precision()
    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                train: bool | None = None,
                text: torch.Tensor | None = None):
        """Train forward ``(loss, logits)``: the batch modules attend
        across the batch; ``text`` [B, T, 384] feeds PRISM (None: the
        mock text)."""
        train_mode(self, train)
        base = self._base(x)
        # the batch modules attend over the global batch under a layout;
        # each rank keeps its rows
        whole = collectives.data_gather_grad(base)
        castle_out = collectives.data_rows(self.castle(whole)[0], len(base))
        prism_out = self.prism(base, text)["fused"]
        nexus_out = collectives.data_rows(self.nexus(whole)[0], len(base))
        fused = self.harmony([base, castle_out, prism_out, nexus_out])
        logits = self.classifier(fused)
        cons = ((l2_normalize(fused) - l2_normalize(base)) ** 2).mean()
        return (cross_entropy(logits, labels)
                + self.consistency_weight * cons), logits

    @fp32_precision()
    def extract(self, x: torch.Tensor,
                valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """[B, H, W, 3] images (+ [B, 2] bucket extents) -> [B, D]
        L2-normalized fp32 descriptors, each image on its own."""
        train_mode(self, False)
        base = self._base(x, valid_hw)
        prism_out = self.prism(base)["fused"]
        return l2_normalize(self.harmony([base, base, prism_out, base]))


register_model(
    "spectrum_r50",
    description="SPECTRUM batch-level attention prototype, completed from "
                "the reference's truncated design (manus/5_SPECTRUM)",
    defaults=dict(backbone_name="resnet50", outputdim=512),
    family="spectrum",
)(SPECTRUMModel)
