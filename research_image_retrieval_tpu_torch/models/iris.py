"""IRIS: ORACLE -> CASTLE -> NEXUS over a CNN backbone
(port of ``research_image_retrieval_tpu/models/iris.py``).

* ``ORACLE`` — object-relation pooling: the pad cells re-zeroed, a 3x3
  ``conv_reduce`` to 512 channels, ``num_objects`` overlapping row bins
  (bin i covers rows ``[floor(i h / O), ceil((i + 1) h / O))`` of each
  image's true height h, as ``AdaptiveAvgPool2d((O, 1))``; the integer
  form is kept), a 4-head relation attention over the bins, blended
  with the projected global average.
* ``CASTLE`` — attention over the single feature token, a causal gate
  ``sigmoid(.) > 0.5`` (``causal_gate``) that zeroes a whole sample's
  attended vector, and a refinement MLP blended at 0.3.
* ``NEXUS`` — local and global MLP branches over the attended token,
  fused.
* ``iris_loss`` — cross entropy + a temperature-scaled contrastive term.

Attention over one token is ``out(value(x))``; it still runs through
``MultiHeadAttention`` so that the flax parameters map one to one.  The
final dropout draws from the ``generator`` the train step passes
(``models/layers.dropout``).  The backbone runs in ``dtype`` (its
identity blocks on the bottleneck kernel in eval mode), the heads in
fp32; no GeM head, so the head kernel does not run.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from research_image_retrieval_tpu_torch.models.backbone import (
    ResNet,
    compute_dtype,
    nchw_conv,
    stage_extents,
    train_mode,
)
from research_image_retrieval_tpu_torch.models.layers import (
    MultiHeadAttention,
    dropout,
)
from research_image_retrieval_tpu_torch.models.registry import register_model
from research_image_retrieval_tpu_torch.ops.losses import cross_entropy
from research_image_retrieval_tpu_torch.ops.masking import hw_mask
from research_image_retrieval_tpu_torch.ops.norm import (
    at_least_fp32,
    l2_normalize,
)
from research_image_retrieval_tpu_torch.ops.pooling import avg_pool_all
from research_image_retrieval_tpu_torch.utils import collectives
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["CASTLE", "IRISModel", "NEXUS", "ORACLE", "causal_gate",
           "iris_loss"]


def causal_gate(causal: torch.Tensor, threshold: float) -> torch.Tensor:
    """CASTLE's gate: ``causal > threshold`` as 0 / 1 in ``causal``'s
    dtype (a step function of the sigmoid output)."""
    return (causal > threshold).to(causal.dtype)


def _floor_div(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


class ORACLE(nn.Module):
    """Object-relation pooling of a [B, H, W, C] map -> [B, output_dim]."""

    def __init__(self, in_ch: int, output_dim: int = 512,
                 num_objects: int = 8, context_balance: float = 0.5,
                 num_heads: int = 4):
        super().__init__()
        self.num_objects = num_objects
        self.context_balance = context_balance
        self.conv_reduce = nn.Conv2d(in_ch, 512, 3, padding=1)
        self.obj_proj = nn.Linear(512, output_dim)
        self.relation_net = MultiHeadAttention(output_dim, num_heads)
        self.context_proj = nn.Linear(in_ch, output_dim)
        self.final_proj = nn.Linear(output_dim, output_dim)

    def bins(self, conv: torch.Tensor,
             extents: torch.Tensor | None = None) -> torch.Tensor:
        """[B, H, W, 512] -> [B, O, 512]: the row bins' means over each
        image's true height and width."""
        B, H, W, _ = conv.shape
        O = self.num_objects
        if extents is None:
            rows = conv.mean(dim=2)  # [B, H, 512]
            out = []
            for i in range(O):
                lo = (i * H) // O
                hi = max(-(-(i + 1) * H // O), lo + 1)
                out.append(rows[:, lo:hi].mean(dim=1))
            return torch.stack(out, dim=1)
        h_t = extents[:, 0:1]  # [B, 1]
        w_t = extents[:, 1:2].to(conv.dtype)
        cmask = (torch.arange(W, device=conv.device)[None, :]
                 < extents[:, 1][:, None]).to(conv.dtype)  # [B, W]
        rows = torch.einsum("bhwc,bw->bhc", conv, cmask) \
            / torch.clamp(w_t, min=1.0)[:, :, None]
        ridx = torch.arange(H, device=conv.device)[None, :]
        out = []
        for i in range(O):
            lo = _floor_div(i * h_t, O)  # [B, 1]
            hi = torch.maximum(-_floor_div(-(i + 1) * h_t, O), lo + 1)
            rmask = ((ridx >= lo) & (ridx < hi)).to(conv.dtype)  # [B, H]
            cnt = torch.clamp(rmask.sum(dim=1, keepdim=True), min=1.0)
            out.append(torch.einsum("bhc,bh->bc", rows, rmask) / cnt)
        return torch.stack(out, dim=1)

    @fp32_precision()
    def forward(self, fmap: torch.Tensor,
                extents: torch.Tensor | None = None) -> torch.Tensor:
        """``extents`` [B, 2]: the map's valid (h, w) per image."""
        B, H, W, _ = fmap.shape
        gmask = None
        if extents is not None:
            gmask = hw_mask(H, W, extents, dtype=fmap.dtype)
            # pad cells re-zeroed: the 3x3 reads exact zero padding
            fmap = fmap * gmask[..., None]
        conv = F.relu(nchw_conv(self.conv_reduce, fmap))
        obj = self.obj_proj(self.bins(conv, extents))  # [B, O, D]
        aggregated = self.relation_net(obj).mean(dim=1)
        global_ctx = self.context_proj(avg_pool_all(fmap, valid_hw=gmask))
        fused = (self.context_balance * aggregated
                 + (1.0 - self.context_balance) * global_ctx)
        return self.final_proj(fused)


class CASTLE(nn.Module):
    """Causal-gated attention refinement of a [B, D] vector."""

    def __init__(self, dim: int = 512, num_heads: int = 8,
                 causal_threshold: float = 0.5,
                 counterfactual_strength: float = 0.3):
        super().__init__()
        self.causal_threshold = causal_threshold
        self.counterfactual_strength = counterfactual_strength
        self.attention = MultiHeadAttention(dim, num_heads)
        self.causal_fc1 = nn.Linear(dim, dim // 2)
        self.causal_fc2 = nn.Linear(dim // 2, 1)
        self.refine_fc1 = nn.Linear(dim, dim)
        self.refine_fc2 = nn.Linear(dim, dim)

    @fp32_precision()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attended = self.attention(x[:, None, :])  # [B, 1, D]
        causal = torch.sigmoid(self.causal_fc2(
            F.relu(self.causal_fc1(attended))))
        masked = attended * causal_gate(causal, self.causal_threshold)
        refined = self.refine_fc2(F.relu(self.refine_fc1(masked)))
        return (attended + self.counterfactual_strength * refined)[:, 0]


class NEXUS(nn.Module):
    """Local / global branch fusion of a [B, D] vector."""

    def __init__(self, dim: int = 512, num_heads: int = 8):
        super().__init__()
        self.attention = MultiHeadAttention(dim, num_heads)
        self.local_fc1 = nn.Linear(dim, dim // 2)
        self.local_fc2 = nn.Linear(dim // 2, dim)
        self.global_fc1 = nn.Linear(dim, dim // 2)
        self.global_fc2 = nn.Linear(dim // 2, dim)
        self.fusion_fc1 = nn.Linear(2 * dim, dim)
        self.fusion_fc2 = nn.Linear(dim, dim)

    @fp32_precision()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attended = self.attention(x[:, None, :])
        local = self.local_fc2(F.relu(self.local_fc1(attended)))
        glob = self.global_fc2(F.relu(self.global_fc1(attended)))
        fused = self.fusion_fc2(F.relu(self.fusion_fc1(
            torch.cat([local, glob], dim=-1))))
        return fused[:, 0]


def iris_loss(logits, features, labels, temperature: float = 0.07,
              classification_weight: float = 1.0,
              retrieval_weight: float = 0.5) -> torch.Tensor:
    """Cross entropy + the contrastive term over the batch's cosine
    similarities (masked entries enter the sums as exp(0), as in JAX).
    Under a multi-GPU layout the contrastive term is the global batch's
    (``utils.collectives.data_gather_grad``)."""
    cls_loss = cross_entropy(logits, labels)
    f = l2_normalize(at_least_fp32(collectives.data_gather_grad(features)))
    labels = collectives.data_gather(labels)
    sim = (f @ f.T) / temperature
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(len(labels), dtype=torch.bool, device=sim.device)
    pos, neg = same & ~eye, ~same
    pos_loss = -torch.log(torch.exp(sim * pos).sum(dim=1) + 1e-8).mean()
    neg_loss = torch.log(torch.exp(sim * neg).sum(dim=1) + 1e-8).mean()
    return (classification_weight * cls_loss
            + retrieval_weight * (pos_loss + neg_loss))


class IRISModel(nn.Module):
    """Backbone -> ORACLE -> CASTLE -> NEXUS -> projection -> dropout."""

    takes_generator = True  # the train step passes its dropout generator

    def __init__(self, backbone_name: str = "resnet50", outputdim: int = 512,
                 num_classes: int = 81313, dropout: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = compute_dtype(dtype)
        self.backbone = ResNet(backbone_name, dtype=self.dtype)
        self.dropout = dropout
        self.oracle = ORACLE(self.backbone.outputdim, outputdim)
        self.castle = CASTLE(outputdim)
        self.nexus = NEXUS(outputdim)
        self.feature_proj = nn.Linear(outputdim, outputdim)
        self.classifier = nn.Linear(outputdim, num_classes)

    def _features(self, x, valid_hw=None, generator=None):
        fmap = at_least_fp32(self.backbone(x, valid_hw=valid_hw))
        ext = None if valid_hw is None else stage_extents(valid_hw, 5)
        f = self.nexus(self.castle(self.oracle(fmap, ext)))
        return dropout(self.feature_proj(f), self.dropout, self.training,
                       generator)

    @fp32_precision()
    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                train: bool | None = None,
                generator: torch.Generator | None = None):
        """Train forward ``(loss, logits)``; in train mode the dropout
        draws from ``generator``."""
        train_mode(self, train)
        feat = self._features(x, generator=generator)
        logits = self.classifier(feat)
        return iris_loss(logits, feat, labels), logits

    @fp32_precision()
    def extract(self, x: torch.Tensor,
                valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """[B, H, W, 3] images (+ [B, 2] bucket extents) -> [B, D]
        L2-normalized fp32 descriptors."""
        train_mode(self, False)
        return l2_normalize(self._features(x, valid_hw))


register_model(
    "iris_r50",
    description="IRIS ORACLE+CASTLE+NEXUS prototype (reference manus/8 "
                "iris_implementation_corrected.py)",
    defaults=dict(backbone_name="resnet50", outputdim=512),
    family="iris",
)(IRISModel)
