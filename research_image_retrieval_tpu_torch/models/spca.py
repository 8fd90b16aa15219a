"""SpCa: spatial-context aggregation, the reference repo's main method
(port of ``research_image_retrieval_tpu/models/spca.py``).

* ``SpcaLayer`` — a GMM-style codebook (``clusters`` [1, K, local_dim],
  ``pi`` and ``cov`` [1, K]) soft-assigns the 1x1-projected layer4
  tokens: ``log(pi / sqrt(cov)) - ||x - LN(template)||^2 / (2 cov)``,
  softmax over K; the assignment (+1e-8), L1-normalized over the valid
  tokens, is contracted with the distance-encoding matrix powers into K
  spatial-context channels per token, LayerNorm'd (``p_norm``).
* Distance encoding: pairwise coordinate distances ->
  ``exp(-sqrt(d))`` -> normalized by COLUMN sums -> powers ``A^2 ..
  A^(multi+1)``; on padded buckets per image over its valid tokens.
* Fusers (``combine``): cross-attention (``cro`` / ``fur``), concat-MLP
  (``cat``), Hadamard outer product (``had``), orthogonal (``orth``,
  pooled to a vector), decoder (``dec``).
* Descriptor: GeM (p = 3) of the fused map -> ``whiten`` (Linear) -> L2;
  ``orth`` whitens its vector directly.  Training logits are ArcFace
  (the margin only in training) over ``classifier_w``.

``extract`` runs GeM -> whiten -> L2 of the fused map through
``ops/gem_head.gem_whiten_l2`` (the hand-written head kernel on CUDA,
its plain version on the CPU), the whiten weight read in fp32, as
``DELGModel.extract`` does.  The backbone runs in ``dtype`` (its identity
blocks on the bottleneck kernel in eval mode); the head runs in fp32, as
flax promotes a bf16 map against its fp32 parameters.  Every matmul runs
with TF32 off.  The attention logits are ``[B, 8, N, N]`` and the masked
distance matrices ``[B, N, N]`` fp32 (N layer4 cells).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn

from research_image_retrieval_tpu_torch.models.backbone import (
    ResNet,
    compute_dtype,
    nchw_conv,
    stage_extents,
    train_mode,
)
from research_image_retrieval_tpu_torch.models.layers import (
    Attention,
    LayerNorm,
    Mlp,
)
from research_image_retrieval_tpu_torch.models.registry import register_model
from research_image_retrieval_tpu_torch.ops.gem_head import gem_whiten_l2
from research_image_retrieval_tpu_torch.ops.losses import (
    arcface_logits,
    cross_entropy,
)
from research_image_retrieval_tpu_torch.ops.masking import token_mask
from research_image_retrieval_tpu_torch.ops.norm import (
    at_least_fp32,
    l2_normalize,
)
from research_image_retrieval_tpu_torch.ops.pooling import (
    avg_pool_all,
    gem_pool,
)
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["SpCaModel", "SpcaLayer", "distance_encoding_masks",
           "masked_distance_encoding_masks"]


@functools.lru_cache(maxsize=32)
def _coord_distance(H: int, W: int) -> np.ndarray:
    """Pairwise squared coordinate distances [HW, HW], numpy float32 as
    ``sq + inner + sq.T`` (the JAX package's formula and rounding; its
    ``sqrt(|d2|)`` downstream sees these values)."""
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    coord = np.stack([yy.ravel(), xx.ravel()], axis=1).astype(np.float32)
    inner = -2.0 * coord @ coord.T
    sq = np.sum(coord * coord, axis=1, keepdims=True)
    return sq + inner + sq.T


def _affinity(H: int, W: int, device, dtype=torch.float32) -> torch.Tensor:
    """``exp(-sqrt(|d2|))`` in ``dtype`` (``d2`` holds small integers,
    exact in float32)."""
    d2 = torch.from_numpy(_coord_distance(H, W)).to(device, dtype)
    return torch.exp(-torch.sqrt(torch.abs(d2)))


def _powers(A: torch.Tensor, multi: int) -> list:
    out = [torch.matmul(A, A)]
    for _ in range(multi - 1):
        out.append(torch.matmul(out[-1], A))
    return out


@fp32_precision()
def distance_encoding_masks(H: int, W: int, multi: int, device,
                            dtype=torch.float32):
    """[A^2 .. A^(multi+1)], each [HW, HW] on ``device`` in ``dtype``, one
    for the whole batch; A is normalized by column sums (the reference
    sums over dim 1 of [B, HW, HW]; row sums would give the transpose)."""
    e = _affinity(H, W, device, dtype)
    return _powers(e / e.sum(dim=0, keepdim=True), multi)


@fp32_precision()
def masked_distance_encoding_masks(H: int, W: int, multi: int,
                                   tmask: torch.Tensor, dtype=torch.float32):
    """Per-image powers over the valid tokens of ``tmask`` [B, HW]: pad
    rows and columns are zeroed before the column normalization, so the
    valid block equals ``distance_encoding_masks`` of the image's own
    grid.  Returns ``multi`` [B, HW, HW] matrices in ``dtype``."""
    e = _affinity(H, W, tmask.device, dtype)
    tm = tmask.to(dtype)
    e_b = e[None] * tm[:, :, None] * tm[:, None, :]
    col = e_b.sum(dim=1, keepdim=True)  # [B, 1, N] valid-row sums
    A = torch.where(col > 0.0, e_b / torch.clamp(col, min=1e-30), 0.0)
    return _powers(A, multi)


class SpcaLayer(nn.Module):
    """GMM soft assignment + spatial-context features of an NHWC map."""

    def __init__(self, in_dim: int, K: int = 16, local_dim: int = 128,
                 multi: int = 1):
        super().__init__()
        self.K, self.local_dim, self.multi = K, local_dim, multi
        self.proj_kv = nn.Conv2d(in_dim, local_dim, 1, bias=False)
        self.clusters = nn.Parameter(torch.empty(1, K, local_dim))
        self.pi = nn.Parameter(torch.full((1, K), 1.0 / K))
        self.cov = nn.Parameter(torch.ones(1, K))
        self.norm_templates = LayerNorm(local_dim)
        self.p_norm = LayerNorm(K * multi)
        self.reset_flax(None)

    @torch.no_grad()
    def reset_flax(self, generator: torch.Generator | None):
        """The JAX initializers: ``clusters`` xavier-uniform with flax's
        fans for [1, K, D] (fan_in K, fan_out D), ``pi = 1/K``,
        ``cov = 1``."""
        bound = (6.0 / (self.K + self.local_dim)) ** 0.5
        self.clusters.uniform_(-bound, bound, generator=generator)
        self.pi.fill_(1.0 / self.K)
        self.cov.fill_(1.0)

    def forward(self, g_fea: torch.Tensor, tmask=None):
        """g_fea [B, H, W, C] -> (outp [B, H, W, K*multi], attention map
        [B, H, W, K]); ``tmask`` [B, HW] drops pad tokens."""
        B, H, W, _ = g_fea.shape
        x = nchw_conv(self.proj_kv, g_fea).reshape(B, H * W, self.local_dim)
        templates = self.norm_templates(self.clusters)  # [1, K, D]
        sq = ((x * x).sum(-1, keepdim=True)
              - 2.0 * torch.einsum("bnd,okd->bnk", x, templates)
              + (templates * templates).sum(-1))
        logits = (torch.log(self.pi / torch.sqrt(self.cov))[:, None, :]
                  - sq / self.cov[:, None, :] / 2.0)
        attn = torch.softmax(logits, dim=-1)  # [B, HW, K]
        attn_ = attn + 1e-8
        if tmask is not None:
            attn_ = attn_ * tmask[:, :, None]
        attn_ = attn_ / attn_.sum(dim=-2, keepdim=True)  # L1 over HW
        # the masks in the head's dtype, at least fp32 (JAX: fp32 always;
        # a float64 model's then round the same on every device)
        dt = torch.promote_types(attn_.dtype, torch.float32)
        if tmask is None:
            parts = [torch.einsum("bnk,nm->bkm", attn_, m.to(attn_.dtype))
                     for m in distance_encoding_masks(H, W, self.multi,
                                                      g_fea.device, dt)]
        else:
            parts = [torch.einsum("bnk,bnm->bkm", attn_, m.to(attn_.dtype))
                     for m in masked_distance_encoding_masks(
                         H, W, self.multi, tmask, dt)]
        outp = self.p_norm(torch.cat(parts, dim=1).transpose(1, 2))
        return (outp.reshape(B, H, W, self.K * self.multi),
                attn.reshape(B, H, W, self.K))


class CrossAttnFuser(nn.Module):
    """'cro' / 'fur': LN -> cross-attention to the projected context ->
    MLP, both residual.  Output [B, H, W, C] (C = dim)."""

    def __init__(self, dim: int, inputdim: int, in_dim: int):
        super().__init__()
        self.out_dim = in_dim
        self.ln = LayerNorm(in_dim)
        self.proj = nn.Linear(inputdim, dim)
        self.cross_attn = Attention(dim, 8, qkv_bias=True, q_dim=in_dim)
        self.mlp = Mlp(dim, 2 * dim, dim)

    def forward(self, q_map, x_map, tmask=None):
        B, H, W, C = q_map.shape
        q = q_map.reshape(B, H * W, C)
        x = self.proj(x_map.reshape(B, H * W, x_map.shape[-1]))
        q = q + self.cross_attn(self.ln(q), x, x, key_mask=tmask)
        q = q + self.mlp(q)
        return q.reshape(B, H, W, C)


class ConcatFuser(nn.Module):
    """'cat': [LN(q), LN(proj(x))] + MLP.  Output 2C channels."""

    def __init__(self, dim: int, inputdim: int, in_dim: int):
        super().__init__()
        self.out_dim = 2 * in_dim
        self.bn1 = LayerNorm(in_dim)
        self.proj = nn.Linear(inputdim, dim)
        self.bn2 = LayerNorm(dim)
        self.mlp = Mlp(in_dim + dim, 4 * dim, 2 * dim)

    def forward(self, q_map, x_map, tmask=None):
        B, H, W, C = q_map.shape
        q = self.bn1(q_map.reshape(B, H * W, C))
        x = self.bn2(self.proj(x_map.reshape(B, H * W, x_map.shape[-1])))
        qx = torch.cat([q, x], dim=2)
        qx = qx + self.mlp(qx)
        return qx.reshape(B, H, W, 2 * C)  # per-token: no mask needed


class HadamardFuser(nn.Module):
    """'had': per-token outer product of LN(proj(q)) [dim/4] and LN(x)
    [inputdim].  Output (dim/4) * inputdim channels."""

    def __init__(self, dim: int, inputdim: int, in_dim: int):
        super().__init__()
        self.out_dim = (dim // 4) * inputdim
        self.proj = nn.Linear(in_dim, dim // 4)
        self.bn1 = LayerNorm(dim // 4)
        self.bn2 = LayerNorm(inputdim)

    def forward(self, q_map, x_map, tmask=None):
        B, H, W, C = q_map.shape
        q = self.bn1(self.proj(q_map.reshape(B, H * W, C)))
        x = self.bn2(x_map.reshape(B, H * W, x_map.shape[-1]))
        out = torch.einsum("bnc,bnd->bncd", q, x)
        return out.reshape(B, H, W, -1)  # per-token: no mask needed


class OrthogonalFuser(nn.Module):
    """'orth': [fg, mean(fl - proj_fg(fl))], a pooled [B, dim] VECTOR
    (fg = fc_t(GeM(g)), fl = fc(x))."""

    def __init__(self, dim: int, inputdim: int, in_dim: int):
        super().__init__()
        self.out_dim = dim
        self.fc_t = nn.Linear(in_dim, dim // 2)
        self.fc = nn.Conv2d(inputdim, dim // 2, 1)

    def forward(self, g_map, l_map, tmask=None):
        mask = (None if tmask is None
                else tmask.reshape(g_map.shape[0], g_map.shape[1],
                                   g_map.shape[2]))
        fg = self.fc_t(gem_pool(g_map, p=3.0, valid_hw=mask))  # [B, dim/2]
        fl = nchw_conv(self.fc, l_map)  # [B, H, W, dim/2]
        fg_sq = (fg * fg).sum(dim=-1, keepdim=True)
        coef = torch.einsum("bhwc,bc->bhw", fl, fg)
        proj = coef[..., None] * fg[:, None, None, :] / fg_sq[:, None, None, :]
        fo = avg_pool_all(fl - proj, valid_hw=mask)
        return torch.cat([fg, fo], dim=-1)


class DecoderFuser(nn.Module):
    """'dec': the decoder block over the projected context (its
    self-attention masks pad keys too)."""

    def __init__(self, dim: int, inputdim: int, in_dim: int):
        super().__init__()
        self.out_dim = in_dim
        self.proj_fc = nn.Linear(inputdim, dim)
        self.proj_ln = LayerNorm(dim)
        self.cross_attn = Attention(dim, 8, qkv_bias=True, q_dim=in_dim)
        self.self_attn = Attention(dim, 8, qkv_bias=True)
        self.mlp = Mlp(dim, 2 * dim, dim)
        self.bn1 = LayerNorm(in_dim)
        self.bn2 = LayerNorm(dim)

    def forward(self, q_map, x_map, tmask=None):
        B, H, W, C = q_map.shape
        q = q_map.reshape(B, H * W, C)
        x = self.proj_ln(self.proj_fc(x_map.reshape(B, H * W,
                                                    x_map.shape[-1])))
        q = q + self.cross_attn(self.bn1(q), x, x, key_mask=tmask)
        q = q + self.mlp(q)
        q_bn = self.bn2(q)
        q = q + self.self_attn(q_bn, q_bn, q_bn, key_mask=tmask)
        return q.reshape(B, H, W, C)


_FUSERS = {
    "cro": CrossAttnFuser,
    "fur": CrossAttnFuser,  # the reference's Fuser_ has Fuser's layers
    "cat": ConcatFuser,
    "had": HadamardFuser,
    "orth": OrthogonalFuser,
    "dec": DecoderFuser,
}


class SpCaModel(nn.Module):
    """Backbone + SpcaLayer + fuser + GeM + whiten (+ ArcFace)."""

    def __init__(self, backbone_name: str = "resnet101",
                 outputdim: int = 2048, num_classes: int = 81313,
                 K: int = 16, local_dim: int = 128, multi: int = 1,
                 combine: str = "cro", s: float = 45.0, m: float = 0.2,
                 mediumdim: int = 2048, dtype=torch.float32):
        super().__init__()
        key = "orth" if combine.startswith("orth") else combine[:3]
        if key not in _FUSERS:
            raise ValueError(f"Unseen fusion scheme: {combine}")
        self.dtype = compute_dtype(dtype)
        self.combine, self.s, self.m = combine, s, m
        self.backbone = ResNet(backbone_name, dtype=self.dtype)
        C = self.backbone.outputdim
        self.pos_branch = SpcaLayer(C, K=K, local_dim=local_dim, multi=multi)
        self.fuser = _FUSERS[key](dim=mediumdim, inputdim=K * multi, in_dim=C)
        self.whiten = nn.Linear(self.fuser.out_dim, outputdim)
        self.classifier_w = nn.Parameter(torch.empty(num_classes, outputdim))
        nn.init.xavier_uniform_(self.classifier_w)

    def _fused(self, x, valid_hw=None):
        """(the fused map [B, H, W, D] or, for ``orth``, the pooled
        vector [B, D]; the layer4 extents or None)."""
        g_fea = at_least_fp32(self.backbone(x, valid_hw=valid_hw))
        ext = tmask = None
        if valid_hw is not None:
            ext = stage_extents(valid_hw, 5)
            tmask = token_mask(g_fea.shape[1], g_fea.shape[2], ext)
        p_fea, _ = self.pos_branch(g_fea, tmask=tmask)
        return self.fuser(g_fea, p_fea, tmask=tmask), ext

    def _descriptor(self, x):
        fused, _ = self._fused(x)
        if self.combine.startswith("orth"):
            return self.whiten(fused)  # the fuser pooled to a vector
        return self.whiten(gem_pool(fused, p=3.0))

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
        """[B, H, W, 3] images (+ [B, 2] bucket extents) -> [B, D]
        L2-normalized fp32 descriptors, through the GeM head (but
        ``orth``)."""
        train_mode(self, False)
        fused, ext = self._fused(x, valid_hw)
        if self.combine.startswith("orth"):
            return l2_normalize(self.whiten(fused))
        return gem_whiten_l2(fused.contiguous(), self.whiten.weight,
                             self.whiten.bias, p=3.0, extents=ext,
                             weight_dtype=torch.float32)


register_model(
    "spca_r101",
    description="SpCa spatial-context aggregation over ResNet101 "
                "(reference networks/spca.py:18)",
    defaults=dict(backbone_name="resnet101", outputdim=2048, K=16,
                  local_dim=128, multi=1, combine="cro"),
    family="spca",
    paper="SpCa (the reference repo's primary method)",
    table1_names=("R101-SpCa",),
)(SpCaModel)

register_model(
    "spca_r50",
    description="SpCa over ResNet50",
    defaults=dict(backbone_name="resnet50", outputdim=2048, K=16,
                  local_dim=128, multi=1, combine="cro"),
    family="spca",
)(SpCaModel)
