"""ULTRON: local transformer and convolution unified for retrieval
(port of ``research_image_retrieval_tpu/models/ultron.py``).

* ``CDConv``: channel attention ``sigmoid(sum_k w[k, c] GAP[(c + k) %
  C])`` (fp32, over the valid cells of a padded bucket) puts each channel
  at dilation 1, ``delta1`` or ``delta2`` by the thresholds ``tau1`` /
  ``tau2``; the output mixes the three dilated convolutions by the
  fraction of channels at each rate, then BN.  The rate choice is a step
  function of the attention (``dilation_rates``).
* ``SCALAAttention``: Swin-style window attention (windows padded with
  zeros to a multiple of the window and attended with NO key mask over
  those zeros, as in JAX) with a relative position bias, the keys taken
  from the multi-scale context kernel's output (``use_context_keys``).
* ``ULTRON``: a 4x4 patch embedding + LN + absolute position embedding,
  CDConv stages 0-1, SCALA stages 2-3, ``PatchMerging`` between stages;
  ``AttentionBasedGlobalPooling`` (a GeM query attending over the final
  map, ``gamma`` learned); ``ULTRONRetrievalModel`` trains with MadaCos.

Padded buckets (``valid_hw`` [B, 2] true extents, multiples of 32:
``extract_vectors`` snaps them to ``extent_multiple``): the position
embedding is resized per image to its true grid; each stage's pad region
is zeroed before every convolution, the context kernel and the window
partition, so the windows equal the exact-shape run's; the GAP and the
pooling read the valid cells only.

Internally the convolutional parts are NCHW in ``channels_last`` memory
(the bytes of NHWC) and the token parts NHWC; the backbone computes in
``dtype`` (fp32 or bf16, the attention softmax and the CDConv
statistics in fp32); the pooling, the L2 and MadaCos in fp32.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from research_image_retrieval_tpu_torch.models.backbone import (
    BatchNorm,
    Conv2d,
    compute_dtype,
    same_conv,
    train_mode,
)
from research_image_retrieval_tpu_torch.models.layers import Dense, LayerNorm
from research_image_retrieval_tpu_torch.models.registry import register_model
from research_image_retrieval_tpu_torch.models.vit import (
    per_image_grid,
    resize_grid,
)
from research_image_retrieval_tpu_torch.ops.losses import madacos_loss
from research_image_retrieval_tpu_torch.ops.masking import hw_mask
from research_image_retrieval_tpu_torch.ops.norm import (
    at_least_fp32,
    l2_normalize,
)
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["AttentionBasedGlobalPooling", "CDConv", "CDConvBlock",
           "MultiScaleContextKernel", "PatchMerging", "SCALAAttention",
           "SCALABlock", "ULTRON", "ULTRONRetrievalModel", "ULTRON_CONFIGS",
           "dilation_rates", "window_partition", "window_reverse"]

ULTRON_CONFIGS = {
    "s": dict(embed_dims=(64, 128, 320, 512), depths=(3, 5, 9, 5),
              num_heads=(2, 4, 10, 16)),
    "b": dict(embed_dims=(96, 192, 384, 768), depths=(5, 7, 18, 5),
              num_heads=(3, 6, 12, 24)),
    # tiny config for tests
    "t": dict(embed_dims=(16, 32, 48, 64), depths=(1, 1, 1, 1),
              num_heads=(2, 2, 2, 4)),
}


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _masked(x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    """NCHW ``x`` with the cells where ``mask`` [B, H, W] is 0 zeroed."""
    return x if mask is None else x * mask[:, None].to(x.dtype)


def dilation_rates(attn: torch.Tensor, tau1: float, tau2: float):
    """CDConv's per-channel rate masks ``(rate 1, delta1, delta2)`` from
    the channel attention [B, C]: ``delta2`` at or below ``tau2``,
    ``delta1`` in ``(tau2, tau1]``, 1 above ``tau1``."""
    is_d1 = (attn <= tau1) & (attn > tau2)
    is_d2 = attn <= tau2
    return ~(is_d1 | is_d2), is_d1, is_d2


class CDConv(nn.Module):
    """Channel-wise dilated convolution (NCHW in and out)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 stride: int = 1, tau1: float = 0.75, tau2: float = 0.50,
                 delta1: int = 3, delta2: int = 6):
        super().__init__()
        self.tau1, self.tau2 = tau1, tau2
        K = kernel_size
        self.channel_attention_weights = nn.Parameter(torch.zeros(K, in_ch))

        def conv(d):
            return Conv2d(in_ch, features, K, stride=stride,
                          padding=d * (K // 2), dilation=d, bias=False)

        self.conv_d1 = conv(1)
        self.conv_dd1 = conv(delta1)
        self.conv_dd2 = conv(delta2)
        self.bn = BatchNorm(features)

    def reset_flax(self, generator: torch.Generator):
        """JAX's ``normal / sqrt(C)`` for the channel attention weights
        (``training_init``)."""
        with torch.no_grad():
            w = self.channel_attention_weights
            w.copy_(torch.randn(w.shape, generator=generator)
                    / math.sqrt(w.shape[1]))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        x = _masked(x, mask)
        xf = at_least_fp32(x)
        if mask is None:
            gap = xf.mean(dim=(2, 3))
        else:
            m = mask.to(xf.dtype)
            cnt = torch.clamp(m.sum(dim=(1, 2)), min=1.0)[:, None]
            gap = (xf * m[:, None]).sum(dim=(2, 3)) / cnt
        w = self.channel_attention_weights.to(gap.dtype)
        scores = sum(w[k][None, :] * torch.roll(gap, -k, dims=1)
                     for k in range(w.shape[0]))
        attn = torch.sigmoid(scores)
        is_1, is_d1, is_d2 = dilation_rates(attn, self.tau1, self.tau2)
        frac = [r.to(gap.dtype).mean(dim=1)[:, None, None, None]
                for r in (is_1, is_d1, is_d2)]
        total = frac[0] + frac[1] + frac[2] + 1e-8
        out = sum((f / total).to(x.dtype) * conv(x) for f, conv in
                  zip(frac, (self.conv_d1, self.conv_dd1, self.conv_dd2)))
        return self.bn(out)


class CDConvBlock(nn.Module):
    """Residual CDConv block (a projection when the width changes)."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.cdconv1 = CDConv(in_ch, features, stride=stride)
        self.cdconv2 = CDConv(features, features)
        self.project = in_ch != features or stride != 1
        if self.project:
            self.down_conv = Conv2d(in_ch, features, 1, stride=stride,
                                    bias=False)
            self.down_bn = BatchNorm(features)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        y = F.relu(self.cdconv1(x, mask))
        y = self.cdconv2(y, mask)
        idt = self.down_bn(self.down_conv(x)) if self.project else x
        return F.relu(y + idt)


class MultiScaleContextKernel(nn.Module):
    """Three depthwise dilated 3x3s (dilation 1, 2, 3) + a 1x1 fuse + BN
    (NCHW)."""

    def __init__(self, dim: int):
        super().__init__()
        for d in (1, 2, 3):
            self.add_module(f"dc{d}", Conv2d(dim, dim, 3, padding=d,
                                             dilation=d, groups=dim,
                                             bias=False))
        self.fuse = Conv2d(3 * dim, dim, 1, bias=False)
        self.bn = BatchNorm(dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        x = _masked(x, mask)
        outs = [getattr(self, f"dc{d}")(x) for d in (1, 2, 3)]
        return self.bn(self.fuse(torch.cat(outs, dim=1)))


def window_partition(x: torch.Tensor, ws: int):
    """[B, H, W, C] -> ([B*nH*nW, ws*ws, C], padded (H, W)); the pad to a
    multiple of ``ws`` is zeros."""
    B, H, W, C = x.shape
    pad_h, pad_w = (ws - H % ws) % ws, (ws - W % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C), (Hp, Wp)


def window_reverse(windows: torch.Tensor, ws: int, Hp: int, Wp: int,
                   H: int, W: int) -> torch.Tensor:
    """Inverse of ``window_partition``, the padding cropped."""
    C = windows.shape[-1]
    B = windows.shape[0] // ((Hp // ws) * (Wp // ws))
    x = windows.reshape(B, Hp // ws, Wp // ws, ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return x[:, :H, :W, :]


def _relative_position_index(ws: int) -> np.ndarray:
    """[ws*ws, ws*ws] index into the ``(2ws-1)^2`` bias table (Swin)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


class SCALAAttention(nn.Module):
    """Window attention with multi-scale context keys (NHWC in and out)."""

    def __init__(self, dim: int, window_size: int = 7, num_heads: int = 8,
                 qkv_bias: bool = True, use_context_keys: bool = True):
        super().__init__()
        self.dim, self.ws, self.num_heads = dim, window_size, num_heads
        self.use_context_keys = use_context_keys
        self.mck = MultiScaleContextKernel(dim)
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias)
        if use_context_keys:
            self.context_k = Dense(dim, dim, bias=qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            _relative_position_index(window_size).reshape(-1)),
            persistent=False)
        self.proj = Dense(dim, dim)

    def reset_flax(self, generator: torch.Generator):
        """flax's ``truncated_normal(0.02)`` (two-sigma cut of a unit
        normal, times 0.02) for the bias table (``training_init``)."""
        with torch.no_grad():
            nn.init.trunc_normal_(self.relative_position_bias_table, 0.0,
                                  1.0, -2.0, 2.0, generator=generator)
            self.relative_position_bias_table.mul_(0.02)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        B, H, W, C = x.shape
        ws, h = self.ws, self.num_heads
        hd = C // h
        if mask is not None:
            # zeroing the pad region reproduces the exact-shape run's
            # zero-padded windows (tokens and context)
            x = x * mask[..., None].to(x.dtype)
        context = _nhwc(self.mck(_nchw(x), mask))
        if mask is not None:
            context = context * mask[..., None].to(context.dtype)
        xw, (Hp, Wp) = window_partition(x, ws)
        cw, _ = window_partition(context, ws)
        N = ws * ws
        qkv = self.qkv(xw).reshape(-1, N, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        if self.use_context_keys:  # paper eq (5)
            k = self.context_k(cw).reshape(-1, N, h, hd).transpose(1, 2)
        attn = at_least_fp32(torch.matmul(q * (hd ** -0.5),
                                          k.transpose(-1, -2)))
        bias = self.relative_position_bias_table[
            self.relative_position_index].reshape(N, N, h).permute(2, 0, 1)
        attn = torch.softmax(attn + bias.to(attn.dtype)[None], dim=-1)
        out = torch.matmul(attn.to(v.dtype), v)
        out = self.proj(out.transpose(1, 2).reshape(-1, N, C))
        return window_reverse(out, ws, Hp, Wp, H, W)


class SCALABlock(nn.Module):
    """BN + SCALA attention and BN + 1x1 conv MLP (exact GELU), both
    residual (NCHW in and out)."""

    def __init__(self, dim: int, window_size: int = 7, num_heads: int = 8,
                 mlp_ratio: float = 4.0, use_context_keys: bool = True):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.norm1 = BatchNorm(dim)
        self.attn = SCALAAttention(dim, window_size, num_heads,
                                   use_context_keys=use_context_keys)
        self.norm2 = BatchNorm(dim)
        self.mlp_fc1 = Conv2d(dim, hidden, 1)
        self.mlp_fc2 = Conv2d(hidden, dim, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        x = x + _nchw(self.attn(_nhwc(self.norm1(x)), mask))
        y = F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none")
        return x + self.mlp_fc2(y)


class PatchMerging(nn.Module):
    """2x2 merge (concat order [0::2, 0::2], [1::2, 0::2], [0::2, 1::2],
    [1::2, 1::2]) + LN + a linear reduction to ``out_dim`` (NHWC)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * in_dim)
        self.reduction = Dense(4 * in_dim, out_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class AttentionBasedGlobalPooling(nn.Module):
    """GeM-query attention pooling (eqs 9-12) of an NHWC fp32 map; L2
    out.  ``gamma`` is learned, clipped to [1e-7, 100]."""

    def __init__(self, dim: int, gamma: float = 2.0, alpha: float = 2.0):
        super().__init__()
        self.dim, self.alpha = dim, alpha
        self.gamma = nn.Parameter(torch.tensor(gamma, dtype=torch.float32))
        self.query_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None):
        B, H, W, C = x.shape
        g = torch.clamp(self.gamma, 1e-7, 100.0)
        xg = torch.clamp(x, min=1e-7) ** g
        if mask is None:
            dq = xg.mean(dim=(1, 2)) ** (1.0 / g)
        else:
            cnt = torch.clamp(mask.sum(dim=(1, 2)), min=1.0)[:, None]
            dq = ((xg * mask[..., None]).sum(dim=(1, 2)) / cnt) ** (1.0 / g)
        dq = self.query_proj(dq)
        tokens = x.reshape(B, H * W, C)
        scores = torch.einsum("bnc,bc->bn", tokens, dq) / float(
            np.sqrt(self.dim))
        if mask is not None:
            scores = torch.where(mask.reshape(B, H * W) > 0, scores, -1e30)
        weighted = torch.einsum("bn,bnc->bc", torch.softmax(scores, dim=-1),
                                tokens)
        out = weighted ** self.alpha if self.alpha != 1.0 \
            else torch.exp(weighted)
        return l2_normalize(out)


class ULTRON(nn.Module):
    """The 4-stage hybrid backbone: NHWC images in, the last stage's
    [B, H/32, W/32, C] map out (in ``dtype``).  ``num_stages`` runs only
    the first stages."""

    def __init__(self, embed_dims=(64, 128, 320, 512), depths=(3, 5, 9, 5),
                 num_heads=(2, 4, 10, 16), patch_size: int = 4,
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 img_size: int = 224, use_context_keys: bool = True,
                 dtype=torch.float32, num_stages: int | None = None):
        super().__init__()
        self.embed_dims, self.depths = tuple(embed_dims), tuple(depths)
        self.patch_size, self.img_size = patch_size, img_size
        self.dtype = compute_dtype(dtype)
        self.num_stages = len(self.depths) if num_stages is None \
            else num_stages
        e0 = self.embed_dims[0]
        self.patch_embed = Conv2d(3, e0, patch_size, stride=patch_size)
        self.patch_norm = LayerNorm(e0)
        pr = img_size // patch_size
        self.absolute_pos_embed = nn.Parameter(torch.zeros(1, pr, pr, e0))
        prev = e0
        for i, (dim, depth, heads) in enumerate(zip(
                self.embed_dims, self.depths, num_heads)):
            if i >= self.num_stages:
                break
            if i > 0:
                self.add_module(f"merge{i}", PatchMerging(prev, dim))
            for j in range(depth):
                block = (CDConvBlock(dim, dim) if i < 2 else
                         SCALABlock(dim, window_size, heads, mlp_ratio,
                                    use_context_keys=use_context_keys))
                self.add_module(f"stage{i}_block{j}", block)
            prev = dim
        self.to(memory_format=torch.channels_last)

    def reset_flax(self, generator: torch.Generator):
        """flax's ``truncated_normal(0.02)`` for the absolute position
        embedding (``training_init``)."""
        with torch.no_grad():
            nn.init.trunc_normal_(self.absolute_pos_embed, 0.0, 1.0, -2.0,
                                  2.0, generator=generator)
            self.absolute_pos_embed.mul_(0.02)

    @fp32_precision()
    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor | None = None):
        """x: [B, H, W, 3] (zero-padded bottom/right when ``valid_hw``
        [B, 2] is given; extents and canvas multiples of 32)."""
        y = x.to(self.dtype) if self.dtype == torch.bfloat16 else x
        y = self.patch_norm(same_conv(self.patch_embed, y))
        gh, gw = y.shape[1], y.shape[2]
        pos = self.absolute_pos_embed[0]
        ext = None
        if valid_hw is not None:
            ext = torch.div(valid_hw, self.patch_size, rounding_mode="floor")
            pos = per_image_grid(pos, gh, gw, ext)
        elif (gh, gw) != tuple(pos.shape[:2]):
            pos = resize_grid(pos, gh, gw)
        y = _nchw(y + pos.to(y.dtype)).contiguous(
            memory_format=torch.channels_last)
        for i in range(self.num_stages):
            if i > 0:
                y = _nchw(getattr(self, f"merge{i}")(_nhwc(y)))
                if ext is not None:
                    # the 32-multiple contract keeps each extent even
                    ext = torch.div(ext, 2, rounding_mode="floor")
            mask = None if ext is None else hw_mask(y.shape[2], y.shape[3],
                                                    ext)
            for j in range(self.depths[i]):
                y = getattr(self, f"stage{i}_block{j}")(y, mask)
        return _nhwc(y)


class ULTRONRetrievalModel(nn.Module):
    """ULTRON + attention GeM pooling + MadaCos (``variant`` s / b / t)."""

    def __init__(self, num_classes: int = 81313, variant: str = "s",
                 img_size: int = 224, window_size: int = 7,
                 rho: float = 0.04, use_context_keys: bool = True,
                 dtype=torch.float32):
        super().__init__()
        cfg = ULTRON_CONFIGS[variant]
        self.rho = rho
        self.dtype = compute_dtype(dtype)
        self.backbone = ULTRON(img_size=img_size, window_size=window_size,
                               use_context_keys=use_context_keys,
                               dtype=self.dtype, **cfg)
        self.embed_dim = cfg["embed_dims"][-1]
        self.global_pool = AttentionBasedGlobalPooling(self.embed_dim)
        self.classifier_w = nn.Parameter(torch.empty(num_classes,
                                                     self.embed_dim))
        nn.init.xavier_uniform_(self.classifier_w)

    @property
    def extent_multiple(self) -> int:
        """32: the 4x4 patch embedding and three 2x merges."""
        return 32

    def _descriptor(self, x, valid_hw=None):
        fmap = at_least_fp32(self.backbone(x, valid_hw=valid_hw))
        mask = None
        if valid_hw is not None:
            mask = hw_mask(fmap.shape[1], fmap.shape[2],
                           torch.div(valid_hw, 32, rounding_mode="floor"),
                           dtype=fmap.dtype)
        return self.global_pool(fmap, mask)

    @fp32_precision()
    def forward(self, x: torch.Tensor, labels: torch.Tensor,
                train: bool | None = None):
        """``(loss, logits)``: MadaCos, with the margin fixed at 0 in eval
        mode."""
        train = train_mode(self, train)
        feat = self._descriptor(x)
        loss, aux = madacos_loss(feat, self.classifier_w, labels,
                                 rho=self.rho,
                                 fixed_margin=None if train else 0.0)
        return loss, aux["logits"]

    @fp32_precision()
    def extract(self, x: torch.Tensor,
                valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """[B, H, W, 3] (+ [B, 2] extents, multiples of 32) -> [B, C]
        L2-normalized fp32 descriptors."""
        train_mode(self, False)
        return l2_normalize(self._descriptor(x, valid_hw))


register_model(
    "ultron_s",
    description="ULTRON-S hybrid CDConv+SCALA with MadaCos (reference "
                "models/ultron_modules/ultron.py:246)",
    defaults=dict(variant="s"),
    family="ultron",
    paper="ULTRON: Unifying Local Transformer and Convolution",
    table1_names=("ULTRON-S",),
)(ULTRONRetrievalModel)

register_model(
    "ultron_b",
    description="ULTRON-B (larger config)",
    defaults=dict(variant="b"),
    family="ultron",
    table1_names=("ULTRON-B",),
)(ULTRONRetrievalModel)
