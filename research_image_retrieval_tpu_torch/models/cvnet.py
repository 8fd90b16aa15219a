"""CVNet reranker: cross-scale 4D correlation verification
(port of ``research_image_retrieval_tpu/models/cvnet.py``).

* ``CenterPivotConv4d``: a 4D convolution over (query H x W, key H x W)
  as two 2D convolutions, summed: branch 1 subsamples the key dims by
  the key stride and convolves each query plane (no bias); branch 2
  convolves each key plane (with bias) at the query positions the query
  stride keeps (JAX convolves every query position and then subsamples:
  the same numbers, a quarter of the work at stride 2).  Both use
  flax's ``SAME`` padding, which at stride 2 pads asymmetrically
  (``_same_conv``); ``nn.Conv2d(padding=k // 2)`` would shift the grid.
* ``GroupNorm``: flax's ``nn.GroupNorm`` (eps 1e-6, ``E[x^2] - E[x]^2``)
  of a channels-last tensor over every spatial axis and the group's
  channels.
* ``CVLearner``: four stacks of ``CenterPivotConv4d`` + ``GroupNorm`` +
  ReLU with progressive strides, the mean over the four spatial axes, a
  two-layer MLP to 2 logits.
* ``CVNetRerank``: a ResNet encoder whose layer3 map (stage 4) is the
  feature map; ``build_correlation`` resizes it to scales 0.25 / 0.5 /
  1 (bilinear, antialiased, as ``jax.image.resize`` downscales),
  compresses each by its 3x3 ``compress{i}``, L2-normalizes the
  channels, and stacks the 9 clamped cosine volumes (query scale outer,
  key scale inner), each upscaled to the scale-1 geometry by a
  separable half-pixel bilinear resize over (Hq, Wq) and then (Hk, Wk);
  the match score is ``softmax(CVLearner(corr))[:, 1]``.

Every convolution, product and resize runs in fp32 with TF32 off.  The
encoder's identity blocks run the bottleneck kernel in eval mode (all
of it: the feature map tap is layer3, but layer4 runs, as in JAX).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from research_image_retrieval_tpu_torch.models.backbone import (
    ResNet,
    nchw_conv,
    same_conv,
    stage_extents,
    train_mode,
)
from research_image_retrieval_tpu_torch.ops.masking import hw_mask
from research_image_retrieval_tpu_torch.ops.norm import l2_normalize
from research_image_retrieval_tpu_torch.ops.pooling import gem_pool
from research_image_retrieval_tpu_torch.ops.resize import dense_resize_weights
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["CVLearner", "CVNetRerank", "CenterPivotConv4d", "GroupNorm"]


class CenterPivotConv4d(nn.Module):
    """4D conv of [B, ha, wa, hb, wb, C] as two pivoted 2D convs."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 query_stride: int = 1, key_stride: int = 1):
        super().__init__()
        self.features = features
        self.qs, self.ks = query_stride, key_stride
        self.conv_query = nn.Conv2d(in_ch, features, kernel,
                                    stride=query_stride, bias=False)
        self.conv_key = nn.Conv2d(in_ch, features, kernel, stride=key_stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, ha, wa, hb, wb, C = x.shape
        qs, ks, f = self.qs, self.ks, self.features
        # branch 1: key dims subsampled, each query plane convolved
        x1 = x[:, :, :, ::ks, ::ks]
        hb2, wb2 = x1.shape[3], x1.shape[4]
        x1 = x1.permute(0, 3, 4, 1, 2, 5).reshape(B * hb2 * wb2, ha, wa, C)
        o1 = same_conv(self.conv_query, x1)
        ha2, wa2 = o1.shape[1], o1.shape[2]
        o1 = o1.reshape(B, hb2, wb2, ha2, wa2, f).permute(0, 3, 4, 1, 2, 5)
        # branch 2: each kept query position's key plane convolved
        x2 = x[:, ::qs, ::qs].reshape(B * ha2 * wa2, hb, wb, C)
        o2 = same_conv(self.conv_key, x2)
        o2 = o2.reshape(B, ha2, wa2, o2.shape[1], o2.shape[2], f)
        return o1 + o2


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups)`` of a [B, ..., C] tensor."""

    def __init__(self, channels: int, num_groups: int = 4, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def reset_flax(self, generator: torch.Generator):
        """flax's scale 1, bias 0 (``training_init``)."""
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, G = x.shape[0], x.shape[-1], self.num_groups
        g = x.reshape(B, -1, G, C // G)
        mean = g.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((g * g).mean(dim=(1, 3), keepdim=True)
                          - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.view(G, C // G)
        y = (g - mean) * mul + self.bias.view(G, C // G)
        return y.reshape(x.shape)


# (features, kernel, query stride, key stride) of each block's convs
_CV_BLOCKS = (((16, 5, 2, 2),),
              ((16, 3, 1, 1), (32, 3, 2, 2)),
              ((32, 3, 1, 1), (32, 3, 1, 1), (64, 3, 2, 2)),
              ((64, 3, 1, 1), (64, 3, 1, 1), (128, 3, 1, 1)))


class CVLearner(nn.Module):
    """4-stage 4D-conv encoder -> 2-way match logits."""

    def __init__(self, in_channels: int = 9, groups: int = 4):
        super().__init__()
        c = in_channels
        for b, specs in enumerate(_CV_BLOCKS, start=1):
            for i, (out, k, qs, ks) in enumerate(specs):
                self.add_module(f"block{b}_conv{i}",
                                CenterPivotConv4d(c, out, k, qs, ks))
                self.add_module(f"block{b}_gn{i}", GroupNorm(out, groups))
                c = out
        self.mlp_fc1 = nn.Linear(c, c)
        self.mlp_fc2 = nn.Linear(c, 2)

    @fp32_precision()
    def forward(self, corr: torch.Tensor) -> torch.Tensor:
        """[B, Hq, Wq, Hk, Wk, in_channels] -> [B, 2] logits."""
        x = corr
        for b, specs in enumerate(_CV_BLOCKS, start=1):
            for i in range(len(specs)):
                x = getattr(self, f"block{b}_conv{i}")(x)
                x = F.relu(getattr(self, f"block{b}_gn{i}")(x))
        pooled = x.mean(dim=(1, 2, 3, 4))
        return self.mlp_fc2(F.relu(self.mlp_fc1(pooled)))


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] half-pixel bilinear weights (antialiased when
    downscaling), as ``jax.image.resize(..., "bilinear")``."""
    t = lambda n: torch.tensor([n], device=device)  # noqa: E731
    return dense_resize_weights(t(n_in), t(n_out), n_in, n_out)[0]


def _bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``jax.image.resize(x, (N, out_h, out_w, M), "bilinear")`` of an
    [N, h, w, M] tensor: each axis whose size changes, by a product with
    its weights (fp32)."""
    if x.shape[1] != out_h:
        x = torch.einsum("oh,nhwm->nowm",
                         _resize_weights(x.shape[1], out_h, x.device)
                         .to(x.dtype), x)
    if x.shape[2] != out_w:
        x = torch.einsum("pw,nowm->nopm",
                         _resize_weights(x.shape[2], out_w, x.device)
                         .to(x.dtype), x)
    return x


class CVNetRerank(nn.Module):
    """Pairwise correlation-verification reranker (not a registry model:
    ``evaluation/driver`` builds it for ``--cvnet-rerank``)."""

    def __init__(self, backbone_name: str = "resnet50",
                 reduction_dim: int = 256, scales=(0.25, 0.5, 1.0)):
        super().__init__()
        self.scales = tuple(scales)
        self.encoder = ResNet(backbone_name, out_stages=(4, 5))
        for i in range(len(self.scales)):
            self.add_module(f"compress{i}", nn.Conv2d(
                self.encoder.outputdim_block4, reduction_dim, 3, padding=1,
                bias=False))
        self.cv_learner = CVLearner(in_channels=len(self.scales) ** 2)
        self.to(memory_format=torch.channels_last)

    @fp32_precision()
    def extract_featuremap(self, img: torch.Tensor) -> torch.Tensor:
        """[B, S, S, 3] images -> the [B, h, w, C] layer3 map (stage 4)."""
        train_mode(self, False)
        return self.encoder(img)[4]

    def _pyramid(self, fmap: torch.Tensor) -> list:
        """Per-scale compressed, channel-normalized NHWC maps."""
        _, H, W, _ = fmap.shape
        outs = []
        for i, s in enumerate(self.scales):
            scaled = fmap if s == 1.0 else _bilinear_resize(
                fmap, max(int(H * s), 1), max(int(W * s), 1))
            outs.append(l2_normalize(
                nchw_conv(getattr(self, f"compress{i}"), scaled)))
        return outs

    @fp32_precision()
    def build_correlation(self, q_fmap: torch.Tensor,
                          k_fmap: torch.Tensor) -> torch.Tensor:
        """Cross-scale cosine correlation volume [B, Hq, Wq, Hk, Wk,
        S*S]."""
        qs, ks = self._pyramid(q_fmap), self._pyramid(k_fmap)
        B = q_fmap.shape[0]
        Hq, Wq = qs[-1].shape[1:3]  # the scale-1 geometry
        Hk, Wk = ks[-1].shape[1:3]
        vols = []
        for q in qs:
            for k in ks:
                hq, wq, hk, wk = q.shape[1], q.shape[2], k.shape[1], \
                    k.shape[2]
                corr = torch.bmm(q.reshape(B, hq * wq, -1),
                                 k.reshape(B, hk * wk, -1).transpose(1, 2))
                corr = torch.clamp(corr, min=0.0)  # clamp negatives (HSNet)
                corr = _bilinear_resize(corr.reshape(B, hq, wq, hk * wk),
                                       Hq, Wq)
                corr = _bilinear_resize(
                    corr.reshape(B * Hq * Wq, hk, wk, 1), Hk, Wk)
                vols.append(corr.reshape(B, Hq, Wq, Hk, Wk))
        return torch.stack(vols, dim=-1)

    @fp32_precision()
    def score_from_featuremaps(self, q_fmap: torch.Tensor,
                               k_fmap: torch.Tensor) -> torch.Tensor:
        """[B] match scores in [0, 1] of (query, key) feature maps."""
        logits = self.cv_learner(self.build_correlation(q_fmap, k_fmap))
        return torch.softmax(logits, dim=-1)[:, 1]

    def forward(self, query_img: torch.Tensor,
                key_img: torch.Tensor) -> torch.Tensor:
        """[B] match scores of (query, key) image pairs."""
        return self.score_from_featuremaps(self.extract_featuremap(query_img),
                                           self.extract_featuremap(key_img))

    @fp32_precision()
    def extract(self, img: torch.Tensor,
                valid_hw: torch.Tensor | None = None) -> torch.Tensor:
        """Global descriptor of the encoder: GeM (p = 3) of layer4,
        L2-normalized; ``valid_hw`` [B, 2] extents for buckets."""
        train_mode(self, False)
        f5 = self.encoder(img, valid_hw=valid_hw)[5]
        mask = None
        if valid_hw is not None:
            mask = hw_mask(f5.shape[1], f5.shape[2],
                           stage_extents(valid_hw, 5))
        return l2_normalize(gem_pool(f5, p=3.0, valid_hw=mask))
