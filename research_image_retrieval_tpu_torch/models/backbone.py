"""ResNet-{18,34,50,101,152} backbones with per-image bucket masks
(port of ``research_image_retrieval_tpu/models/backbone.py``).

Public tensors are NHWC like the JAX package; inside, activations are
NCHW in ``channels_last`` memory (the same bytes as NHWC), so cuDNN runs
the stem, the stride-2 and the projection blocks, and the 12 stride-1
identity blocks go to the hand-written fused bottleneck
(``ops/resblock.py``) in eval mode.  Module and parameter names follow
torchvision, so torchvision-layout state dicts load directly.

Masking (``valid_hw`` [B, 2] input-pixel extents for padded buckets)
follows the JAX model exactly: the input is masked, the stem output is
masked before the max pool (post-ReLU zeros never win it), each block
re-zeros conv1's output before its 3x3, and extents ceil-halve after the
stem conv, the pool and every stride-2 block.

Training mode follows flax's BatchNorm, not torch's (``BatchNorm``
below): batch statistics normalize with the biased variance, and the
running variance averages that biased variance.  Inside
``utils.collectives.active_mesh`` (a train step over a layout of
ranks) the statistics are those of the global batch, over the data
group, as JAX's are under GSPMD.

``dtype`` is the JAX model's compute dtype, with flax's semantics: at
bf16 each convolution casts its input and its fp32 weight to bf16 and
gives bf16 (fp32 accumulation), batch norm takes the bf16 input, reduces
and normalizes in fp32 and gives bf16, ReLU, max pool and residual adds
run in bf16, and parameters and running statistics stay fp32.  In eval
mode the identity blocks run the bottleneck kernel's bf16 form.
``dilation_block5`` replaces layer4's stride 2 with dilation-2 3x3s (the
reference's surgery: the first block runs at stride 1, undilated); the
dilated identity blocks run the module form, since the kernel has no
dilation.  ``stem_s2d`` is accepted and computes the plain 7x7/2 stem:
the JAX space-to-depth form is the same arithmetic rearranged for the
TPU's matrix unit, with the same ``conv1`` parameter.
``stride_on_conv1`` puts each stride-2 bottleneck's stride on its first
1x1 instead of its 3x3 (the MSRA / pycls placement of dolg's scratch
backbone); the identity blocks, and so the kernel, are the same.
``out_stages`` selects the stage taps (2 = layer1 ... 5 = layer4): one
stage returns its map, several return ``{stage: map}``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from research_image_retrieval_tpu_torch.ops.masking import (
    ceil_half,
    downsample_extents,
    hw_mask,
)
from research_image_retrieval_tpu_torch.ops.resblock import (
    fold_bn,
    fused_bottleneck,
)
from research_image_retrieval_tpu_torch.utils import collectives
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["BasicBlock", "BatchNorm", "BottleneckBlock", "Conv2d",
           "RESNET_STAGE_DEPTHS", "ResNet", "compute_dtype", "nchw_conv",
           "same_conv", "same_pads", "stage_extents", "train_mode"]

RESNET_STAGE_DEPTHS = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}
_BASIC = {"resnet18", "resnet34"}


def stage_extents(valid_hw: torch.Tensor, stage: int,
                  dilation_block5: bool = False) -> torch.Tensor:
    """Valid (h, w) extents of a ResNet stage tap (2 = layer1 ... 5 =
    layer4) from input-pixel extents: every downsampling ceil-halves
    (layer4 does not with ``dilation_block5``)."""
    halvings = {2: 2, 3: 3, 4: 4, 5: 4 if dilation_block5 else 5}[stage]
    return downsample_extents(valid_hw, halvings)


def compute_dtype(dtype) -> torch.dtype:
    """A model's compute dtype from ``torch.float32`` / ``torch.bfloat16``
    or their names (``""`` is float32)."""
    names = {"": torch.float32, "float32": torch.float32,
             "bfloat16": torch.bfloat16}
    dt = names.get(dtype) if isinstance(dtype, str) else dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {dtype!r}: float32 or bfloat16")
    return dt


def train_mode(module: nn.Module, train: bool | None = None) -> bool:
    """``train`` (default: the module's mode), which must be the module's
    mode: batch norm reads batch statistics in train mode and the running
    ones in eval mode, and extraction (``train=False``) needs the latter."""
    train = module.training if train is None else train
    if train != module.training:
        raise ValueError(f"train={train} with the module in "
                         f"{'train' if module.training else 'eval'} mode: "
                         "call .train() or .eval() first")
    return train


def nchw_conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """An NCHW module (a head's 1x1 convolution) applied to an NHWC map;
    NHWC out.  Both permutes are views (channels_last)."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """flax ``SAME``: ceil(n / s) outputs, the total pad split low-first
    (``total // 2`` before)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def same_conv(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (no padding of its own) with flax's ``SAME`` padding on an
    NHWC batch; NHWC out."""
    k, s = conv.kernel_size[0], conv.stride[0]
    ph, pw = same_pads(x.shape[1], k, s), same_pads(x.shape[2], k, s)
    x = F.pad(x, (0, 0, *pw, *ph))
    return nchw_conv(conv, x)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype: the fp32 weight (and
    bias, if any) is cast to it, as flax's ``nn.Conv(dtype=...)`` casts
    its kernel; the gradient reaches the fp32 weight through the cast."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def _apply_mask(y: torch.Tensor, extents: torch.Tensor | None) -> torch.Tensor:
    """Zero the padded region of an NCHW tensor."""
    if extents is None:
        return y
    return y * hw_mask(y.shape[2], y.shape[3], extents, dtype=y.dtype)[:, None]


class _FlaxBatchNormTrain(torch.autograd.Function):
    """flax's train-mode normalization of NCHW ``x``: ``mean = E[x]``,
    ``var = max(E[x^2] - E[x]^2, 0)``, ``y = (x - mean) * (rsqrt(var +
    eps) * scale) + bias``.  The backward is ATen's batch-norm backward
    given that mean and 1/std, which is the gradient of the same function
    (autodiff of the fast variance gives 2(x - mean)/n, as of the two-pass
    one) and keeps only ``x`` for it, as cuDNN's batch norm does.

    With a data ``group`` of ``size`` ranks (equal shards) ``E[x]`` and
    ``E[x^2]`` are the means over the global batch: each rank's two
    means, summed over the group and divided by ``size``.  The backward
    then corrects ATen's local result by the difference between the
    local and the global means of ``dy`` and ``dy * xhat`` (the two
    per-channel sums SyncBatchNorm reduces, here ATen's ``grad_bias`` and
    ``grad_weight``, summed over the group).  At one rank both
    differences are exactly 0 and the result is the local one, bit for
    bit."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group=None, size=1):
        # a bf16 input is reduced and normalized in fp32 and the output
        # rounded to bf16 (flax's force_float32_reductions)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = (0, 2, 3)
        mean = xf.mean(dims)
        meansq = (xf * xf).mean(dims)
        if group is not None:
            stats = torch.stack([mean, meansq])
            dist.all_reduce(stats, group=group)
            mean, meansq = stats / size
        var = torch.clamp(meansq - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        shape = (1, -1, 1, 1)
        y = (xf - mean.view(shape)) * (invstd * weight).view(shape) \
            + bias.view(shape)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.eps, ctx.group, ctx.size = eps, group, size
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, invstd = ctx.saved_tensors
        gx, gw, gb = torch.ops.aten.native_batch_norm_backward(
            gy.contiguous(memory_format=_memory_format(x)), x, weight, None,
            None, mean, invstd, True, ctx.eps, [True, True, True])
        if ctx.group is not None:
            n = x.numel() // x.shape[1]
            sums = torch.stack([gb, gw])
            local = sums / n
            total = sums.clone()
            dist.all_reduce(total, group=ctx.group)
            d_dy, d_dyx = (local - total / ctx.size / n).to(invstd.dtype)
            # the correction (d_dy + xhat * d_dyx) * invstd * weight is
            # k1 + k2 * x per channel: one fused pass over x
            k2 = d_dyx * invstd * invstd * weight
            k1 = d_dy * invstd * weight - k2 * mean
            shape = (1, -1, 1, 1)
            corr = torch.addcmul(k1.view(shape), x, k2.view(shape))
            gx = (gx.to(corr.dtype) + corr).to(x.dtype)
        return gx, gw, gb, None, None, None


def _memory_format(x: torch.Tensor):
    return (torch.channels_last
            if x.is_contiguous(memory_format=torch.channels_last)
            and not x.is_contiguous() else torch.contiguous_format)


class BatchNorm(nn.BatchNorm2d):
    """``BatchNorm2d`` with flax's training semantics (``nn.BatchNorm(
    momentum=0.9, epsilon=1e-5)`` of the JAX backbone).

    In training the output is normalized with the batch's biased
    variance computed as flax computes it, ``E[x^2] - E[x]^2``
    (``use_fast_variance``; at a small batch its rounding differs from a
    two-pass variance by more than the parity bars), and the running
    average takes ``0.9 * running + 0.1 * batch`` of the mean and of that
    BIASED variance; torch's own module stores the unbiased one, n/(n-1)
    larger.  Eval mode reads the running statistics as ``BatchNorm2d``
    does.  A bf16 input gives a bf16 output, computed in fp32 as flax
    does: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``, then
    rounded; the parameters, statistics and their gradients stay fp32.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            if x.dtype != torch.bfloat16:
                return super().forward(x)
            shape = (1, -1, 1, 1)
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            y = (x.float() - self.running_mean.view(shape)) * mul.view(shape)
            return (y + self.bias.view(shape)).to(x.dtype)
        group, size = None, 1
        axis = collectives.data_axis()
        if axis is not None:
            group, size, _ = axis
        y, mean, var = _FlaxBatchNormTrain.apply(x, self.weight, self.bias,
                                                 self.eps, group, size)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return y


class BottleneckBlock(nn.Module):
    """Bottleneck with a projection skip: torchvision v1.5 (stride on the
    3x3) or, with ``stride_on_conv1``, MSRA / pycls (stride on the first
    1x1)."""

    def __init__(self, in_ch: int, width: int, out_ch: int, stride: int = 1,
                 dilation: int = 1, stride_on_conv1: bool = False):
        super().__init__()
        self.stride = stride
        s1, s2 = (stride, 1) if stride_on_conv1 else (1, stride)
        self.conv1 = Conv2d(in_ch, width, 1, stride=s1, bias=False)
        self.bn1 = BatchNorm(width)
        self.conv2 = Conv2d(width, width, 3, stride=s2, padding=dilation,
                            dilation=dilation, bias=False)
        self.bn2 = BatchNorm(width)
        self.conv3 = Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = BatchNorm(out_ch)
        self.downsample = None
        if in_ch != out_ch or stride != 1:
            self.downsample = nn.Sequential(
                Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                BatchNorm(out_ch))
        # undilated stride-1 identity blocks run as the fused kernel in
        # eval mode (the kernel's 3x3 has no dilation)
        self.fusable = self.downsample is None and dilation == 1
        self._folded = None
        self._folded_key = None

    def folded(self):
        """(w1, sb1, w2, sb2, w3, sb3) for ``fused_bottleneck``: conv
        weights in [K, N] GEMM layout (w2 HWIO) and BN folded with the
        running stats.  Recomputed only when a parameter or buffer
        changes (device, storage or in-place version)."""
        tensors = [*self.parameters(), *self.buffers()]
        key = tuple((t.device, t.data_ptr(), t._version) for t in tensors)
        if key != self._folded_key:
            with torch.no_grad():
                def sb(bn):
                    return fold_bn(bn.weight, bn.bias, bn.running_mean,
                                   bn.running_var, bn.eps).contiguous()
                self._folded = (
                    self.conv1.weight[:, :, 0, 0].t().contiguous(),
                    sb(self.bn1),
                    self.conv2.weight.permute(2, 3, 1, 0).contiguous(),
                    sb(self.bn2),
                    self.conv3.weight[:, :, 0, 0].t().contiguous(),
                    sb(self.bn3),
                )
            self._folded_key = key
        return self._folded

    def forward(self, x: torch.Tensor, extents: torch.Tensor | None = None):
        if self.fusable and not self.training:
            xh = x.permute(0, 2, 3, 1).contiguous()  # a view for channels_last
            y = fused_bottleneck(xh, *self.folded(), extents=extents)
            return y.permute(0, 3, 1, 2)
        identity = x
        y = F.relu(self.bn1(self.conv1(x)))
        # conv1 + BN leaks bias into the pad region: re-zero before the 3x3
        # (a strided conv1 has halved the extents first)
        if extents is not None and self.conv1.stride[0] == 2:
            extents = ceil_half(extents)
        y = _apply_mask(y, extents)
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample is not None:
            identity = self.downsample(x)
        return F.relu(y + identity)


class BasicBlock(nn.Module):
    """torchvision basic block: 3x3 (stride) -> 3x3, projection skip.  It
    has no fused kernel: every mode runs cuDNN."""

    def __init__(self, in_ch: int, width: int, out_ch: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = Conv2d(in_ch, out_ch, 3, stride=stride, padding=dilation,
                            dilation=dilation, bias=False)
        self.bn1 = BatchNorm(out_ch)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=dilation,
                            dilation=dilation, bias=False)
        self.bn2 = BatchNorm(out_ch)
        self.downsample = None
        if in_ch != out_ch or stride != 1:
            self.downsample = nn.Sequential(
                Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                BatchNorm(out_ch))

    def forward(self, x: torch.Tensor, extents: torch.Tensor | None = None):
        identity = x
        y = F.relu(self.bn1(self.conv1(_apply_mask(x, extents))))
        if extents is not None and self.stride == 2:
            extents = ceil_half(extents)
        y = self.bn2(self.conv2(_apply_mask(y, extents)))
        if self.downsample is not None:
            identity = self.downsample(x)
        return F.relu(y + identity)


class ResNet(nn.Module):
    """ResNet returning its ``out_stages`` taps (default: the layer4 map),
    NHWC in and out; the maps are in ``dtype`` (fp32 or bf16)."""

    def __init__(self, name: str = "resnet50", dilation_block5: bool = False,
                 stem_s2d: bool = False, dtype=torch.float32,
                 out_stages=(5,), stride_on_conv1: bool = False):
        super().__init__()
        if name not in RESNET_STAGE_DEPTHS:
            raise ValueError(f"unsupported backbone {name!r}; "
                             f"have {sorted(RESNET_STAGE_DEPTHS)}")
        self.name = name
        self.dilation_block5 = dilation_block5
        self.stem_s2d = stem_s2d  # the same 7x7/2 stem (see the docstring)
        self.dtype = compute_dtype(dtype)
        self.out_stages = tuple(out_stages)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        block, expansion = ((BasicBlock, 1) if name in _BASIC
                            else (BottleneckBlock, 4))
        extra = {} if name in _BASIC else {"stride_on_conv1": stride_on_conv1}
        in_ch = 64
        for i, (depth, w) in enumerate(zip(RESNET_STAGE_DEPTHS[name],
                                           (64, 128, 256, 512))):
            blocks = []
            dilated = i == 3 and dilation_block5
            for j in range(depth):
                stride = 2 if (i > 0 and j == 0 and not dilated) else 1
                # the surgery leaves the first block's 3x3 undilated
                dilation = 2 if dilated and j > 0 else 1
                blocks.append(block(in_ch, w, expansion * w, stride,
                                    dilation, **extra))
                in_ch = expansion * w
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.outputdim = in_ch  # layer4's channels
        self.outputdim_block4 = in_ch // 2  # layer3's
        self.to(memory_format=torch.channels_last)

    @fp32_precision()
    def forward(self, x: torch.Tensor, valid_hw: torch.Tensor | None = None):
        """x: [B, H, W, 3] images (zero-padded bottom/right when
        ``valid_hw`` [B, 2] is given).  Returns the [B, h, w, C] map of the
        one stage in ``out_stages`` (layer4: [B, h, w, 2048]), or
        ``{stage: map}`` for several, in ``dtype``."""
        if valid_hw is not None and self.training:
            raise ValueError("masked extraction requires eval mode")
        ext = valid_hw
        y = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        y = _apply_mask(y, ext)
        if self.dtype == torch.bfloat16:  # a float64 copy stays float64
            y = y.to(self.dtype)
        y = F.relu(self.bn1(self.conv1(y)))
        if ext is not None:
            ext = ceil_half(ext)
            # post-ReLU values are >= 0: zeroed padding never wins the max
            y = _apply_mask(y, ext)
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        if ext is not None:
            ext = ceil_half(ext)
        taps = {}
        for i in range(4):
            for block in getattr(self, f"layer{i + 1}"):
                y = block(y, extents=ext)
                if ext is not None and block.stride == 2:
                    ext = ceil_half(ext)
            taps[i + 2] = y.permute(0, 2, 3, 1)
        if len(self.out_stages) == 1:
            return taps[self.out_stages[0]]
        return {s: taps[s] for s in self.out_stages}
