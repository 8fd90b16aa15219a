"""Operation and byte counts of the benchmark's models, and the chip's peaks.

Everything here is counted from the published architecture (He et al.,
"Deep Residual Learning for Image Recognition", CVPR 2016, Table 1, in
torchvision's v1.5 form with the stride on the 3x3; ``stride_on_conv1``
gives the paper's form), never from the port's module tree, so a change
that fuses or renames the port's modules leaves the counts alone.  A
multiply-add is two operations.  Only convolutions and matrix products
are counted: batch norm, ReLU, pooling and the losses' elementwise work
are left out, as the published counts leave them out.
"""

from __future__ import annotations

import math

__all__ = ["PEAKS", "bottleneck_call_work", "resnet_macs", "retrieval_macs",
           "roofline_s", "scale_size"]

# NVIDIA H100 SXM (80 GB HBM3) data sheet, dense rates at the 700 W limit.
# "fp32_tc" is the fp32-accurate tensor-core rate of three TF32 products
# per product (3xTF32), the form the port's bottleneck kernel takes at
# fp32: 494.7 / 3.  "fp32" is the FMA rate outside the tensor cores.
PEAKS = {
    "fp32_tc": 494.7e12 / 3,
    "fp32": 66.9e12,
    "tf32": 494.7e12,
    "bf16": 989.4e12,
    "hbm_bytes": 3.35e12,
}

_DEPTHS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
           "resnet152": (3, 8, 36, 3)}
_WIDTHS = (64, 128, 256, 512)


def _down(n: int) -> int:
    """Output size of a stride-2 convolution or pool padded as torchvision
    pads them (7x7 p3, 3x3 p1, 1x1 p0 with an even kernel offset)."""
    return -(-n // 2)


def resnet_macs(depths, h: int, w: int, fc: int = 0,
                stride_on_conv1: bool = False) -> int:
    """Multiply-adds of a bottleneck ResNet's convolutions on one ``h`` x
    ``w`` image (plus a ``2048 x fc`` classifier when ``fc`` > 0).
    ``depths`` is a name of ``_DEPTHS`` or the four stage depths."""
    depths = _DEPTHS[depths] if isinstance(depths, str) else tuple(depths)
    h, w = _down(h), _down(w)
    macs = h * w * 64 * 3 * 49          # stem 7x7/2
    h, w = _down(h), _down(w)           # max pool 3x3/2
    cin = 64
    for stage, (depth, width) in enumerate(zip(depths, _WIDTHS)):
        cout = 4 * width
        for block in range(depth):
            stride = 2 if stage > 0 and block == 0 else 1
            oh, ow = (_down(h), _down(w)) if stride == 2 else (h, w)
            if stride_on_conv1:
                macs += oh * ow * cin * width        # 1x1, strided
            else:
                macs += h * w * cin * width          # 1x1 at the input size
            macs += oh * ow * 9 * width * width      # 3x3
            macs += oh * ow * width * cout           # 1x1 up
            if block == 0:
                macs += oh * ow * cin * cout         # projection skip
            h, w, cin = oh, ow, cout
    return macs + (cin * fc if fc else 0)


def retrieval_macs(depths, h: int, w: int, whiten: int = 2048,
                   classes: int = 0) -> int:
    """Multiply-adds of a ResNet-GeM descriptor on one image: the
    backbone, the ``2048 x whiten`` whitening and, for training, the
    ``whiten x classes`` ArcFace product."""
    return resnet_macs(depths, h, w) + 2048 * whiten + whiten * classes


def bottleneck_call_work(rows_valid: int, channels: int,
                         dtype_bytes: int = 4) -> tuple[int, int]:
    """(operations, bytes) of one stride-1 identity bottleneck over
    ``rows_valid`` pixels of its extents: the three convolutions (1x1
    ``C -> C/4``, 3x3 ``C/4 -> C/4``, 1x1 ``C/4 -> C``), each input,
    weight and output byte counted once (the input map read, the output
    map written, the three weights and the three folded BN affines)."""
    c, cw = channels, channels // 4
    weights = c * cw + 9 * cw * cw + cw * c
    ops = 2 * rows_valid * weights
    nbytes = dtype_bytes * (2 * rows_valid * c + weights
                            + 2 * (cw + cw + c))
    return ops, nbytes


def roofline_s(ops: float, nbytes: float, peak: str = "fp32_tc") -> float:
    """The least time the chip could take: the larger of the operations
    at ``PEAKS[peak]`` and the bytes at the HBM rate."""
    return max(ops / PEAKS[peak], nbytes / PEAKS["hbm_bytes"])


def scale_size(h: int, w: int, s: float) -> tuple[int, int]:
    """A multi-scale task's extents (the reference extractor floors)."""
    return int(math.floor(h * s)), int(math.floor(w * s))
