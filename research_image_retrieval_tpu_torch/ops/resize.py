"""Per-image bilinear resize weights built on the device
(port of ``research_image_retrieval_tpu/ops/resize.py``).

``dense_resize_weights`` builds the ``[B, out_pad, in_pad]`` separable
triangle-kernel matrices of a half-pixel-centre bilinear resize
(``jax.image.resize(method="bilinear")``) from per-image int extents, so
a batched variable-extent resize is two fp32 batched matmuls with no host
tap tables.  Weights cover only each image's valid input extent and are
normalized per output sample; output rows past the image's output extent
are zero.
"""

from __future__ import annotations

import torch

__all__ = ["dense_resize_weights"]


def dense_resize_weights(in_sz: torch.Tensor, out_sz: torch.Tensor,
                         in_pad: int, out_pad: int,
                         antialias: bool = True,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, out_pad, in_pad] resize weights from ``[B]`` int extents, fp32
    (or ``dtype``: a float64 model resizes its float64 grids with float64
    weights, which then agree across devices to float64 rounding).

    ``antialias`` widens the triangle when downscaling (jax.image.resize);
    False keeps the plain 2-tap kernel of ``F.interpolate(mode="bilinear")``.
    """
    dev = in_sz.device
    o = torch.arange(out_pad, dtype=dtype, device=dev)[None, :]      # [1, op]
    h = torch.arange(in_pad, dtype=dtype, device=dev)[None, None, :]  # [1,1,ip]
    in_f = in_sz.to(dtype)[:, None]                                   # [B, 1]
    out_f = out_sz.to(dtype)[:, None]
    inv = in_f / torch.clamp(out_f, min=1.0)
    ks = torch.clamp(inv, min=1.0) if antialias else torch.ones_like(inv)
    sample = (o + 0.5) * inv - 0.5                                    # [B, op]
    x = torch.abs(sample[:, :, None] - h) / ks[:, :, None]
    w = torch.clamp(1.0 - x, min=0.0)                                 # triangle
    zero = torch.zeros((), dtype=dtype, device=dev)
    w = torch.where(h < in_f[:, :, None], w, zero)
    w = torch.where((o < out_f)[:, :, None], w, zero)
    tot = w.sum(dim=2, keepdim=True)
    return torch.where(torch.abs(tot) > 1e-7, w / tot, zero)
