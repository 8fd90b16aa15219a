"""Global pooling over NHWC feature maps
(port of ``research_image_retrieval_tpu/ops/pooling.py``).

gem: ``avg_pool(clamp(x, eps)^p)^(1/p)`` over H, W, optionally restricted
to a ``[B, H, W]`` validity mask so padded buckets are invisible.
"""

from __future__ import annotations

import torch

__all__ = ["gem_pool"]


def _masked_spatial_mean(x: torch.Tensor, valid_hw=None) -> torch.Tensor:
    """Mean over H, W of ``[B, H, W, C]``, optionally under a ``[B, H, W]``
    mask (count floored at 1)."""
    if valid_hw is None:
        return x.mean(dim=(1, 2))
    mask = valid_hw.to(x.dtype)[..., None]  # [B, H, W, 1]
    total = (x * mask).sum(dim=(1, 2))
    count = torch.clamp(mask.sum(dim=(1, 2)), min=1.0)
    return total / count


def gem_pool(x: torch.Tensor, p=3.0, eps: float = 1e-6,
             valid_hw: torch.Tensor | None = None) -> torch.Tensor:
    """Generalized-mean pooling of ``[B, H, W, C]`` -> ``[B, C]`` fp32
    (float64 input stays float64).

    ``p`` is a float or a learnable ``[1]`` tensor.
    """
    xp = torch.clamp(x.to(torch.promote_types(x.dtype, torch.float32)),
                     min=eps) ** p
    pooled = _masked_spatial_mean(xp, valid_hw)
    return pooled ** (1.0 / p)
