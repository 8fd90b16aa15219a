"""Global pooling over NHWC feature maps
(port of ``research_image_retrieval_tpu/ops/pooling.py``).

gem: ``avg_pool(clamp(x, eps)^p)^(1/p)`` over H, W; spoc: the clamped
mean; avg / max: the plain mean and max.  Each is optionally restricted
to a ``[B, H, W]`` validity mask so padded buckets are invisible, and
pools in fp32 (a float64 input stays float64).
"""

from __future__ import annotations

import torch

from research_image_retrieval_tpu_torch.ops.norm import at_least_fp32

__all__ = ["avg_pool_all", "gem_pool", "max_pool_all", "spoc_pool"]


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
    xp = torch.clamp(at_least_fp32(x), min=eps) ** p
    pooled = _masked_spatial_mean(xp, valid_hw)
    return pooled ** (1.0 / p)


def spoc_pool(x: torch.Tensor, eps: float = 1e-6,
              valid_hw: torch.Tensor | None = None) -> torch.Tensor:
    """Sum-pooling of convolutions (SPoC): the clamped spatial mean."""
    return _masked_spatial_mean(torch.clamp(at_least_fp32(x), min=eps),
                                valid_hw)


def avg_pool_all(x: torch.Tensor,
                 valid_hw: torch.Tensor | None = None) -> torch.Tensor:
    """Global average pool over H, W (no clamp)."""
    return _masked_spatial_mean(at_least_fp32(x), valid_hw)


def max_pool_all(x: torch.Tensor,
                 valid_hw: torch.Tensor | None = None) -> torch.Tensor:
    """Global max pool over H, W; under a mask, padded cells read as the
    dtype's lowest finite value."""
    x = at_least_fp32(x)
    if valid_hw is not None:
        x = torch.where(valid_hw.bool()[..., None], x,
                        torch.finfo(x.dtype).min)
    return x.amax(dim=(1, 2))
