"""Normalization ops (port of ``research_image_retrieval_tpu/ops/norm.py``).

The descriptor contract of every model is "L2-normalized at the output",
so the exact normalization semantics (norm clamped at 1e-12, as in
``torch.nn.functional.normalize``) are part of the parity gate.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["at_least_fp32", "fused_input_norm", "l2_normalize"]


def fused_input_norm(input_norm):
    """The raw-uint8 input stage, or identity for ``None``.

    ``input_norm=(mean, std)`` (0-1 scale) returns a function computing
    ``(x/255 - mean)/std`` on a ``[..., 3]`` tensor, so uint8 batches
    cross host->device 4x smaller and are normalized on the device.
    """
    if input_norm is None:
        return lambda images: images
    mean = np.asarray(input_norm[0], np.float32)
    std = np.asarray(input_norm[1], np.float32)

    def norm(images: torch.Tensor) -> torch.Tensor:
        m = torch.as_tensor(mean, device=images.device)
        s = torch.as_tensor(std, device=images.device)
        return (images.to(torch.float32) / 255.0 - m) / s

    return norm


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """``x / max(||x||_2, eps)``: zero vectors map to zero, not NaN."""
    norm = torch.linalg.vector_norm(x, ord=2, dim=dim, keepdim=True)
    return x / torch.clamp(norm, min=eps)


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or float64 if it is float64 (a bf16 map is read in
    fp32, as flax promotes it against fp32 parameters)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))
