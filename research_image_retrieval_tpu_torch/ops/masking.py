"""Validity-mask helpers for bucketed variable-resolution extraction
(port of ``research_image_retrieval_tpu/ops/masking.py``).

Images are padded bottom/right into resolution buckets and carry their
true extent as a ``[B, 2]`` int tensor of valid (height, width) pixels.
Masked model paths re-zero the padded region before every spatial op, so
a padded image gives the same features as its exact-shape run.
"""

from __future__ import annotations

import torch

from research_image_retrieval_tpu_torch.ops.resize import dense_resize_weights

__all__ = ["ceil_half", "downsample_extents", "dynamic_resize_weights",
           "floor_half", "hw_mask", "mask_attn_logits", "token_mask"]

# Large finite negative for masked attention logits, not -inf: a row whose
# keys are all padding then softmaxes to uniform finite values (which a
# later pooling mask removes) instead of NaN.
_NEG = -1e30


def ceil_half(extents: torch.Tensor) -> torch.Tensor:
    """ceil(e / 2) elementwise: every downsampling step of a torch-padded
    ResNet (7x7/2 p3 stem, 3x3/2 p1 maxpool, strided block convs) maps a
    spatial size h to ceil(h/2)."""
    return torch.div(extents + 1, 2, rounding_mode="floor")


def floor_half(extents: torch.Tensor) -> torch.Tensor:
    """max(e // 2, 1) elementwise: a 2x2 / stride-2 average pool (CLIP's
    ModifiedResNet) keeps the floor half of a valid extent, and at
    least one cell."""
    return torch.clamp(torch.div(extents, 2, rounding_mode="floor"), min=1)


def downsample_extents(extents: torch.Tensor, times: int) -> torch.Tensor:
    """Apply ``ceil_half`` ``times`` times."""
    for _ in range(times):
        extents = ceil_half(extents)
    return extents


def hw_mask(h: int, w: int, extents: torch.Tensor,
            dtype=torch.float32) -> torch.Tensor:
    """[B, h, w] mask of valid cells given per-image ``[B, 2]`` extents."""
    dev = extents.device
    row = torch.arange(h, device=dev)[None, :] < extents[:, 0:1]  # [B, h]
    col = torch.arange(w, device=dev)[None, :] < extents[:, 1:2]  # [B, w]
    return (row[:, :, None] & col[:, None, :]).to(dtype)


def token_mask(h: int, w: int, extents: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """[B, h*w] mask over row-major flattened HW tokens."""
    return hw_mask(h, w, extents, dtype=dtype).reshape(-1, h * w)


def mask_attn_logits(logits: torch.Tensor,
                     key_mask: torch.Tensor) -> torch.Tensor:
    """``logits`` [B, ..., Nk] with the keys where ``key_mask`` [B, Nk]
    is 0 set to ``_NEG``, broadcast over the middle axes."""
    m = key_mask.bool()
    shape = (m.shape[0],) + (1,) * (logits.dim() - 2) + (m.shape[-1],)
    return torch.where(m.reshape(shape), logits, _NEG)


def dynamic_resize_weights(n_out: int, n_in: int, true_out: torch.Tensor,
                           dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Per-image bilinear resize weights ``[B, n_out, n_in]`` fp32 (or
    ``dtype``): what
    ``jax.image.resize(method="bilinear", antialias=True)`` gives from
    ``n_in`` samples to each image's TRUE length ``true_out`` ([B] ints),
    in the first ``true_out`` rows of the padded ``n_out`` grid (zero rows
    past it).  Positional embeddings of padded buckets (ViT, ULTRON,
    CLIP's attention pool) are resized per image with it.  It is
    ``dense_resize_weights`` with the whole input valid."""
    n = torch.full_like(true_out, n_in)
    return dense_resize_weights(n, true_out, n_in, n_out, antialias=True,
                                dtype=dtype)
