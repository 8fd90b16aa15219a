"""Plain image resizes: the antialiased triangle resize of the reference
extractor's multi-scale step, and the Lanczos thumbnail of an image query.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference.precision import matmul

__all__ = ["thumbnail", "triangle_weights", "triangle_resize"]


def triangle_weights(n_in: int, n_out: int) -> np.ndarray:
    """``[n_out, n_in]`` weights of a half-pixel-centre bilinear resize
    whose triangle widens by the downscale factor (antialiasing, as
    ``jax.image.resize(method="bilinear")``), each row summing to 1;
    computed in float64."""
    inv = n_in / n_out
    ks = max(inv, 1.0)
    centre = (np.arange(n_out) + 0.5) * inv - 0.5
    w = np.maximum(0.0, 1.0 - np.abs(centre[:, None]
                                     - np.arange(n_in)[None, :]) / ks)
    tot = w.sum(axis=1, keepdims=True)
    return np.where(np.abs(tot) > 1e-7, w / tot, 0.0)


def triangle_resize(x: torch.Tensor, h: int, w: int,
                    precision: str) -> torch.Tensor:
    """``[B, H, W, C]`` fp32 -> ``[B, h, w, C]``: rows, then columns."""
    wh = torch.as_tensor(triangle_weights(x.shape[1], h), dtype=torch.float32,
                         device=x.device)
    ww = torch.as_tensor(triangle_weights(x.shape[2], w), dtype=torch.float32,
                         device=x.device)
    # rows: [h, H] x [B, H, W*C]
    B, H, W, C = x.shape
    y = matmul(wh, x.reshape(B, H, W * C), precision).reshape(B, h, W, C)
    y = y.permute(0, 2, 1, 3).reshape(B, W, h * C)
    y = matmul(ww, y, precision).reshape(B, w, h, C)
    return y.permute(0, 2, 1, 3).contiguous()


def thumbnail(img: np.ndarray, imsize: int) -> np.ndarray:
    """An image query's thumbnail: the longer side resized to ``imsize``
    with OpenCV's Lanczos-4 (uint8 in, uint8 out); an image whose longer
    side already is ``imsize`` is kept."""
    import cv2

    h, w = img.shape[:2]
    if max(h, w) == imsize:
        return img
    s = imsize / max(h, w)
    size = (max(int(round(w * s)), 1), max(int(round(h * s)), 1))
    return cv2.resize(img, size, interpolation=cv2.INTER_LANCZOS4)


def scaled_size(h: int, w: int, s: float) -> tuple[int, int]:
    return int(math.floor(h * s)), int(math.floor(w * s))
