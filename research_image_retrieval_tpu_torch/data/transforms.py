"""Eval-side image transforms (port of the eval half of
``research_image_retrieval_tpu/data/transforms.py``; numpy only).

* ``normalize`` / ``rgb_to_bgr``: ImageNet normalization (0-1 scale) and
  the channel flip of Caffe-pretrained backbones.
* ``imthumbnail``: aspect-preserving resize so the max side equals
  ``imsize``.  The JAX function calls OpenCV's ``INTER_LANCZOS4``; the
  port carries its own numpy Lanczos-4 resize (OpenCV may be missing on
  the card's host): OpenCV's 8-tap kernel, sample positions and replicated
  border, and for uint8 its fixed-point arithmetic (coefficients in
  1/2048 steps, the product sum rounded at 2^22), so the result is within
  one grey level of OpenCV's.
"""

from __future__ import annotations

import numpy as np

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "imthumbnail",
           "lanczos4_resize", "normalize", "rgb_to_bgr"]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_S45 = 0.70710678118654752440084436210485
_CS = np.array([[1, 0], [-_S45, -_S45], [0, 1], [_S45, -_S45], [-1, 0],
                [_S45, _S45], [0, -1], [-_S45, _S45]], np.float64)
_COEF_SCALE = 2048  # OpenCV's INTER_RESIZE_COEF_SCALE (11 bits)


def _to_float(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    return img.astype(np.float32)


def normalize(img: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    return (_to_float(img) - mean) / std


def rgb_to_bgr(img: np.ndarray) -> np.ndarray:
    return img[..., ::-1]


def _lanczos4_taps(in_size: int, out_size: int):
    """([out, 8] source indices, [out, 8] float32 weights) of OpenCV's
    Lanczos-4 resize along one axis: sample ``(i + 0.5) * in/out - 0.5``
    (in float32), taps ``floor - 3 .. floor + 4`` clamped to the image."""
    scale = 1.0 / (out_size / in_size)
    f = ((np.arange(out_size) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    x = (f - s.astype(np.float32)).astype(np.float32)
    y0 = -(x.astype(np.float64) + 3) * np.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    w = np.empty((out_size, 8), np.float32)
    total = np.zeros(out_size, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):  # x = 0: below
        for i in range(8):  # float accumulation in tap order, as OpenCV
            y = -(x.astype(np.float64) + 3 - i) * np.pi * 0.25
            w[:, i] = ((_CS[i, 0] * s0 + _CS[i, 1] * c0) / (y * y)).astype(
                np.float32)
            total += w[:, i]
        w *= (np.float32(1.0) / total)[:, None]
    exact = x < np.finfo(np.float32).eps  # on a source sample: one tap
    w[exact] = 0.0
    w[exact, 3] = 1.0
    idx = np.clip(s[:, None] + np.arange(-3, 5)[None, :], 0, in_size - 1)
    return idx, w


def lanczos4_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Resize ``[H, W(, C)]`` to ``[h, w(, C)]`` with OpenCV's
    ``INTER_LANCZOS4`` semantics: horizontal pass, then vertical.  uint8
    runs OpenCV's fixed-point arithmetic and returns uint8; any other
    dtype runs in float32 and returns float32."""
    img = np.asarray(img)
    xi, xw = _lanczos4_taps(img.shape[1], w)
    yi, yw = _lanczos4_taps(img.shape[0], h)
    if img.dtype == np.uint8:
        src = img.astype(np.int64)
        xw = np.rint(xw * _COEF_SCALE).astype(np.int64)
        yw = np.rint(yw * _COEF_SCALE).astype(np.int64)
    else:
        src = img.astype(np.float32)
    extra = (None,) * (img.ndim - 2)
    rows = sum(src[:, xi[:, k]] * xw[(None, slice(None), k) + extra]
               for k in range(8))                          # [H, w(, C)]
    out = sum(rows[yi[:, k]] * yw[(slice(None), k, None) + extra]
              for k in range(8))                           # [h, w(, C)]
    if img.dtype != np.uint8:
        return out.astype(np.float32)
    out = (out + (1 << 21)) >> 22
    return np.clip(out, 0, 255).astype(np.uint8)


def imthumbnail(img: np.ndarray, imsize: int) -> np.ndarray:
    """Aspect-preserving Lanczos-4 resize so the max side equals
    ``imsize`` (the image itself when it already does)."""
    h, w = img.shape[:2]
    if max(h, w) == imsize:
        return img
    s = imsize / max(h, w)
    return lanczos4_resize(img, max(int(round(h * s)), 1),
                           max(int(round(w * s)), 1))
