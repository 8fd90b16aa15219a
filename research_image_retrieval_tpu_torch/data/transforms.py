"""Image transforms (port of ``research_image_retrieval_tpu/data/transforms.py``;
numpy only).

* ``normalize`` / ``rgb_to_bgr``: ImageNet normalization (0-1 scale) and
  the channel flip of Caffe-pretrained backbones.
* ``imthumbnail``: aspect-preserving resize so the max side equals
  ``imsize``.
* train: ``random_resized_crop`` (scale 0.2-1) + horizontal flip (0.5) +
  ``color_jitter`` (0.4, 0.4, 0.2, 0.1, with p = 0.8); val: bicubic resize
  to 8/7 of ``imsize`` + centre crop.  Randomness comes from
  ``np.random.default_rng((seed, epoch, index))``, as in the JAX package.

The JAX functions call OpenCV (``INTER_LANCZOS4``, ``INTER_LINEAR``,
``INTER_CUBIC``, RGB <-> HSV).  The port carries its own numpy versions
(OpenCV is not a dependency of the port): OpenCV's kernels, sample
positions and replicated border, and its uint8 arithmetic (fixed point
for Lanczos-4 and linear, rounded float for cubic, as OpenCV 5.0
computes them), so uint8 results are within one grey level of OpenCV's
and float results within 1e-5.
"""

from __future__ import annotations

import numpy as np

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "EvalTransform", "TrainTransform",
           "bicubic_resize", "center_crop", "color_jitter", "hsv_to_rgb",
           "imthumbnail", "lanczos4_resize", "normalize", "random_resized_crop",
           "resize_bilinear", "rgb_to_bgr", "rgb_to_hsv"]

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


def _source_positions(in_size: int, out_size: int, dtype):
    """OpenCV's source coordinate of each output sample, ``(i + 0.5) *
    in/out - 0.5``, in ``dtype``: (floor, fraction)."""
    scale = 1.0 / (out_size / in_size)
    f = ((np.arange(out_size) + 0.5) * scale - 0.5).astype(dtype)
    s = np.floor(f).astype(np.int64)
    return s, (f - s.astype(dtype)).astype(dtype)


def _linear_taps(in_size: int, out_size: int, dtype=np.float64):
    """``INTER_LINEAR`` taps: 2 per sample, indices clamped."""
    s, x = _source_positions(in_size, out_size, dtype)
    idx = np.clip(s[:, None] + np.arange(2)[None, :], 0, in_size - 1)
    return idx, np.stack([1 - x, x], axis=1).astype(dtype)


def _cubic_taps(in_size: int, out_size: int):
    """``INTER_CUBIC`` taps (A = -0.75): 4 per sample, indices clamped."""
    s, x = _source_positions(in_size, out_size, np.float64)
    A = -0.75
    x1 = x + 1
    w0 = ((A * x1 - 5 * A) * x1 + 8 * A) * x1 - 4 * A
    w1 = ((A + 2) * x - (A + 3)) * x * x + 1
    w2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
    idx = np.clip(s[:, None] + np.arange(-1, 3)[None, :], 0, in_size - 1)
    return idx, np.stack([w0, w1, w2, 1 - w0 - w1 - w2], axis=1)


def _taps_pass(src, xi, xw, yi, yw):
    """Horizontal pass, then vertical: ``[H, W(, C)] -> [h, w(, C)]``."""
    extra = (None,) * (src.ndim - 2)
    rows = sum(src[:, xi[:, k]] * xw[(None, slice(None), k) + extra]
               for k in range(xi.shape[1]))                # [H, w(, C)]
    return sum(rows[yi[:, k]] * yw[(slice(None), k, None) + extra]
               for k in range(yi.shape[1]))                # [h, w(, C)]


def _separable_resize(img: np.ndarray, h: int, w: int, taps) -> np.ndarray:
    """Resize over ``taps(in, out) -> (idx, weights)`` in float64: uint8
    rounds to uint8, any other dtype returns float32."""
    img = np.asarray(img)
    xi, xw = taps(img.shape[1], w)
    yi, yw = taps(img.shape[0], h)
    out = _taps_pass(img.astype(np.float64), xi, xw, yi, yw)
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(np.float32)


def lanczos4_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Resize ``[H, W(, C)]`` to ``[h, w(, C)]`` with OpenCV's
    ``INTER_LANCZOS4`` semantics: horizontal pass, then vertical.  uint8
    runs OpenCV's fixed-point arithmetic and returns uint8; any other
    dtype runs in float32 and returns float32."""
    img = np.asarray(img)
    xi, xw = _lanczos4_taps(img.shape[1], w)
    yi, yw = _lanczos4_taps(img.shape[0], h)
    if img.dtype != np.uint8:
        return _taps_pass(img.astype(np.float32), xi, xw, yi,
                          yw).astype(np.float32)
    xw = np.rint(xw * _COEF_SCALE).astype(np.int64)
    yw = np.rint(yw * _COEF_SCALE).astype(np.int64)
    out = _taps_pass(img.astype(np.int64), xi, xw, yi, yw)
    out = (out + (1 << 21)) >> 22
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Resize with OpenCV's ``INTER_LINEAR`` semantics.  uint8 runs its
    fixed point (float32 sample positions, coefficients in 1/2048 steps,
    the vertical pass shifted as ``VResizeLinear`` shifts it), and an
    exact 2x downscale is the rounded 2x2 mean, as OpenCV computes it
    then; float runs in float64 and returns float32."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        return _separable_resize(img, h, w, _linear_taps)
    H, W = img.shape[:2]
    if (H, W) == (2 * h, 2 * w):
        q = img.astype(np.int32)
        q = q[0::2, 0::2] + q[0::2, 1::2] + q[1::2, 0::2] + q[1::2, 1::2]
        return ((q + 2) >> 2).astype(np.uint8)
    xi, xw = _linear_taps(W, w, np.float32)
    yi, yw = _linear_taps(H, h, np.float32)
    xw = np.rint(xw * _COEF_SCALE).astype(np.int64)
    yw = np.rint(yw * _COEF_SCALE).astype(np.int64)
    extra = (None,) * (img.ndim - 2)
    rows = sum(img[:, xi[:, k]].astype(np.int64)
               * xw[(None, slice(None), k) + extra] for k in range(2))
    out = sum((rows[yi[:, k]] >> 4) * yw[(slice(None), k, None) + extra]
              >> 16 for k in range(2))
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def bicubic_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Resize with OpenCV's ``INTER_CUBIC`` semantics (float64 arithmetic;
    uint8 rounds to the nearest level)."""
    return _separable_resize(img, h, w, _cubic_taps)


def imthumbnail(img: np.ndarray, imsize: int) -> np.ndarray:
    """Aspect-preserving Lanczos-4 resize so the max side equals
    ``imsize`` (the image itself when it already does)."""
    h, w = img.shape[:2]
    if max(h, w) == imsize:
        return img
    s = imsize / max(h, w)
    return lanczos4_resize(img, max(int(round(h * s)), 1),
                           max(int(round(w * s)), 1))


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    top = max((h - size) // 2, 0)
    left = max((w - size) // 2, 0)
    return img[top: top + size, left: left + size]


def random_resized_crop(img: np.ndarray, size: int, rng: np.random.Generator,
                        scale=(0.2, 1.0), ratio=(3 / 4, 4 / 3),
                        attempts: int = 10) -> np.ndarray:
    """torchvision RandomResizedCrop semantics (area scale + log ratio),
    the JAX function's draws, then a bilinear resize to ``size``."""
    h, w = img.shape[:2]
    area = h * w
    for _ in range(attempts):
        target_area = area * rng.uniform(*scale)
        log_ratio = np.log(ratio)
        aspect = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            crop = img[top: top + ch, left: left + cw]
            return resize_bilinear(crop, size, size)
    # fallback: centre crop of the largest valid region
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    return resize_bilinear(center_crop(img, min(ch, cw)), size, size)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """float RGB in [0, 1] -> HSV with H in [0, 360), as OpenCV's
    ``COLOR_RGB2HSV`` on float32."""
    img = np.asarray(img, np.float32)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    eps = np.float32(np.finfo(np.float32).eps)
    v = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = v - vmin
    s = diff / (np.abs(v) + eps)
    diff = np.float32(60.0) / (diff + eps)
    h = np.where(v == r, (g - b) * diff,
                 np.where(v == g, (b - r) * diff + np.float32(120),
                          (r - g) * diff + np.float32(240)))
    h = np.where(h < 0, h + np.float32(360), h)
    return np.stack([h, s, v], axis=-1).astype(np.float32)


# OpenCV's HSV -> RGB sector table: indices into (v, p, q, t) for b, g, r
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """HSV (H in degrees) -> float RGB, as OpenCV's ``COLOR_HSV2RGB`` on
    float32."""
    hsv = np.asarray(hsv, np.float32)
    h = hsv[..., 0] * np.float32(6.0 / 360.0)
    s, v = hsv[..., 1], hsv[..., 2]
    h = np.mod(h, np.float32(6))
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(np.float32)
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector)
    h = np.where(bad, np.float32(0), h)
    one = np.float32(1)
    tab = np.stack([v, v * (one - s), v * (one - s * h),
                    v * (one - s * (one - h))], axis=-1)
    pick = _SECTORS[sector]                       # [..., 3] (b, g, r)
    bgr = np.take_along_axis(tab, pick, axis=-1)
    rgb = bgr[..., ::-1]
    gray = np.repeat(v[..., None], 3, axis=-1)
    return np.where((s == 0)[..., None], gray, rgb).astype(np.float32)


def _adjust_brightness(img, factor):
    return img * factor


def _adjust_contrast(img, factor):
    mean = img.mean(axis=(0, 1), keepdims=True).mean()
    return (img - mean) * factor + mean


def _adjust_saturation(img, factor):
    gray = img @ np.array([0.299, 0.587, 0.114], np.float32)
    gray = gray[..., None]
    return (img - gray) * factor + gray


def _adjust_hue(img, delta):
    hsv = rgb_to_hsv(np.clip(img, 0, 1))
    hsv[..., 0] = (hsv[..., 0] + delta * 360.0) % 360.0
    return hsv_to_rgb(hsv)


def color_jitter(img: np.ndarray, rng: np.random.Generator,
                 brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.2, hue: float = 0.1) -> np.ndarray:
    """torchvision ColorJitter: uniform factors, applied in random order."""
    img = _to_float(img)
    ops = []
    if brightness:
        f = rng.uniform(max(0, 1 - brightness), 1 + brightness)
        ops.append(lambda x: _adjust_brightness(x, f))
    if contrast:
        f = rng.uniform(max(0, 1 - contrast), 1 + contrast)
        ops.append(lambda x: _adjust_contrast(x, f))
    if saturation:
        f = rng.uniform(max(0, 1 - saturation), 1 + saturation)
        ops.append(lambda x: _adjust_saturation(x, f))
    if hue:
        d = rng.uniform(-hue, hue)
        ops.append(lambda x: _adjust_hue(x, d))
    for i in rng.permutation(len(ops)):
        img = ops[i](img)
    return np.clip(img, 0.0, 1.0)


def _as_uint8(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img
    return (np.clip(_to_float(img), 0, 1) * 255.0 + 0.5).astype(np.uint8)


class TrainTransform:
    """Train augmentation: random resized crop, horizontal flip (0.5),
    colour jitter (``jitter_p``), then normalization.

    Randomness is seeded by (seed, epoch, index): deterministic and
    resumable, fresh each epoch (the pipeline calls ``set_epoch``).
    ``raw_uint8=True`` yields RAW uint8 crops (no /255, no mean/std) for a
    train step that normalizes on the device; crop, flip and jitter then
    run in uint8 space.
    """

    def __init__(self, imsize: int = 512, seed: int = 0, jitter_p: float = 0.8,
                 bgr: bool = False, raw_uint8: bool = False):
        if raw_uint8 and bgr:
            raise ValueError(
                "raw_uint8 normalizes on the device with RGB stats; the BGR "
                "(Caffe) path needs host normalization")
        self.imsize = imsize
        self.seed = seed
        self.jitter_p = jitter_p
        self.bgr = bgr
        self.raw_uint8 = raw_uint8
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __call__(self, img: np.ndarray, index: int = 0) -> np.ndarray:
        rng = np.random.default_rng((self.seed, self.epoch, index))
        img = _as_uint8(img) if self.raw_uint8 else _to_float(img)
        img = random_resized_crop(img, self.imsize, rng)
        if rng.random() < 0.5:
            img = img[:, ::-1]
        if rng.random() < self.jitter_p:
            img = color_jitter(img, rng)  # float 0-1 out
            if self.raw_uint8:
                img = (img * 255.0 + 0.5).astype(np.uint8)
        if self.raw_uint8:
            return np.ascontiguousarray(img)
        img = normalize(img)
        if self.bgr:
            img = rgb_to_bgr(img)
        return np.ascontiguousarray(img, np.float32)


class EvalTransform:
    """Val: bicubic resize of the short side to ``imsize * 8/7``, centre
    crop to ``imsize``, normalization (``raw_uint8``: uint8 out, as in
    ``TrainTransform``)."""

    def __init__(self, imsize: int = 512, bgr: bool = False,
                 raw_uint8: bool = False):
        if raw_uint8 and bgr:
            raise ValueError(
                "raw_uint8 normalizes on the device with RGB stats; the BGR "
                "(Caffe) path needs host normalization")
        self.imsize = imsize
        self.bgr = bgr
        self.raw_uint8 = raw_uint8

    def __call__(self, img: np.ndarray, index: int = 0) -> np.ndarray:
        img = _as_uint8(img) if self.raw_uint8 else _to_float(img)
        target = int(self.imsize * 8 / 7)
        h, w = img.shape[:2]
        s = target / min(h, w)
        img = bicubic_resize(img, int(round(h * s)), int(round(w * s)))
        img = center_crop(img, self.imsize)
        if self.raw_uint8:
            return np.ascontiguousarray(img)
        # bicubic overshoots; uint8 saturates, so the float path clamps
        img = normalize(np.clip(img, 0.0, 1.0))
        if self.bgr:
            img = rgb_to_bgr(img)
        return np.ascontiguousarray(img, np.float32)
