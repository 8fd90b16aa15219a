"""Evaluation image loader: path lists with query bbox crops
(port of ``research_image_retrieval_tpu/data/eval_loader.py``; the split
DCT decode, ``dct_coeffs``, is not ported yet).

Loads each path, optionally crops the query bounding box, thumbnails so
the max side == imsize, and yields variable-resolution single images for
the bucketed extractor (``index.extract_vectors``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from research_image_retrieval_tpu_torch.data.native_decode import decode_image
from research_image_retrieval_tpu_torch.data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    imthumbnail,
    normalize,
    rgb_to_bgr,
)

__all__ = ["ImageFromList", "PrefetchedImages", "load_image"]


def load_image(path: str, max_side: int = 0) -> np.ndarray:
    """Load an image file as RGB uint8 HWC (``decode_image``'s decoder
    order).  ``max_side`` > 0 lets the native decoder prescale a JPEG to
    the smallest 1/2^k scale whose max side is still >= ``max_side``; the
    caller still owns the exact final resize."""
    with open(path, "rb") as f:
        return decode_image(f.read(), max_side=max_side)


class ImageFromList:
    """Dataset over a list of image paths (eval-time extraction input).

    Args:
      paths: image file paths.
      imsize: max-side thumbnail target (None keeps native resolution).
      bbxs: optional per-image (x1, y1, x2, y2) crop boxes (query crops).
      normalize_input: apply ImageNet normalization.
      bgr: RGB -> BGR for Caffe-pretrained backbones.
      raw_uint8: yield RAW uint8 after crop/thumbnail, for
        ``extract_vectors(input_norm=...)``, which normalizes on the
        device.  Mutually exclusive with ``bgr``.
      fast_decode: decode JPEGs with native DCT-domain prescaling to the
        smallest 1/2^k scale still >= ``imsize`` before the exact
        thumbnail (images with a bbox decode at full resolution).  Not
        the strict-parity decode path.
    """

    def __init__(self, paths: Sequence[str], imsize: int | None = None,
                 bbxs: Sequence | None = None, normalize_input: bool = True,
                 bgr: bool = False, raw_uint8: bool = False,
                 fast_decode: bool = False):
        if raw_uint8 and bgr:
            raise ValueError(
                "raw_uint8 stages normalization on-device with RGB stats; "
                "the BGR (Caffe) path needs host normalization")
        self.paths = list(paths)
        self.imsize = imsize
        self.bbxs = list(bbxs) if bbxs is not None else None
        self.normalize_input = normalize_input
        self.bgr = bgr
        self.raw_uint8 = raw_uint8
        self.fast_decode = fast_decode

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i: int) -> np.ndarray:
        has_bbx = self.bbxs is not None and self.bbxs[i] is not None
        prescale = (self.imsize
                    if (self.fast_decode and self.imsize and not has_bbx)
                    else 0)
        img = load_image(self.paths[i], max_side=prescale)
        if has_bbx:
            x1, y1, x2, y2 = (int(round(v)) for v in self.bbxs[i])
            img = img[y1:y2, x1:x2]
        if self.imsize is not None:
            img = imthumbnail(img, self.imsize)
        if self.raw_uint8:  # bgr is rejected in __init__
            return np.ascontiguousarray(img, np.uint8)
        img = img.astype(np.float32) / 255.0 if img.dtype == np.uint8 else img
        if self.normalize_input:
            img = normalize(img, IMAGENET_MEAN, IMAGENET_STD)
        if self.bgr:
            img = rgb_to_bgr(img)
        return np.ascontiguousarray(img, np.float32)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class PrefetchedImages:
    """Decode-ahead wrapper for any indexable image dataset: iterating
    yields ``dataset[i]`` in order while a small thread pool decodes up to
    ``depth`` items ahead, so decoding overlaps the extractor's device
    work (libjpeg, OpenCV and PIL release the GIL while decoding)."""

    def __init__(self, dataset, depth: int = 8, workers: int = 2):
        self.dataset = dataset
        self.depth = max(1, int(depth))
        self.workers = max(1, int(workers))

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i: int):
        return self.dataset[i]

    def __iter__(self):
        from concurrent.futures import ThreadPoolExecutor

        n = len(self.dataset)
        if n == 0:
            return
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            pending = {i: pool.submit(self.dataset.__getitem__, i)
                       for i in range(min(self.depth, n))}
            for i in range(n):
                nxt = i + self.depth
                if nxt < n:
                    pending[nxt] = pool.submit(self.dataset.__getitem__, nxt)
                yield pending.pop(i).result()
