"""Evaluation image loader: path lists with query bbox crops
(port of ``research_image_retrieval_tpu/data/eval_loader.py``).

Loads each path, optionally crops the query bounding box, thumbnails so
the max side == imsize, and yields variable-resolution single images for
the bucketed extractor (``index.extract_vectors``); with ``dct_coeffs``
a JPEG item is instead the host half of the split decode
(``data.native_decode.JpegCoeffs``), its entropy decode under the span
``extract.entropy_decode`` (``utils.profiling.span``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from research_image_retrieval_tpu_torch.data.native_decode import (
    decode_image,
    decode_jpeg_coeffs,
)
from research_image_retrieval_tpu_torch.data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    imthumbnail,
    normalize,
    rgb_to_bgr,
)
from research_image_retrieval_tpu_torch.utils.profiling import span

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
      dct_coeffs: k > 0 makes a JPEG item the split decode's host half,
        ``JpegCoeffs`` (the top-left k x k quantized coefficients of each
        block), for ``extract_vectors(dct_decode=True)``, which finishes
        the decode on the device.  A source larger than ``imsize``
        prescales in the DCT domain (``out_block`` < 8, libjpeg's
        ``scale_denom`` choice).  Items with a bbox, non-JPEG files and
        files the coefficient decoder refuses are raw uint8 arrays
        (``rgb_item``).  Requires ``raw_uint8``.
    """

    def __init__(self, paths: Sequence[str], imsize: int | None = None,
                 bbxs: Sequence | None = None, normalize_input: bool = True,
                 bgr: bool = False, raw_uint8: bool = False,
                 fast_decode: bool = False, dct_coeffs: int = 0):
        if raw_uint8 and bgr:
            raise ValueError(
                "raw_uint8 stages normalization on-device with RGB stats; "
                "the BGR (Caffe) path needs host normalization")
        if dct_coeffs and not raw_uint8:
            raise ValueError("dct_coeffs requires raw_uint8=True "
                             "(normalization runs on the device)")
        self.paths = list(paths)
        self.imsize = imsize
        self.bbxs = list(bbxs) if bbxs is not None else None
        self.normalize_input = normalize_input
        self.bgr = bgr
        self.raw_uint8 = raw_uint8
        self.fast_decode = fast_decode
        self.dct_coeffs = int(dct_coeffs)

    def __len__(self):
        return len(self.paths)

    def _coeffs_item(self, i: int):
        """The split decode's payload of item ``i``, or None for the RGB
        path."""
        path = self.paths[i]
        if not path.lower().endswith((".jpg", ".jpeg")):
            return None
        if self.bbxs is not None and self.bbxs[i] is not None:
            return None  # crop coordinates are in pixels
        with open(path, "rb") as f:
            data = f.read()
        with span("extract.entropy_decode", id=i):
            co = decode_jpeg_coeffs(data, k=self.dct_coeffs)
        if co is None or not self.imsize:
            return co
        # DCT-domain prescale: the smallest 1/2^p whose max side is still
        # >= imsize (libjpeg's scale_denom choice)
        full = max(co.h, co.w)
        n = 8
        while n > 1 and full * (n // 2) // 8 >= self.imsize:
            n //= 2
        co.out_block = n
        if full != self.imsize:
            s = self.imsize / full
            co.target_hw = (max(int(round(co.h * s)), 1),
                            max(int(round(co.w * s)), 1))
        else:
            co.target_hw = co.decoded_hw
        return co

    def __getitem__(self, i: int):
        if self.dct_coeffs:
            co = self._coeffs_item(i)
            if co is not None:
                return co
        return self.rgb_item(i)

    def rgb_item(self, i: int) -> np.ndarray:
        """Item ``i`` as pixels whatever ``dct_coeffs`` says (the rerank
        paths load their shortlists as pixels)."""
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

    def rgb_item(self, i: int):
        """Item ``i`` as pixels whatever the dataset's payload."""
        fn = getattr(self.dataset, "rgb_item", None)
        return self.dataset[i] if fn is None else fn(i)

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
