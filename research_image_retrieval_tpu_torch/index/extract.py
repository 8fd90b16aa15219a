"""Multi-scale descriptor extraction over padded resolution buckets
(port of ``research_image_retrieval_tpu/index/extract.py``).

Contract of the reference extractor (utils/helpfunc.py:18-48):

* multi-scale: for each scale s, bilinearly resize the input (skip scales
  whose resized min side < 36 px), extract, SUM the descriptors, divide
  by the number of kept scales, then L2-normalize;
* single-scale: images with min side < 36 px are upscaled so the min side
  is >= 64 px first.

Images are padded bottom/right into resolution buckets (H, W rounded up
to a multiple of ``bucket``) and run batched with a [B, 2] valid-extent
tensor; the masked model makes the padding invisible.  Patch and window
models (ViT, CLIP-ViT, ULTRON) advertise ``extent_multiple``: every
task's extents are snapped to the nearest positive multiple of it (one
resize from the original) before bucketing, so their token grids
(``valid_hw // patch``) are exact.  Descriptors
accumulate on the device with ``index_add_`` into a ``[block_cap + 1, D]``
fp32 buffer whose last row is a trash row for padding rows and skipped
scales; the host reads a block back once.  On CUDA each batch is
assembled in a pinned host buffer and copied with a non-blocking H2D copy
on a side stream; ``pipeline_depth`` pinned slots bound how far the host
runs ahead of the device.  With a ``parallel.mesh.Mesh`` (indexing
under ``torchrun``) the images are strided over the data ranks, each
rank runs its own buckets, and the descriptors are gathered in input
order.  With ``dct_decode`` JPEG items arrive as the split decode's
quantized DCT coefficients (``data.native_decode.JpegCoeffs``) and are
decoded on the device inside their buckets (``_DctAccumStream``).

Spans (``utils.profiling.span``, recorded while a profiler records):
``extract.vectors`` (the call), ``extract.source`` (each wait on the
caller's images), ``extract.batch`` (one dispatched batch, with counts
``rows``, ``rows_padded``, ``px_valid``, ``px_fed`` and ``slot_alloc``)
holding ``extract.slot_wait``, ``extract.assemble``, ``extract.h2d`` and
``extract.dispatch``, and ``extract.readback`` (a block's flush and
copy to the host).
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from research_image_retrieval_tpu_torch.data.native_decode import JpegCoeffs
from research_image_retrieval_tpu_torch.ops.jpeg_decode import dct_decode_rgb
from research_image_retrieval_tpu_torch.ops.norm import (
    fused_input_norm,
    l2_normalize,
)
from research_image_retrieval_tpu_torch.ops.resize import dense_resize_weights
from research_image_retrieval_tpu_torch.utils.collectives import (
    all_reduce_,
)
from research_image_retrieval_tpu_torch.utils.device import (
    fp32_precision,
    resolve_device,
)
from research_image_retrieval_tpu_torch.utils.profiling import span

__all__ = ["extract_vectors", "multiscale_descriptor", "resize_bilinear_np"]

_MIN_SIDE = 36
_UPSCALE_TARGET = 64
_END = object()  # the end of the caller's images
_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int16): torch.int16,
                 np.dtype(np.int32): torch.int32}


def _snap(v: int, multiple: int) -> int:
    """Nearest positive multiple of ``multiple`` to ``v`` (Python's
    ``round``: half to even), at least one multiple."""
    return max(multiple, int(round(v / multiple)) * multiple)


def _resize_taps(in_size: int, out_size: int, antialias: bool = True):
    """([out, k] input indices, [out, k] weights) of the triangle kernel's
    nonzero taps (half-pixel centres; ``antialias`` widens it when
    downscaling, False is torch ``F.interpolate(mode="bilinear")``)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample_f = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    k = 2 * int(math.ceil(kernel_scale)) + 1
    start = np.ceil(sample_f - kernel_scale).astype(np.int64)
    idx = start[:, None] + np.arange(k)[None, :]  # [out, k]
    x = np.abs(sample_f[:, None] - idx) / kernel_scale
    weights = np.maximum(0.0, 1.0 - x)
    weights = np.where((idx < 0) | (idx >= in_size), 0.0, weights)
    total = weights.sum(axis=1, keepdims=True)
    weights = np.where(np.abs(total) > 1e-7, weights / total, 0.0)
    return np.clip(idx, 0, in_size - 1), weights.astype(np.float32)


def resize_bilinear_np(img: np.ndarray, h: int, w: int,
                       antialias: bool = True) -> np.ndarray:
    """Host bilinear resize of one [H, W, C] image (the same weights as
    ``dense_resize_weights``, applied as gathered taps)."""
    img = np.asarray(img, np.float32)
    hi, hw_ = _resize_taps(img.shape[0], h, antialias)
    out = np.einsum("ok,okjc->ojc", hw_, img[hi], optimize=True)
    wi, ww_ = _resize_taps(img.shape[1], w, antialias)
    return np.einsum("ok,iokc->ioc", ww_, out[:, wi], optimize=True)


@fp32_precision()
def _resize_batch(x: torch.Tensor, in_h, in_w, out_h, out_w, pad_h: int,
                  pad_w: int, antialias: bool) -> torch.Tensor:
    """Per-image resize of [B, Hp, Wp, C] into [B, pad_h, pad_w, C] as two
    fp32 batched matmuls; extents are [B] int tensors."""
    wh = dense_resize_weights(in_h, out_h, x.shape[1], pad_h, antialias)
    xs = torch.einsum("boh,bhwc->bowc", wh, x.to(torch.float32))
    ww = dense_resize_weights(in_w, out_w, x.shape[2], pad_w, antialias)
    return torch.einsum("bow,bhwc->bhoc", ww, xs)


def _resize_bilinear(x: torch.Tensor, h: int, w: int,
                     antialias: bool = True) -> torch.Tensor:
    B, H, W, _ = x.shape
    full = lambda v: torch.full((B,), v, dtype=torch.int32, device=x.device)
    return _resize_batch(x, full(H), full(W), full(h), full(w), h, w,
                         antialias)


def multiscale_descriptor(extract_fn: Callable[[torch.Tensor], torch.Tensor],
                          images: torch.Tensor,
                          scales: Sequence[float] = (1.0,),
                          antialias: bool = True) -> torch.Tensor:
    """[B, D] descriptors of a batch of same-resolution [B, H, W, 3] images:
    per-scale descriptors summed, divided by the kept count, re-L2'd."""
    _, H, W, _ = images.shape
    if len(scales) == 1 and scales[0] == 1.0:
        if H < _MIN_SIDE or W < _MIN_SIDE:
            s = max(_UPSCALE_TARGET / H, _UPSCALE_TARGET / W)
            images = _resize_bilinear(images, int(round(H * s)),
                                      int(round(W * s)))
        return extract_fn(images)
    acc = None
    kept = 0
    for s in scales:
        nh, nw = int(math.floor(H * s)), int(math.floor(W * s))
        if nh < _MIN_SIDE or nw < _MIN_SIDE:
            continue
        scaled = (images if s == 1.0
                  else _resize_bilinear(images, nh, nw, antialias=antialias))
        vec = extract_fn(scaled)
        acc = vec if acc is None else acc + vec
        kept += 1
    if acc is None:
        raise ValueError(
            f"All scales {scales} shrink a {H}x{W} image below {_MIN_SIDE}px")
    return l2_normalize(acc / kept)


def _scale_tasks(idx: int, img: np.ndarray, scales: Sequence[float],
                 multiple: int = 1,
                 antialias: bool = True) -> list[tuple[int, np.ndarray]]:
    """One image -> (owner index, host-resized image) tasks, with the
    reference's <36 px guards; ``multiple`` > 1 snaps every task's
    extents to it (``_snap``), resizing once from the original."""
    H, W = img.shape[:2]
    if len(scales) == 1 and scales[0] == 1.0:
        nh, nw = H, W
        if H < _MIN_SIDE or W < _MIN_SIDE:
            s = max(_UPSCALE_TARGET / H, _UPSCALE_TARGET / W)
            nh, nw = int(round(H * s)), int(round(W * s))
        if multiple > 1:
            nh, nw = _snap(nh, multiple), _snap(nw, multiple)
        if (nh, nw) != (H, W):
            img = resize_bilinear_np(img, nh, nw, antialias=antialias)
        return [(idx, img)]
    tasks = []
    for s in scales:
        nh, nw = int(math.floor(H * s)), int(math.floor(W * s))
        if nh < _MIN_SIDE or nw < _MIN_SIDE:
            continue
        if multiple > 1:
            nh, nw = _snap(nh, multiple), _snap(nw, multiple)
        scaled = (img if (nh, nw) == (H, W)
                  else resize_bilinear_np(img, nh, nw, antialias=antialias))
        tasks.append((idx, scaled))
    if not tasks:
        raise ValueError(
            f"All scales {scales} shrink a {H}x{W} image below {_MIN_SIDE}px")
    return tasks


class _Staging:
    """Host staging of batches: pinned buffers and a side-stream H2D copy
    on CUDA, plain numpy-backed tensors on the CPU.

    ``depth`` slots rotate; before a slot is refilled (``wait``) the host
    waits for the device to finish the batch that last used it, which
    bounds the run-ahead to ``depth`` batches.  ``fresh`` says whether
    the last ``take`` allocated the slot's buffers anew.
    """

    def __init__(self, depth: int, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.depth = max(1, int(depth))
        self.slots: list = [None] * self.depth
        self.done: list = [None] * self.depth
        self.i = 0
        self.fresh = False
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def wait(self) -> None:
        """Block until the device is done with the next slot's batch."""
        s = self.i % self.depth
        if self.done[s] is not None:
            with span("extract.slot_wait"):
                self.done[s].synchronize()
            self.done[s] = None

    def take(self, specs) -> list[np.ndarray]:
        """Host arrays of the given (shape, dtype) specs to fill, in the
        next slot (after ``wait``)."""
        s = self.i % self.depth
        want = [(tuple(shape), _TORCH_DTYPES[np.dtype(dt)])
                for shape, dt in specs]
        bufs = self.slots[s]
        self.fresh = (bufs is None or
                      [(tuple(b.shape), b.dtype) for b in bufs] != want)
        if self.fresh:
            bufs = [torch.empty(shape, dtype=dt, pin_memory=self.cuda)
                    for shape, dt in want]
            self.slots[s] = bufs
        return [b.numpy() for b in bufs]

    def put(self) -> list[torch.Tensor]:
        """The taken slot's buffers on the device, ready on the current
        stream."""
        bufs = self.slots[self.i % self.depth]
        if not self.cuda:
            return bufs
        cur = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            devs = [b.to(self.device, non_blocking=True) for b in bufs]
        cur.wait_stream(self.stream)
        for d in devs:
            d.record_stream(cur)
        return devs

    def release(self) -> None:
        """Mark the taken slot as in use until the device reaches here."""
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.done[self.i % self.depth] = ev
        self.i += 1


class _AccumStream:
    """Bucketed masked extraction with device-side accumulation.

    Tasks (owner index, image) are fed one at a time; a resolution bucket
    that fills to ``batch_size`` runs as one batch (tail batches are padded
    with full-extent zero rows sent to the trash row).  Images past
    ``block_cap`` roll into a new block: pending buckets flush, the block
    is read back, and the accumulator restarts.
    """

    def __init__(self, extract_fn, bucket: int, batch_size: int,
                 device: torch.device, block_cap: int = 8192,
                 pipeline_depth: int = 4):
        self.extract_fn = extract_fn
        self.bucket = bucket
        self.batch_size = batch_size
        self.device = device
        self.block_cap = int(block_cap)
        self.in_dtype = np.float32
        self.multi = False  # host multi-scale: divide by kept + re-L2
        self.pending: dict[tuple, list] = {}
        self.acc = None
        self.kept = None
        self.outputdim = None
        self.block_base = 0
        self.block_n = 0  # images owned by the current block
        self.blocks: list[np.ndarray] = []
        self.staging = _Staging(pipeline_depth, device)

    def _q(self, v: int) -> int:
        return int(math.ceil(v / self.bucket) * self.bucket)

    def _key_and_task(self, owner: int, img: np.ndarray):
        return (self._q(img.shape[0]), self._q(img.shape[1])), (owner, img, None)

    def add(self, owner: int, img: np.ndarray) -> None:
        if owner - self.block_base >= self.block_cap:
            self._finalize_block()
        self.block_n = max(self.block_n, owner - self.block_base + 1)
        key, task = self._key_and_task(owner, img)
        items = self.pending.setdefault(key, [])
        items.append(task)
        if len(items) >= self.batch_size:
            self._dispatch(key, items)
            self.pending[key] = []

    def _meta_width(self) -> int:
        return 3

    def _fill_meta(self, meta: np.ndarray, r: int, task) -> None:
        owner, img, _ = task
        meta[r, 0:2] = img.shape[:2]
        meta[r, 2] = owner - self.block_base

    def _assemble(self, key: tuple, chunk, batch: np.ndarray,
                  meta: np.ndarray) -> None:
        bh, bw = key[0], key[1]
        batch.fill(0)
        # padding rows: full-extent feeds scattered to the trash row
        meta[:] = self.block_cap
        meta[:, 0] = bh
        meta[:, 1] = bw
        for r, task in enumerate(chunk):
            img = task[1]
            batch[r, : img.shape[0], : img.shape[1]] = img
            self._fill_meta(meta, r, task)

    def _specs(self, key: tuple) -> list:
        """(shape, dtype) of the batch's host buffers, the meta last."""
        return [((self.batch_size, key[0], key[1], 3), self.in_dtype),
                ((self.batch_size, self._meta_width()), np.int32)]

    def _pixels(self, key: tuple, meta: np.ndarray, n: int):
        """(valid pixels of the ``n`` real rows over every scale they
        run, pixels the model is fed over the batch's scales)."""
        valid = int((meta[:n, 0].astype(np.int64) * meta[:n, 1]).sum())
        return valid, self.batch_size * key[0] * key[1]

    def _dispatch(self, key: tuple, chunk) -> None:
        staging = self.staging
        with span("extract.batch", id=staging.i) as s:
            staging.wait()
            with span("extract.assemble"):
                bufs = staging.take(self._specs(key))
                self._assemble(key, chunk, *bufs)
            if s:
                valid, fed = self._pixels(key, bufs[-1], len(chunk))
                s.count(rows=len(chunk), rows_padded=self.batch_size,
                        px_valid=valid, px_fed=fed,
                        slot_alloc=int(staging.fresh))
            with span("extract.h2d"):
                bufs = staging.put()
            with span("extract.dispatch"):
                self._run(key, *bufs)
            staging.release()

    def _run(self, key: tuple, batch: torch.Tensor, meta: torch.Tensor):
        self._accumulate(meta[:, 2], self.extract_fn(batch, meta[:, :2]))

    def _accumulate(self, tgt: torch.Tensor, vecs: torch.Tensor) -> None:
        if self.acc is None:
            self.outputdim = vecs.shape[1]
            self.acc = torch.zeros((self.block_cap + 1, self.outputdim),
                                   dtype=torch.float32, device=self.device)
            self.kept = torch.zeros((self.block_cap + 1,), dtype=torch.int32,
                                    device=self.device)
        tgt = tgt.to(torch.int64)
        self.acc.index_add_(0, tgt, vecs.to(torch.float32))
        self.kept.index_add_(0, tgt, torch.ones_like(tgt, dtype=torch.int32))

    def _finalize_block(self) -> None:
        """Flush pending buckets and read the current block back once."""
        with span("extract.readback"):
            for key in list(self.pending):
                if self.pending[key]:
                    self._dispatch(key, self.pending[key])
                    self.pending[key] = []
            n = self.block_n
            if n == 0:
                return
            cap = self.block_cap
            res = self.acc[:cap]
            if self.multi:
                kept = torch.clamp(self.kept[:cap], min=1).to(torch.float32)
                res = l2_normalize(res / kept[:, None])
            self.blocks.append(res[:n].cpu().numpy())
        self.acc = None
        self.kept = None
        self.block_base += n
        self.block_n = 0

    def finish(self) -> np.ndarray:
        """Flush, finalize every block, return [N, D] in input order."""
        self._finalize_block()
        if not self.blocks:
            return np.zeros((0, self.outputdim or 0), np.float32)
        return np.concatenate(self.blocks, axis=0)


class _DeviceScaleAccumStream(_AccumStream):
    """Bucketed multi-scale extraction with on-device resize.

    Each image crosses to the device once at native resolution (padded
    into its bucket); every scale is then resized on the device with
    dense per-image triangle weights built from the extents (weights
    cover only the valid extent, so padding never bleeds in), extracted
    and accumulated.  The <36 px scale guard is applied on the host per
    image and scale and carried in the meta rows (``[B, 3 + 3S]``: valid
    h, w, owner, then per scale out h, out w, ok); skipped rows go to the
    trash row.  ``input_norm=(mean, std)`` ships raw uint8 and normalizes
    on the device before the resize.  Single-scale ``(1.0,)`` is
    supported: rows that need the <36 px upscale (or a snap to
    ``extent_multiple``) use a resize variant whose bucket is keyed by
    the resized shape.  With ``extent_multiple`` > 1 every scale, 1.0
    included, goes through the resize (the identity resize is exact) to
    its snapped extents, and each downscaled pad leaves half a multiple
    of margin for a snap that rounds up.
    """

    def __init__(self, extract_fn, bucket: int, batch_size: int, scales,
                 device: torch.device, block_cap: int = 8192,
                 pipeline_depth: int = 4, input_norm=None,
                 antialias: bool = True, extent_multiple: int = 1):
        super().__init__(extract_fn, bucket, batch_size, device,
                         block_cap=block_cap, pipeline_depth=pipeline_depth)
        self.antialias = antialias
        self.prep = fused_input_norm(input_norm)
        if input_norm is not None:
            self.in_dtype = np.uint8
        self.scales = tuple(scales)
        self.single = self.scales == (1.0,)
        self.multi = not self.single
        self.multiple = max(1, int(extent_multiple))

    def _key_and_task(self, owner: int, img: np.ndarray):
        vh, vw = img.shape[:2]
        if not self.single:
            return (self._q(vh), self._q(vw), "ms"), (owner, img, None)
        # single-scale: apply the upscale guard now so the bucket is keyed
        # by the post-resize shape
        nh, nw = vh, vw
        if vh < _MIN_SIDE or vw < _MIN_SIDE:
            f = max(_UPSCALE_TARGET / vh, _UPSCALE_TARGET / vw)
            nh, nw = int(round(vh * f)), int(round(vw * f))
        if self.multiple > 1:
            nh, nw = _snap(nh, self.multiple), _snap(nw, self.multiple)
        if (nh, nw) == (vh, vw):
            return (self._q(vh), self._q(vw), "direct"), (owner, img, None)
        return ((self._q(max(vh, nh)), self._q(max(vw, nw)), "resize"),
                (owner, img, (nh, nw)))

    def _meta_width(self) -> int:
        return 3 + 3 * len(self.scales)

    def _fill_meta(self, meta: np.ndarray, r: int, task) -> None:
        owner, img, single_out = task
        vh, vw = img.shape[:2]
        meta[r, 0:2] = (vh, vw)
        meta[r, 2] = owner - self.block_base
        for si, s in enumerate(self.scales):
            if self.single:
                nh, nw = single_out if single_out is not None else (vh, vw)
                ok = 1
            else:
                nh, nw = int(math.floor(vh * s)), int(math.floor(vw * s))
                ok = int(nh >= _MIN_SIDE and nw >= _MIN_SIDE)
                if ok and self.multiple > 1:
                    nh, nw = (_snap(nh, self.multiple),
                              _snap(nw, self.multiple))
            meta[r, 3 + 3 * si: 5 + 3 * si] = (nh, nw) if ok else (vh, vw)
            meta[r, 5 + 3 * si] = ok

    def _assemble(self, key: tuple, chunk, batch, meta) -> None:
        super()._assemble(key, chunk, batch, meta)
        # padding rows: full-extent scale feeds, every scale invalid
        for si in range(len(self.scales)):
            meta[len(chunk):, 3 + 3 * si] = key[0]
            meta[len(chunk):, 4 + 3 * si] = key[1]
            meta[len(chunk):, 5 + 3 * si] = 0

    def _pads(self, key: tuple):
        """Per scale: the static padded output size, and whether the scale
        feeds the bucket as it is (no resize)."""
        bh, bw, variant = key
        if variant in ("direct", "resize"):
            return [(bh, bw)], [variant == "direct"]
        mult = self.multiple
        margin = mult // 2 if mult > 1 else 0
        pads = [(bh, bw) if s >= 1.0 else
                (self._q(int(math.floor(bh * s)) + margin),
                 self._q(int(math.floor(bw * s)) + margin))
                for s in self.scales]
        return pads, [s == 1.0 and mult == 1 for s in self.scales]

    def _pixels(self, key: tuple, meta: np.ndarray, n: int):
        m = meta[:n].astype(np.int64)  # per scale: out h, out w, ok
        valid = int((m[:, 3::3] * m[:, 4::3] * m[:, 5::3]).sum())
        pads, _ = self._pads(key)
        return valid, self.batch_size * sum(h * w for h, w in pads)

    def _run(self, key: tuple, batch: torch.Tensor, meta: torch.Tensor):
        self._extract_scales(self.prep(batch), meta, *self._pads(key))

    def _extract_scales(self, x0: torch.Tensor, meta: torch.Tensor, pads,
                        direct) -> None:
        """Resize the normalized batch to every scale's extents (into its
        static pad), extract and accumulate."""
        vh, vw, owner = meta[:, 0], meta[:, 1], meta[:, 2]
        for si in range(len(self.scales)):
            oh = meta[:, 3 + 3 * si]
            ow = meta[:, 4 + 3 * si]
            ok = meta[:, 5 + 3 * si] > 0
            if direct[si]:
                vecs = self.extract_fn(x0, meta[:, 0:2])
            else:
                ohp, owp = pads[si]
                xs = _resize_batch(x0, vh, vw, oh, ow, ohp, owp,
                                   self.antialias)
                feed = torch.stack([torch.where(ok, oh, ohp),
                                    torch.where(ok, ow, owp)], dim=1)
                vecs = self.extract_fn(xs, feed)
            self._accumulate(torch.where(ok, owner, self.block_cap), vecs)


class _DctAccumStream(_DeviceScaleAccumStream):
    """Bucketed multi-scale extraction fed by entropy-decoded JPEGs.

    The host ships the top-left ``k x k`` quantized DCT coefficients of
    each block (``data.native_decode.JpegCoeffs``: int16, with fp32
    dequantization tables) through the pinned staging and the side-stream
    H2D copy; each batch is then decoded on the device
    (``ops.jpeg_decode.dct_decode_rgb``), its padding region zeroed (the
    RGB path's zero-padded canvas), normalized, resized to the thumbnail
    target times each scale through the dense per-image weights, extracted
    and accumulated.  Every scale goes through the resize (an identity
    resize is exact), because the target rarely equals the decoded
    canvas.  Wire bytes: ``(k*k/64) * 3`` per RGB-uint8 byte.

    RGB arrays in the same stream (non-JPEG files, boxed queries, files
    the coefficient decoder refuses) take the parent's buckets.  A
    coefficient bucket's key is ``("dct", canvas h, canvas w, target h,
    target w, subsamp, k, out_block)``; the bucket quantum rounds up to a
    multiple of 16, so that the chroma grid of a 4:2:0 canvas stays whole.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.bucket = -(-self.bucket // 16) * 16

    def _targets(self, item) -> list[tuple[int, int, int]]:
        """Per scale ``(out h, out w, ok)`` from the thumbnail target,
        with the host path's guards."""
        vh, vw = item.decoded_hw
        th, tw = item.target_hw or (vh, vw)
        out = []
        for s in self.scales:
            if self.single:
                nh, nw, ok = th, tw, 1
                if nh < _MIN_SIDE or nw < _MIN_SIDE:
                    f = max(_UPSCALE_TARGET / nh, _UPSCALE_TARGET / nw)
                    nh, nw = int(round(nh * f)), int(round(nw * f))
            else:
                nh, nw = int(math.floor(th * s)), int(math.floor(tw * s))
                ok = int(nh >= _MIN_SIDE and nw >= _MIN_SIDE)
            if ok and self.multiple > 1:
                nh, nw = _snap(nh, self.multiple), _snap(nw, self.multiple)
            out.append((nh, nw, ok) if ok else (th, tw, 0))
        return out

    def _key_and_task(self, owner: int, img):
        if not isinstance(img, JpegCoeffs):
            return super()._key_and_task(owner, img)
        n = img.out_block
        targets = self._targets(img)
        key = ("dct", self._q(img.coef_y.shape[0] * n),
               self._q(img.coef_y.shape[1] * n),
               self._q(max(t[0] for t in targets)),
               self._q(max(t[1] for t in targets)), img.subsamp, img.k, n)
        return key, (owner, img, None)

    def _pads(self, key: tuple):
        if key[0] != "dct":
            return super()._pads(key)
        pads, _ = super()._pads((key[3], key[4], "ms"))
        return pads, [False] * len(self.scales)  # every scale resizes

    def _specs(self, key: tuple) -> list:
        if key[0] != "dct":
            return super()._specs(key)
        _, cqh, cqw, _, _, ss, k, n = key
        B, Yb, Xb = self.batch_size, cqh // n, cqw // n
        f = 2 if ss == 2 else 1
        return [((B, Yb, Xb, k, k), np.int16),
                ((B, 2, Yb // f, Xb // f, k, k), np.int16),
                ((B, 2, k, k), np.float32),
                ((B, self._meta_width()), np.int32)]

    def _assemble(self, key: tuple, chunk, *bufs) -> None:
        if key[0] != "dct":
            return super()._assemble(key, chunk, *bufs)
        cy, cc, qt, meta = bufs
        cy.fill(0)
        cc.fill(0)
        qt.fill(1.0)
        # padding rows: full-canvas extents, every scale invalid -> trash
        meta[:] = self.block_cap
        meta[:, 0] = key[1]
        meta[:, 1] = key[2]
        for si, (ph, pw) in enumerate(self._pads(key)[0]):
            meta[:, 3 + 3 * si: 6 + 3 * si] = (ph, pw, 0)
        for r, (owner, item, _) in enumerate(chunk):
            yb, xb = item.coef_y.shape[:2]
            cy[r, :yb, :xb] = item.coef_y
            cby, cbx = item.coef_c.shape[1:3]
            cc[r, :, :cby, :cbx] = item.coef_c
            qt[r, 0] = item.quant_y
            qt[r, 1] = item.quant_c
            meta[r, 0:2] = item.decoded_hw
            meta[r, 2] = owner - self.block_base
            for si, t in enumerate(self._targets(item)):
                meta[r, 3 + 3 * si: 6 + 3 * si] = t

    def _run(self, key: tuple, *bufs) -> None:
        if key[0] != "dct":
            return super()._run(key, *bufs)
        _, cqh, cqw, _, _, ss, _, n = key
        cy_d, cc_d, qt_d, meta_d = bufs
        rgb = dct_decode_rgb(cy_d, cc_d, qt_d[:, 0], qt_d[:, 1], ss, n)
        # zero the padding region, as the RGB path's canvas is
        vh, vw = meta_d[:, 0], meta_d[:, 1]
        dev = rgb.device
        rows = torch.arange(cqh, device=dev)[None, :, None] < vh[:, None, None]
        cols = torch.arange(cqw, device=dev)[None, None, :] < vw[:, None, None]
        rgb = rgb * (rows & cols)[..., None]
        self._extract_scales(self.prep(rgb), meta_d, *self._pads(key))


def extract_vectors(
    extract_fn: Callable[..., torch.Tensor],
    images: Iterable[np.ndarray],
    scales: Sequence[float] = (1.0,),
    outputdim: int | None = None,
    print_freq: int = 0,
    bucket: int | None = 32,
    batch_size: int = 8,
    device_scales: bool = False,
    input_norm=None,
    block_cap: int = 8192,
    antialias: bool = True,
    pipeline_depth: int = 4,
    extent_multiple: int = 1,
    device="cuda",
    mesh=None,
    dct_decode: bool = False,
) -> np.ndarray:
    """Descriptors of a sequence of variable-resolution images.

    Bucketed (default): images are padded into resolution buckets and the
    model is called as ``extract_fn(images [B,H,W,3], valid_hw [B,2])``
    on ``device``.  Multi-scale resizes run on the host
    (``resize_bilinear_np``), or on the device with ``device_scales``.
    ``bucket=None`` groups exact shapes and calls ``extract_fn(images)``.

    Args:
      extract_fn: [B,H,W,3] (+ [B,2] valid_hw) -> [B,D] tensor.
      images: iterable of [H,W,3] arrays (float, or raw uint8 with
        ``input_norm``).
      scales: multi-scale factors (reference ms3: 1, 2^-1/2, 1/2).
      outputdim: descriptor dim returned for empty input.
      bucket: resolution quantum in pixels, or None for exact shapes.
      batch_size: fixed device batch per bucket (tail batches padded).
      device_scales: resize every scale on the device from one transfer
        of the native-resolution image.
      input_norm: (mean, std) in 0-1 scale; images are raw uint8 and are
        normalized on the device (requires ``device_scales``).
      block_cap: images per device accumulator block (one readback each).
      antialias: antialiased triangle downscale (jax.image.resize); False
        is the reference's plain 2-tap bilinear (F.interpolate).
      pipeline_depth: pinned staging slots (batches the host may run
        ahead of the device).
      extent_multiple: grid alignment of the model's masked path (the
        patch size of ViT / CLIP-ViT, 32 for ULTRON; models advertise it
        as ``model.extent_multiple``): every task's extents snap to the
        nearest multiple before bucketing, and the bucket quantum rounds
        up to a multiple.  Bucketed mode only.
      device: "cuda" (default) or "cpu".
      mesh: a ``parallel.mesh.Mesh``: every rank passes the same images,
        rank ``r`` of the data axis extracts images ``r, r + W, ...``
        through its own buckets, and every rank gets the descriptors in
        input order (each image is extracted alone, with its own masks,
        so they equal the single-process run's).
      dct_decode: the split JPEG decode: ``images`` may hold
        ``data.native_decode.JpegCoeffs`` (``ImageFromList(dct_coeffs=
        k)``), decoded on the device (``ops.jpeg_decode``) and resized to
        their ``target_hw`` times each scale, beside raw uint8 arrays
        (requires ``device_scales`` and ``input_norm``).

    Returns:
      [N, D] numpy descriptors in input order.
    """
    if mesh is not None:
        return _extract_over_ranks(
            mesh, extract_fn, images, scales=scales,
            outputdim=outputdim, print_freq=print_freq, bucket=bucket,
            batch_size=batch_size, device_scales=device_scales,
            input_norm=input_norm, block_cap=block_cap, antialias=antialias,
            pipeline_depth=pipeline_depth, extent_multiple=extent_multiple,
            device=device, dct_decode=dct_decode)
    dev = resolve_device(device)
    if dct_decode and (not device_scales or input_norm is None
                       or bucket is None):
        raise ValueError("dct_decode requires device_scales=True, input_norm "
                         "and bucketed mode (decode and normalization run "
                         "on the device)")
    if input_norm is not None and (not device_scales or bucket is None):
        raise ValueError("input_norm requires device_scales=True and "
                         "bucketed mode (uint8 images are normalized on "
                         "the device)")
    with torch.no_grad(), span("extract.vectors"):
        if bucket is None:
            imgs = [np.asarray(img) for img in images]
            if not imgs:
                return np.zeros((0, outputdim or 0), dtype=np.float32)
            return _extract_exact_shapes(extract_fn, imgs, scales, dev,
                                         print_freq=print_freq,
                                         antialias=antialias)
        if extent_multiple > 1:
            bucket = -(-bucket // extent_multiple) * extent_multiple
        multi = not (len(scales) == 1 and scales[0] == 1.0)
        if device_scales and (multi or input_norm is not None):
            cls = _DctAccumStream if dct_decode else _DeviceScaleAccumStream
            stream = cls(
                extract_fn, bucket, batch_size, scales, dev,
                block_cap=block_cap, pipeline_depth=pipeline_depth,
                input_norm=input_norm, antialias=antialias,
                extent_multiple=extent_multiple)

            def expand(i, img):  # scales resolve on the device; fail fast
                H, W = (img.target_hw or img.decoded_hw
                        if isinstance(img, JpegCoeffs) else img.shape[:2])
                if multi and all(math.floor(H * s) < _MIN_SIDE
                                 or math.floor(W * s) < _MIN_SIDE
                                 for s in scales):
                    raise ValueError(f"All scales {scales} shrink image {i} "
                                     f"({H}x{W}) below {_MIN_SIDE}px")
                return [(i, img)]
        else:
            stream = _AccumStream(extract_fn, bucket, batch_size, dev,
                                  block_cap=block_cap,
                                  pipeline_depth=pipeline_depth)
            stream.multi = multi
            expand = lambda i, img: _scale_tasks(
                i, img, scales, multiple=extent_multiple, antialias=antialias)
        in_dtype = stream.in_dtype
        n = 0
        for i, img in enumerate(_sourced(images)):
            if not (dct_decode and isinstance(img, JpegCoeffs)):
                img = np.asarray(img)
                if in_dtype == np.uint8 and img.dtype != np.uint8:
                    raise ValueError("input_norm expects raw uint8 images "
                                     f"(got {img.dtype} for image {i})")
                img = img.astype(in_dtype, copy=False)
            for owner, task in expand(i, img):
                stream.add(owner, task)
            n = i + 1
            if print_freq and n % print_freq == 0:
                print(f"\r>>>> {n}/? dispatched...", end="")
        if print_freq:
            print("")
        if n == 0:
            return np.zeros((0, outputdim or 0), dtype=np.float32)
        return stream.finish()


def _sourced(images: Iterable):
    """``images``, each wait on the next under ``extract.source``."""
    it = iter(images)
    while True:
        with span("extract.source"):
            img = next(it, _END)
        if img is _END:
            return
        yield img


def _extract_over_ranks(mesh, extract_fn, images, device, outputdim, **kw):
    """``extract_vectors`` with the images strided over the data ranks and
    the descriptors gathered (an ``all_reduce`` into a zero buffer, in
    which each rank fills its own rows: exact)."""
    group = mesh.group("data")
    size, index = mesh.shape["data"], mesh.coords["data"]
    mine = [img for i, img in enumerate(images) if i % size == index]
    vecs = extract_vectors(extract_fn, mine, device=device,
                           outputdim=outputdim, **kw)
    dev = resolve_device(device)
    counts = torch.zeros((size, 2), dtype=torch.float64, device=dev)
    counts[index] = torch.tensor([vecs.shape[0], vecs.shape[1]],
                                 dtype=torch.float64)
    all_reduce_(counts, group)
    n = int(counts[:, 0].sum())
    dim = int(counts[:, 1].max()) if n else (outputdim or 0)
    out = torch.zeros((n, dim), dtype=torch.float32, device=dev)
    if len(vecs):
        out[index::size] = torch.from_numpy(vecs).to(dev)
    all_reduce_(out, group)
    return out.cpu().numpy()


def _extract_exact_shapes(extract_fn, imgs: list[np.ndarray], scales,
                          device: torch.device, print_freq: int = 0,
                          antialias: bool = True) -> np.ndarray:
    """Exact-shape grouping (no masking): one batch per distinct shape."""
    groups: dict[tuple[int, int], list[tuple[int, np.ndarray]]] = {}
    for i, img in enumerate(imgs):
        groups.setdefault(img.shape[:2], []).append((i, img))
    n = len(imgs)
    out: list = [None] * n
    done = 0
    for items in groups.values():
        batch = torch.as_tensor(np.stack([im for _, im in items]),
                                dtype=torch.float32, device=device)
        vecs = multiscale_descriptor(extract_fn, batch, scales,
                                     antialias=antialias).cpu().numpy()
        for k, (i, _) in enumerate(items):
            out[i] = vecs[k]
        done += len(items)
        if print_freq and (done % print_freq == 0 or done == n):
            print(f"\r>>>> {done}/{n} done...", end="")
    if print_freq:
        print("")
    return np.stack(out)
