"""Gallery indexing as ``cli.extract`` runs it: one
``index.extract.extract_vectors`` call over a stream of raw uint8 images.

The stream is a generator that cycles a pool of seeded renders and stops
yielding when ``--seconds`` have passed; ``extract_vectors`` consumes it
lazily, so the window is that one call, from its start until it returns
the descriptors of every image it took (its last buckets flushed and
read back).  ``index_img_per_s`` is those images over that time.

Mix parameters: ``pool`` images, ``longest`` side, ``aspect`` (long /
short side), every other image centre-cropped (alternately to
``crop_width`` of its width and ``crop_height`` of its height), half of
each kind portrait; ``scales``, ``bucket``, ``batch``; ``noise`` of the
renders; ``stretch_at`` (share of the window) and ``stretch_s`` of the
traced stretch.

Correctness: every descriptor of the window against the reference's
descriptor of its pool image, computed at the image's own size
(``desc_max_abs``: the largest absolute difference of any component).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import inputs, work
from perfbench.drivers import common
from perfbench.harness import Outcome
from perfbench.reference import resnet_gem as ref
from perfbench.trace import Stretch

__all__ = ["pool_sizes", "run"]


def pool_sizes(mix: dict) -> list[tuple[int, int]]:
    """The pool's (h, w), the same for every seed."""
    long_ = int(mix["longest"])
    short = int(round(long_ / mix["aspect"]))
    sizes = []
    for i in range(int(mix["pool"])):
        h, w = (short, long_) if i % 8 < 4 else (long_, short)
        if i % 4 == 1:
            w = int(w * mix["crop_width"])
        elif i % 4 == 3:
            h = int(h * mix["crop_height"])
        sizes.append((h, w))
    return sizes


def _image_ops(cfg: dict, sizes, scales) -> list[float]:
    """Model operations per pool image over its scales, at its own
    size (what the inputs need, not the padded bucket)."""
    out = []
    for h, w in sizes:
        macs = sum(work.retrieval_macs(cfg["depths"], *work.scale_size(h, w, s),
                                       whiten=cfg["outputdim"])
                   for s in scales
                   if min(work.scale_size(h, w, s)) >= 36)
        out.append(2.0 * macs)
    return out


def run(cell) -> Outcome:
    from research_image_retrieval_tpu_torch.evaluation.driver import (
        _make_extract_fn,
    )
    from research_image_retrieval_tpu_torch.index import extract as ix

    cfg, mix, dev = cell.config, cell.traffic, cell.device
    sizes = pool_sizes(mix)
    images = inputs.renders(sizes, inputs.sub_seed(cell.seed, "images"), dev,
                            noise=mix["noise"])
    weights = inputs.resnet_gem_weights(
        cfg, inputs.sub_seed(cell.seed, "weights"), dev)
    model = common.port_model(cfg, weights, dev)
    del weights
    fn, _, multiple = _make_extract_fn(model, bucket=mix["bucket"])
    scales = tuple(mix["scales"])
    kw = dict(scales=scales, bucket=mix["bucket"], batch_size=mix["batch"],
              device_scales=True, extent_multiple=multiple,
              input_norm=(np.array(inputs.IMAGENET_MEAN, np.float32),
                          np.array(inputs.IMAGENET_STD, np.float32)),
              device=dev)
    stretch = Stretch(dev)
    spans = feeds = None
    if cell.trace:
        stretch.prepare()
        spans = common.BlockSpans(model, cfg, stretch)
        feeds = []
        inner = fn

        def fn(x, valid_hw=None):  # noqa: F811 - the traced extract_fn
            if stretch.active:
                feeds.append(valid_hw)
            return inner(x, valid_hw)
    ix.extract_vectors(fn, images, **kw)           # warm every bucket
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

    P = len(images)
    t0 = time.perf_counter()
    stop = t0 + cell.seconds
    at = t0 + mix["stretch_at"] * cell.seconds

    def stream():
        i = 0
        while True:
            now = time.perf_counter()
            if now >= stop:
                return
            if cell.trace:
                if stretch.prof is None and now >= at:
                    stretch.start()
                elif stretch.active and now >= stretch.t0 + mix["stretch_s"]:
                    stretch.stop()
            yield images[i % P]
            i += 1

    vecs = ix.extract_vectors(fn, stream(), **kw)
    t1 = time.perf_counter()
    if stretch.active:
        stretch.stop()
    n = len(vecs)
    peak = common.memory_peak(dev)
    obs, notes = {}, []
    if cell.trace and stretch.prof is not None:
        summary = stretch.summary()
        ops = 0.0
        for feed in feeds:
            for h, w in feed.detach().to("cpu").tolist():
                ops += 2.0 * work.retrieval_macs(cfg["depths"], h, w,
                                                 whiten=cfg["outputdim"])
        b_ops, b_bound, b_calls = spans.work()
        obs = {"trace": summary, "stretch_ops": ops,
               "bottleneck": {"bound_s": b_bound, "ops": b_ops,
                              "calls": b_calls,
                              **summary["spans"].get("perfbench.bottleneck",
                                                     {})}}
        notes.append(f"stretch {summary['window_s']:.3f} s, "
                     f"{summary['n_device_ops']} device ops, "
                     f"{len(feeds)} extract calls, bottleneck calls "
                     f"{b_calls}, spans {obs['bottleneck']}")
    per_image = _image_ops(cfg, sizes, scales)
    notes.append(f"window {t1 - t0:.3f} s, {n} images, "
                 f"{sum(per_image[i % P] for i in range(n)) / (t1 - t0) / 1e12:.2f}"
                 f" TFLOP/s of model work, memory peak {peak}")
    del model, fn
    common.free(dev)

    want = ref.descriptors(images, inputs.resnet_gem_weights(
        cfg, inputs.sub_seed(cell.seed, "weights"), dev), cfg, scales,
        inputs.IMAGENET_MEAN, inputs.IMAGENET_STD, dev)
    gap = float(np.abs(vecs - want[np.arange(n) % P]).max()) if n else np.inf
    if not np.isfinite(vecs).all():
        gap = float("inf")
    return Outcome(
        attempted=n, failed=0,
        metrics={"index_img_per_s": n / (t1 - t0)},
        checks={"desc_max_abs": (gap, cell.limits["desc_max_abs"])},
        setup_end=t0, memory_peak_bytes=peak, obs=obs, notes=notes)
