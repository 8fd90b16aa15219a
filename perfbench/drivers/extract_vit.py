"""Gallery indexing with a ViT global descriptor, as ``cli.extract
--model vit_b16`` runs it: one ``index.extract.extract_vectors`` call
over a stream of raw uint8 images, the extents snapped to the patch
size (``extent_multiple``) that ``_make_extract_fn`` reads off the
model.

The pool and the mix's parameters are the ``extract`` kind's
(``drivers/extract.py``), and so is the window but for its end: the
stream stops at the end of the first whole pass over the pool after
``--seconds``.  Each bucket then holds whole batches (in the index mix
every bucket's share of the 64-image pool is a multiple of the batch
of 8), so no padded tail batch is flushed into the window.  At this
model's rate a tail batch takes about a fifth of a second, and where
the clock stopped in the pool swung the window's length, and the rate,
by 4% between runs.

With ``--trace 1`` every ``ViTBlock.attn`` call runs inside a
benchmark-side ``record_function("perfbench.attention")`` span, so
whatever implements attention is timed by the device time of the
kernels launched inside it; while the stretch is active each call's
shape and key mask are kept, to count its work and its valid query-key
pairs after the stretch.

Correctness: every descriptor of the window against the reference's
(``reference/vit.py``) descriptor of its pool image, computed at the
image's own snapped size per scale (``desc_max_abs``: the largest
absolute difference of any component).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import inputs, inputs_vit, work, work_vit
from perfbench.drivers import common
from perfbench.drivers.extract import pool_sizes
from perfbench.harness import Outcome
from perfbench.reference import vit as ref
from perfbench.trace import Stretch

__all__ = ["AttentionSpans", "port_model", "run"]


def port_model(cfg: dict, weights: dict, device):
    """The port's registry model ``cfg["model"]`` holding ``weights``
    (strict), in eval mode on ``device``, built on the meta device; its
    widths are checked against the configuration's."""
    from research_image_retrieval_tpu_torch.models.registry import get_model

    with torch.device("meta"):
        model = get_model(cfg["model"], variant=cfg["variant"],
                          outputdim=cfg["outputdim"], p=cfg["gem_p"],
                          s=cfg["arcface_s"], m=cfg["arcface_m"],
                          num_classes=cfg["num_classes"],
                          img_size=cfg["img_size"], dtype=cfg["dtype"])
    bb = model.backbone
    got = {"dim": bb.dim, "depth": bb.depth, "patch": bb.patch,
           "heads": bb.block0.attn.num_heads,
           "mlp": bb.block0.mlp_fc1.out_features}
    want = {k: cfg[k] for k in got}
    if got != want:
        raise ValueError(f"variant {cfg['variant']!r} has widths {got}, "
                         f"the configuration states {want}")
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model.eval()


class AttentionSpans:
    """``record_function("perfbench.attention")`` around every block's
    attention of a ``VisionTransformer``; while ``stretch`` is active
    each call's ``[B, N, dim]`` shape and key mask are kept."""

    def __init__(self, model, cfg: dict, stretch, prefix="backbone."):
        self.stretch, self.heads = stretch, cfg["heads"]
        self.calls: list = []
        for i in range(cfg["depth"]):
            attn = model.get_submodule(f"{prefix}block{i}.attn")
            attn.forward = self._wrap(attn.forward)

    def _wrap(self, forward):
        def wrapped(x, *args, **kwargs):
            if self.stretch.active:
                mask = kwargs.get("key_mask", args[0] if args else None)
                self.calls.append((tuple(x.shape), mask))
            with torch.profiler.record_function("perfbench.attention"):
                return forward(x, *args, **kwargs)
        return wrapped

    def work(self) -> dict:
        """Operations, roofline seconds, calls and valid query-key pairs
        (every head's) of the calls made while the stretch was active,
        over each image's valid tokens."""
        ops = bound = 0.0
        pairs = 0
        for (B, N, dim), mask in self.calls:
            tokens = [N] * B if mask is None else \
                mask.detach().to("cpu", torch.int64).sum(dim=1).tolist()
            o, nbytes = work_vit.attention_call_work(tokens, dim)
            ops += o
            bound += work.roofline_s(o, nbytes)
            pairs += self.heads * sum(n * n for n in tokens)
        return {"ops": ops, "bound_s": bound, "calls": len(self.calls),
                "valid_pairs": pairs}


def _image_ops(cfg: dict, sizes, scales) -> list[float]:
    """Model operations per pool image over its scales, at its own
    snapped size."""
    out = []
    for h, w in sizes:
        hws = [ref.task_size(h, w, s, cfg["patch"]) for s in scales]
        out.append(sum(work_vit.vit_ops(cfg, *hw) for hw in hws if hw))
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
    weights = inputs_vit.vit_weights(
        cfg, inputs.sub_seed(cell.seed, "weights"), dev)
    model = port_model(cfg, weights, dev)
    del weights
    fn, _, multiple = _make_extract_fn(model, bucket=mix["bucket"])
    if multiple != cfg["patch"]:
        raise ValueError(f"extent_multiple {multiple}, patch {cfg['patch']}")
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
        spans = AttentionSpans(model, cfg, stretch)
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
            if now >= stop and i % P == 0:
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
                ops += work_vit.vit_ops(cfg, h, w)
        att = spans.work()
        att.update(summary["spans"].get("perfbench.attention", {}))
        obs = {"trace": summary, "stretch_ops": ops, "attention": att}
        busy = summary["busy_s"]
        share = att.get("device_s", 0.0) / busy if busy else 0.0
        notes.append(f"stretch {summary['window_s']:.3f} s, busy "
                     f"{busy:.3f} s, {summary['n_device_ops']} device ops, "
                     f"{len(feeds)} extract calls, attention {att}, "
                     f"attention share of busy {100 * share:.1f}%")
    per_image = _image_ops(cfg, sizes, scales)
    rate = sum(per_image[i % P] for i in range(n)) / (t1 - t0)
    notes.append(f"window {t1 - t0:.3f} s, {n} images, {rate / 1e12:.2f}"
                 f" TFLOP/s of model work, memory peak {peak}")
    del model, fn, spans
    common.free(dev)

    want = ref.descriptors(images, inputs_vit.vit_weights(
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
