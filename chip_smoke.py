#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; there is no fallback):
  1. the card's name and power limit, the torch and CUDA versions, and a
     build of every CUDA kernel from ``research_image_retrieval_tpu_torch/csrc``;
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes and the benchmark index cell's layer-3 shapes:
     one call between CUDA events (kernel and plain version alike, the
     ``ms`` and ``plain_ms`` of the summary), the kernel's device time
     per call (CUDA events around calls queued behind a device-side
     wait, ``device_ms``), each launch's device time (torch.profiler,
     printed only) beside its stream-K plan (CTAs, whole and split
     tiles), and its bounds; then (2-bf16) the
     bf16 forms: the bottleneck at the same 16 geometries and the head on
     bf16 maps at the three layer4 shapes, each against its plain
     version, timed, with the bound at 2-byte activations and the dense
     bf16 rate;
  3. the main path (bucketed ms3 extraction with on-device scales) on
     CUDA against the port's own CPU path, same seeded GeM-R50 weights;
  4. the serving slice at full width (ResNet-50, 2048-d, 1024 px ms3):
     synthetic Revisited fixture -> extract -> rank -> streaming top-k ->
     E/M/H mAP, with each kernel's launch count over this run and the
     bottleneck's output tiles and split tiles (some must be split);
  5. a warm timed extraction of 64 fixture images on the same path
     (steady img/s), then a torch.profiler pass over the same run: device
     time by kernel group and the device's busy share;
  6. the serving stack at full width through its entry points: the
     extract CLI indexes the fixture (JPEG files when OpenCV or PIL can
     encode them), a 1.4M x 2048 gallery is built on the card,
     ``SearchService`` (int8 and exact engines) is held against direct
     engine calls and timed under 1 and 8 clients, the HTTP front end
     answers vector and image queries through an ``ImageExtractor``, and
     the CLI path's mAP equals phase 4's; both kernels' launches are
     counted on the CLI step and on the HTTP / image step; 6.7
     ``cli.evaluate --iqe --superglobal`` on the fixture laid out as a
     Revisited dataset, against the same pipeline on 6.1's index;
  7. training on the card, under fp32 (TF32 off) as the trainer runs:
     7.1 the train step at full width (GeM-R50, 81,313-way ArcFace,
     512 px, TrainConfig's batch or the largest power of two that fits):
     ms per step, img/s, peak memory, TFLOP/s against the fp32 bound, a
     profiler breakdown, and one reduced step on the card against the CPU;
     7.1-bf16 the same step at ``compute_dtype=bfloat16`` against the bf16
     bound, beside the fp32 numbers;
     7.2 ``cli.train.main`` over an 81,313-way ``.rirrec`` file for 2
     epochs (img/s with the host pipeline, the busy share, the JSONL
     history), and a preemption stop + ``--resume`` bit-equal to the
     straight run inside ``deterministic_mode()``; 7.3 the rigorous
     synthetic task trained by ``train(cfg)``, its test images through
     both kernels (launches counted, held against the plain versions),
     accuracy and mAP beside the JAX record, and 7.3-bf16 the same at bf16
     (validation and extraction through both kernels' bf16 forms);
  8. gem_r101 and gem_r50 with ``dilation_block5`` at full width: CUDA
     against the CPU path, the phase-4 fixture's img/s and mAP, and the
     launches per backbone pass (29 and 10);
  9. the ResNet zoo presets at full width: 9.1 dolg_r101, solar_r101 and
     delg_r50 as phase 8 (bottleneck / head launches per pass 29 / 0,
     29 / 0 and 12 / 1); 9.2 ``cli.evaluate --model delg_r50
     --local-rerank`` on the fixture as a Revisited dataset: its ranks
     against the direct pipeline's, and every shortlisted pair's inlier
     count on the card against the CPU's;
 10. the next zoo presets at full width: 10.1 spca_r101, sosnet_r50,
     spoc_r50, senet_g2_r50 and adaptive_hybrid_r50 as phase 9.1
     (bottleneck / head launches per pass 29 / 1, 12 / 0, 12 / 0, 0 / 0
     and 12 / 0); 10.2 ``index.HybridGallery`` (QAFF fusion) on the card
     with 10.1's adaptive_hybrid_r50: 128 fixture images at 512 px added,
     16 queries searched at top 100 against the port's CPU gallery, the
     add and per-search times;
 11. the rest of the ResNet zoo and CVNet's rerank: 11.1 token_r101,
     how_vlad_r50 and how_asmk_r50 as phase 9.1 (bottleneck / head
     launches per pass 29 / 0, 12 / 0, 12 / 0; ASMK's CUDA-vs-CPU check
     allows near-tied selections only, each printed); 11.2
     ``cli.evaluate --model gem_r50 --multiscale --cvnet-rerank`` on the
     fixture as a Revisited dataset with a seeded ResNet-50 CVNet: ranks
     against the direct pipeline's, 12 bottleneck launches per feature-map
     pass, every shortlisted pair's score on the card against the CPU's,
     the scorer's time per 16-pair chunk at 224 and 512 px and its peak
     memory at 512;
 12. the transformer step: 12.1 ultron_s, vit_b16, clip_vit_b32 and
     clip_r50 as phase 9.1, extents snapped to each model's
     ``extent_multiple`` (32, 16, 32, 1), with the peak memory above
     what was allocated before (bottleneck / head launches per tower pass 0 / 0 but clip_r50's
     12 / 0; ULTRON's CUDA-vs-CPU check allows a CDConv rate to differ
     only next to a threshold, each printed); 12.2 ``cli.evaluate --model
     ultron_s`` and ``cli.extract --model clip_r50`` on the fixture as a
     Revisited dataset against the direct pipeline, the extents the model
     saw printed, and ``ImageExtractor`` answering an image query with
     vit_b16 through its multiple 16;
 13. the research prototypes: 13.1 spectrum_r50, iris_r50, sparse_r50
     and hamlet_r50 as phase 9.1 (12 bottleneck and 0 head launches per
     backbone pass; IRIS's gates and SPARSE's k, mask, bits and codes
     compared first, the CPU run at the card's, a difference allowed
     only within 1e-4 of its threshold and printed); 13.2 each one's
     train step on the card against the CPU (``check_cuda_train_step``),
     SPARSE and HAMLET with a seeded teacher table on the card; 13.3 the
     same for ultron_s (an AdamW step, then an SGD step after the
     hand-off), token_r101 (under ``device_check.RULES``: its zero
     running mean at the zero-leaf bar, grad_norm against the CPU's
     measured floor, printed) and spca_r101;
 14. multi-GPU (``parallel/``) on the one card: 14.1 NCCL at world size
     1 (``init_distributed_mode(force=True)``): 7.1's step at full width
     through ``make_train_step(mesh=...)`` against the plain step, three
     steps from one init inside ``deterministic_mode()`` (parameters
     within 1e-6 of their change; equal by design), and ms per step of
     both; 14.2 ``parallel.dryrun_worker`` as two gloo ranks sharing the
     card: the float64 train steps on (2, 1) and (1, 2) against the
     single-device step at ``device_check``'s size (and one (2, 1) step
     each of iris_r50 and spectrum_r50, whose batch-wide operations see
     the gathered global batch), the cross-process
     sharded search, and rank-sharded extraction of 16 fixture images at
     full width (gem_r50, 1024 px ms3) against the single-process run
     (descriptors within 1e-5, mAP equal, the ranks' kernel launches
     summing to the single run's); 14.3 ``SearchService`` over the 1.4M x
     2048 gallery sharded over ``["cuda:0"] * 4`` against the unsharded
     service, exact (bf16 store) and int8: ids, scores and p50 at one
     client;
 15. the split JPEG decode: ``cli.evaluate --model gem_r50 --multiscale
     --dct-decode 4`` at full width on the phase-4 fixture's JPEGs laid
     out as a Revisited dataset, plus a progressive JPEG and a 2,100 px
     source in the gallery; the host half (the port's own entropy
     decoder, built with g++, no libjpeg) against OpenCV's full decode,
     the device half against the CPU's, every gallery file on the
     coefficient path, the launches against the bucket plan's, two
     descriptors against the CPU path, the mAP, the cosine to the RGB
     path, the host decode ms, the wire bytes and img/s.
Every zoo phase's CUDA-vs-CPU comparison runs its two images in batches
of two (no all-padding rows).  Phases 9-13 run the zoo fixture, 8
classes x 8 at 1024 px (``ZOO_CLASSES``, half of phase 4's), warmed on
its first 8 images, so that the script stays inside its time limit.
The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Needs a CUDA device and the repo.
"""

from __future__ import annotations

import collections
import copy
import functools
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SCALES = (1.0, 2 ** -0.5, 0.5)
FP32_PEAK = 67e12   # H100 SXM fp32 (non-tensor) FLOP/s, NVIDIA data sheet
TF32X3_PEAK = 495e12 / 3  # fp32-accurate products as three TF32 products
BF16_PEAK = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s, data sheet
HBM_RATE = 3.35e12  # H100 SXM HBM3 bytes/s
R50_IDENTITY = ((256, 64, 256, 2), (512, 128, 128, 3),
                (1024, 256, 64, 5), (2048, 512, 32, 2))  # C, Cw, side, blocks
BUCKETS = (1024, 768, 512)  # the 128 px buckets of 1024 px ms3 images
# the benchmark's index cell at layer 3 (B=8): M = 24576, 18432, 15360,
# 12288, 9216, 6144, 4608 over its six buckets at scales 1, 2^-1/2, 1/2
INDEX_LAYER3 = ((48, 64), (48, 48), (40, 48), (48, 32), (24, 48), (24, 32),
                (24, 24))


def check_close(name, got, want, rtol, atol):
    """Raise unless |got - want| <= atol + rtol * |want|; return max err."""
    err = (got.double() - want.double()).abs()
    bad = err > atol + rtol * want.double().abs()
    if bool(bad.any()) or not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: max |err| {err.max().item():.3e} "
                             f"exceeds rtol {rtol} atol {atol}")
    return err.max().item()


def cuda_ms(torch, fn, iters=10, warmup=2):
    """Median milliseconds of ``fn()`` over ``iters`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(flops, nbytes, peak=FP32_PEAK):
    ops_ms = flops / peak * 1e3
    bytes_ms = nbytes / HBM_RATE * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def device_ms(torch, fn, calls=20, reps=3, tries=4):
    """Device milliseconds per call of ``fn()``, median of ``reps``: CUDA
    events around ``calls`` calls that the host queues while the stream
    is held by a device-side wait (``torch.cuda._sleep``), so the card
    runs them back to back whatever the host's speed.  A rep whose wait
    ended before the host had queued every call is made again with a
    four times longer wait, up to ``tries`` times; then this raises."""
    fn()
    torch.cuda.synchronize()
    cycles, times = 10_000_000, []  # ~5 ms at 2 GHz
    while len(times) < reps:
        for _ in range(tries):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            a.record()
            for _ in range(calls):
                fn()
            b.record()
            held = not a.query()  # the first call had not started yet
            b.synchronize()
            if held:
                times.append(a.elapsed_time(b) / calls)
                break
            cycles *= 4
        else:
            raise AssertionError(f"the host did not queue {calls} calls "
                                 f"within a wait of {cycles} cycles")
    return statistics.median(times)


def launch_breakdown(torch, fn, names, labels, iters=5, passes=5):
    """Each launch's device time from torch.profiler (CUPTI), as text to
    print beside ``device_ms`` and for nothing else: the mean duration of
    each of ``fn()``'s launches in launch order, one per entry of
    ``labels`` (a launch that starts early and waits for the one before
    it counts its wait), and the union of their intervals per call, over
    ``iters`` calls.  The kernels are those whose names contain one of
    ``names``.  CUPTI drops records now and then, so a pass that misses
    any launch is run again, up to ``passes`` times; after that the text
    says "not measured" and gives each pass's count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    per_call = len(labels)
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(passes):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        ev = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and any(n in e.name for n in names)),
                    key=lambda e: e.time_range.start)
        seen.append(len(ev))
        if len(ev) == iters * per_call:
            break
    else:
        return (f"launches {' / '.join(labels)} not measured: the profiler "
                f"recorded {seen} of {iters * per_call} launches")
    per = [sum(e.time_range.end - e.time_range.start
               for e in ev[i::per_call]) / iters / 1e3
           for i in range(per_call)]
    span = _union_ms([(e.time_range.start, e.time_range.end)
                      for e in ev]) / iters
    return (f"launches {' / '.join(labels)} {fmt_ms(per)} ms, union "
            f"{span:.4f} ms, profiler")


def fmt_ms(values):
    return " / ".join(f"{v:.4f}" for v in values)


def back_to_back_ms(torch, fn, calls=200):
    """Milliseconds per call of ``calls`` calls issued without a wait:
    the device time when the host keeps ahead, else the host's time per
    call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def tensor_core_sass(path):
    """The tensor-core instruction forms in a built library's SASS, with
    their counts (``cuobjdump -sass``)."""
    exe = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(exe):
        return "cuobjdump not found (not measured)"
    sass = subprocess.run([exe, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    forms = collections.Counter(re.findall(r"\b((?:HGMMA|HMMA)\.[\w.]+)",
                                           sass))
    return ", ".join(f"{k} x{n}" for k, n in sorted(forms.items())) or "none"


def procedural_images(sizes, seed):
    """Smooth multi-frequency fields plus noise, as uint8 photos."""
    rng = np.random.default_rng(seed)
    out = []
    for h, w in sizes:
        yy, xx = np.linspace(0, 1, h)[:, None], np.linspace(0, 1, w)[None, :]
        chans = []
        for _ in range(3):
            f1, f2, p1, p2 = rng.uniform(2, 9, 4)
            chans.append(np.sin(2 * np.pi * (f1 * xx + p1))
                         + np.cos(2 * np.pi * (f2 * yy + p2)))
        img = np.stack(chans, -1) + 0.25 * rng.standard_normal((h, w, 3))
        img = (img - img.min()) / (img.max() - img.min())
        out.append(np.round(img * 255).astype(np.uint8))
    return out


def serving_fixture(num_classes: int, image_size: int):
    """(images, labels) of the synthetic Revisited fixture as a server
    sees it: ``num_classes`` x 8 raw uint8 renders (seed 7); every other
    image loses 30% of its width or 40% of its height (alternating),
    centred, so that buckets pad and masks matter."""
    from research_image_retrieval_tpu_torch.data import (
        SyntheticRetrievalDataset,
    )

    ds = SyntheticRetrievalDataset(num_classes=num_classes,
                                   samples_per_class=8,
                                   image_size=image_size, seed=7, uint8=True)
    imgs = []
    for i in range(len(ds)):
        img = ds[i][0]
        if i % 2:
            H, W = img.shape[:2]
            h, w = (H, int(W * 0.7)) if i % 4 == 1 else (int(H * 0.6), W)
            top, left = (H - h) // 2, (W - w) // 2
            img = np.ascontiguousarray(img[top:top + h, left:left + w])
        imgs.append(img)
    return imgs, ds.labels


def serving_slice(model, imgs, labels, scales, bucket: int, k: int,
                  device: str, extent_multiple: int = 1) -> dict:
    """The serving path on ``device``: raw uint8 images normalised and
    resized on the device (``extract_vectors``, extents snapped to the
    model's ``extent_multiple``), the full ranking
    (``rank_full``), each query's top-``k`` (``streaming_topk``, exact),
    and the Revisited E/M/H mAP (the first image of each class of 8 is a
    query; ``k`` at most the image count).  Raises unless the descriptors
    are finite unit vectors and the top-k ids equal the ranking's head
    wherever scores are distinct.
    """
    from research_image_retrieval_tpu_torch.data import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        make_synthetic_gnd,
    )
    from research_image_retrieval_tpu_torch.evaluation import (
        compute_map_and_print,
    )
    from research_image_retrieval_tpu_torch.index import (
        extract_vectors,
        rank_full,
    )
    from research_image_retrieval_tpu_torch.ops.topk_stream import (
        streaming_topk,
    )

    t0 = time.perf_counter()
    vecs = extract_vectors(lambda x, v: model.extract(x, v), imgs,
                           scales=scales, bucket=bucket, device_scales=True,
                           input_norm=(IMAGENET_MEAN, IMAGENET_STD),
                           extent_multiple=extent_multiple, device=device)
    extract_s = time.perf_counter() - t0  # ends in the host readback
    if vecs.shape[0] != len(imgs) or not np.isfinite(vecs).all():
        raise AssertionError(f"descriptors: shape {vecs.shape}, finite "
                             f"{np.isfinite(vecs).all()}")
    norms = np.linalg.norm(vecs, axis=1)
    if np.abs(norms - 1).max() > 1e-4:
        raise AssertionError(f"descriptors not unit norm: {norms}")
    q_idx = np.arange(0, len(imgs), 8)
    ranks = rank_full(vecs[q_idx], vecs, device=device)
    k = min(k, len(imgs))
    s, ids = streaming_topk(vecs[q_idx], vecs, k=k, device=device)
    gap = np.abs(np.diff(s, axis=1))
    distinct = np.ones_like(s, bool)
    distinct[:, 1:] &= gap > 1e-5
    distinct[:, :-1] &= gap > 1e-5
    same = ids == ranks[:k].T
    if not same[distinct].all():
        raise AssertionError("streaming_topk ids differ from rank_full on "
                             f"{int((~same & distinct).sum())} distinct scores")
    mAP = compute_map_and_print("roxford5k", "global", "synthetic", ranks,
                                make_synthetic_gnd(labels, q_idx),
                                kappas=[1, 5, 10])
    return dict(mAP=mAP, vecs=vecs, extract_s=extract_s,
                n_distinct=int(distinct.sum()))


HEAD_LAUNCHES = ("gem_pool_kernel", "project_kernel", "l2norm_kernel")
BOTTLENECK_LAUNCHES = ("conv_gemm_tf32x3",)  # conv1, conv2, conv3 in order


def phase_gem_head(torch, gh):
    """Kernel 1 at the main path's head shapes: the layer4 maps of the
    three buckets (32, 24, 16 px sides) x 2048 -> 2048, B=8 and B=1, and
    a 48 px map (checked only), larger than any the main path makes.
    The timed form is extract()'s (fp32 weight, extents): its bound counts
    the feature-map bytes of the valid cells only, as the kernel reads
    only those."""
    g = torch.Generator(device="cuda").manual_seed(1)
    C = D = 2048
    weight = torch.randn(D, C, device="cuda", generator=g) / math.sqrt(C)
    bias = 0.01 * torch.randn(D, device="cuda", generator=g)

    def inputs(B, side):
        fmap = torch.randn(B, side, side, C, device="cuda", generator=g).abs()
        ext = torch.randint(1, side + 1, (B, 2), device="cuda", generator=g,
                            dtype=torch.int32)
        mask = (torch.rand(B, side, side, device="cuda", generator=g)
                > 0.3).float()
        return fmap, ext, mask

    fmap, ext, mask = inputs(8, 32)
    p_dev = torch.tensor([3.0], device="cuda")  # a learnable p's form
    fp32 = dict(weight_dtype=torch.float32)
    cases = [  # (name, fmap, kwargs, rtol, atol)
        ("fp32", fmap, fp32, 1e-5, 1e-6),
        ("fp32+extents", fmap, dict(fp32, extents=ext), 1e-5, 1e-6),
        ("fp32+mask", fmap, dict(fp32, valid_hw=mask), 1e-5, 1e-6),
        ("fp32+extents, p on the card", fmap,
         dict(fp32, extents=ext, p=p_dev), 1e-5, 1e-6),
        ("fp32+extents, p=2.5 on the card", fmap,
         dict(fp32, extents=ext, p=torch.tensor([2.5], device="cuda")),
         1e-5, 1e-6),
        ("bf16", fmap, dict(weight_dtype=torch.bfloat16), 0.0, 5e-3),
        ("bf16+extents", fmap, dict(weight_dtype=torch.bfloat16, extents=ext),
         0.0, 5e-3),
    ]
    for B, side in ((8, 24), (8, 16), (1, 32), (1, 16), (2, 48)):
        f, e, m = inputs(B, side)
        cases.append((f"fp32+extents B={B} {side}x{side}", f,
                      dict(fp32, extents=e, p=p_dev), 1e-5, 1e-6))
        cases.append((f"fp32+mask B={B} {side}x{side}", f,
                      dict(fp32, valid_hw=m), 1e-5, 1e-6))
    max_err = 0.0
    for name, f, kw, rtol, atol in cases:
        got = gh.gem_whiten_l2(f, weight, bias, **kw)
        want = gh.gem_whiten_l2_reference(f, weight, bias, **kw)
        torch.cuda.synchronize()
        err = check_close(f"gem_head[{name}]", got, want, rtol, atol)
        max_err = max(max_err, err)
        print(f"gem_head[{name}] max|err| {err:.3e} (rtol {rtol}, atol {atol})")
    rows = {}
    for side in (32, 24, 16):  # extract()'s form: fp32 weight, extents
        B = 8
        f, e, _ = inputs(B, side) if side != 32 else (fmap, ext, None)
        run = lambda: gh.gem_whiten_l2(f, weight, bias, extents=e, **fp32)
        dev = device_ms(torch, run)
        launches = launch_breakdown(torch, run, HEAD_LAUNCHES,
                                    ("pool", "project", "l2norm"))
        ms = cuda_ms(torch, run)
        b2b = back_to_back_ms(torch, run)
        plain = cuda_ms(torch, lambda: gh.gem_whiten_l2_reference(
            f, weight, bias, extents=e, **fp32))
        cells = int((e[:, 0].clamp(0, side) * e[:, 1].clamp(0, side)).sum())
        flops = cells * C * 3 + 2 * B * C * D + 3 * B * D
        nbytes = 4 * (cells * C + D * C + D + 2 * B + B * D)
        bnd, by = bound_ms(flops, nbytes)
        print(f"gem_head B={B} {side}x{side}x{C}->{D} fp32+extents "
              f"({cells} of {B * side * side} cells valid): kernel {ms:.4f} "
              f"ms per call between CUDA events (host launch time included), "
              f"{dev:.4f} ms on the device ({launches}), {b2b:.4f} ms per "
              f"call back to back; "
              f"plain {plain:.4f} ms, bound {bnd:.4f} ms ({by})")
        rows[side] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain,
                          bound_ms=bnd, bound_by=by, device_ms=dev)
    return rows[32]


def bottleneck_inputs(torch, rb, g, B, h, w, C, Cw):
    """Seeded block inputs: x, the six weights, and extents that cut the
    second image onwards."""
    def rn(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=g) * scale

    def sb(n):
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(
            n, device="cuda", generator=g)
        return rb.fold_bn(u(0.5, 1.5), u(-0.2, 0.2), u(-0.1, 0.1),
                          u(0.5, 2.0)).contiguous()

    x = rn(B, h, w, C, scale=0.5)
    ws = (rn(C, Cw, scale=C ** -0.5), sb(Cw),
          rn(3, 3, Cw, Cw, scale=(9 * Cw) ** -0.5), sb(Cw),
          rn(Cw, C, scale=Cw ** -0.5), sb(C))
    ext = torch.tensor([[h, w]] + [[h * 3 // 4 + 1, w // 2 + 3]] * (B - 1),
                       device="cuda", dtype=torch.int32)
    return x, ws, ext


def check_bottleneck(torch, rb, label, x, ws, ext):
    """The kernel against its plain version, without and with extents.

    Tolerance: the kernel's 3xTF32 products carry fp32's accuracy and each
    32-deep slice is summed on the tensor cores (which truncate) before an
    fp32 add; the sums of up to 9 * 512 products run in another order than
    cuDNN / cuBLAS, a few 1e-6 on O(1) outputs, so atol 1e-4 (rtol 1e-5)
    leaves more than an order of magnitude."""
    err = 0.0
    for tag, e in (("", None), ("+extents", ext)):
        got = rb.fused_bottleneck(x, *ws, extents=e)
        want = rb.fused_bottleneck_reference(x, *ws, extents=e)
        torch.cuda.synchronize()
        err = max(err, check_close(f"bottleneck[{label}{tag}]", got, want,
                                   1e-5, 1e-4))
    print(f"bottleneck[{label}] max|err| {err:.3e} without and with extents "
          f"(rtol 1e-5, atol 1e-4)")
    return err


def _plan_text(plan):
    """The stream-K plan of the bottleneck's last fp32 call, as text."""
    cols = list(zip(*plan))
    return (f"plan conv1 / conv2 / conv3: CTAs {'/'.join(map(str, cols[0]))}"
            f", whole tiles {'/'.join(map(str, cols[1]))}, split tiles "
            f"{'/'.join(map(str, cols[2]))}")


def phase_bottleneck(torch, rb, fp32_precision):
    """Kernel 2 at the shapes the main path launches: B=8 at the four R50
    identity stages of the three buckets (1024 / 768 / 512 px), B=2 at
    1024 px (the rows of earlier runs), and the index cell's layer-3
    geometries (C=1024, B=8 at M = 24576 ... 4608: its six buckets at
    scales 1, 2^-1/2 and 1/2).  Each geometry is checked against the
    plain version, without and with extents, and so are two that stress
    the tiling (M = 494, not a multiple of a tile).  Timed per geometry:
    one call between CUDA events, kernel and plain version alike (the
    wrapper's host time shows there when it exceeds the device's), the
    kernel's device time (``device_ms``) and each of its three launches
    (profiler) beside each launch's stream-K plan (CTAs, whole and split
    tiles), and, as a yardstick the port never calls, torch.matmul (fp32,
    TF32 off) on conv1's and conv3's GEMM shapes.  The bound counts conv1
    on the valid rows only (the extents zero the rest of its output);
    conv2 and conv3 run on every row."""
    g = torch.Generator(device="cuda").manual_seed(2)
    max_err = 0.0
    for C, Cw in ((256, 64), (2048, 512)):
        x, ws, ext = bottleneck_inputs(torch, rb, g, 2, 19, 13, C, Cw)
        max_err = max(max_err, check_bottleneck(
            torch, rb, f"B=2 C={C} Cw={Cw} 19x13", x, ws, ext))
    geoms = [(2, C, Cw, side, side, nblk, f"{1024} px")
             for C, Cw, side, nblk in R50_IDENTITY]
    geoms += [(8, C, Cw, side * px // 1024, side * px // 1024, nblk,
               f"{px} px") for px in BUCKETS
              for C, Cw, side, nblk in R50_IDENTITY]
    geoms += [(8, 1024, 256, h, w, 0, "index cell layer 3")
              for h, w in INDEX_LAYER3]
    tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0,
               fma_bound_ms=0.0)
    by_all = set()
    for B, C, Cw, h, w, nblk, what in geoms:
        x, ws, ext = bottleneck_inputs(torch, rb, g, B, h, w, C, Cw)
        label = f"B={B} C={C} Cw={Cw} {h}x{w} ({what})"
        max_err = max(max_err, check_bottleneck(torch, rb, label, x, ws,
                                                ext))
        run = lambda: rb.fused_bottleneck(x, *ws, extents=ext)
        ms = cuda_ms(torch, run)
        plan = _plan_text(rb.fused_bottleneck.last_plan)
        plain = cuda_ms(torch, lambda: rb.fused_bottleneck_reference(
            x, *ws, extents=ext))
        dev = device_ms(torch, run)
        launches = launch_breakdown(torch, run, BOTTLENECK_LAUNCHES,
                                    ("conv1", "conv2", "conv3"))
        M = B * h * w
        Mv = int((ext[:, 0].clamp(0, h) * ext[:, 1].clamp(0, w)).sum())
        a1, a3 = x.reshape(M, C), torch.rand(M, Cw, device="cuda",
                                             generator=g)
        with fp32_precision():
            mm = [cuda_ms(torch, lambda: torch.matmul(a1, ws[0])),
                  cuda_ms(torch, lambda: torch.matmul(a3, ws[4]))]
        flops = 2 * (Mv + M) * C * Cw + 18 * M * Cw * Cw + 6 * M * C
        nbytes = 4 * (2 * M * C + 2 * C * Cw + 9 * Cw * Cw + 4 * Cw
                      + 2 * C) + 8 * B
        bnd, by = bound_ms(flops, nbytes, TF32X3_PEAK)
        fma, _ = bound_ms(flops, nbytes)
        print(f"bottleneck {label}: kernel {ms:.4f} ms per call between "
              f"CUDA events, {dev:.4f} ms on the device ({launches}; "
              f"{plan}), plain {plain:.4f} ms, bound "
              f"{bnd:.4f} ms at 3xTF32 ({by}), {fma:.4f} ms at fp32 FMA, "
              f"{flops / dev / 1e9:.1f} TFLOP/s on the device; torch.matmul "
              f"conv1 / conv3 shape {fmt_ms(mm)} ms")
        if B == 2:
            tot["ms"] += nblk * ms
            tot["device_ms"] += nblk * dev
            tot["plain_ms"] += nblk * plain
            tot["bound_ms"] += nblk * bnd
            tot["fma_bound_ms"] += nblk * fma
            by_all.add(by)
        del x, ws, a1, a3
    print(f"bottleneck, 12 identity blocks of one R50 pass (B=2, 1024 px): "
          f"kernel {tot['ms']:.4f} ms in calls between CUDA events, "
          f"{tot['device_ms']:.4f} ms on the device, plain "
          f"{tot['plain_ms']:.4f} ms, "
          f"bound {tot['bound_ms']:.4f} ms at 3xTF32, "
          f"{tot['fma_bound_ms']:.4f} ms at fp32 FMA")
    return dict(max_abs_err=max_err, ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=tot["bound_ms"],
                bound_by="bytes" if by_all == {"bytes"} else "operations",
                device_ms=tot["device_ms"])


def phase_bf16_kernels(torch, gh, rb) -> dict:
    """Phase 2-bf16: the bf16 forms of both kernels at the main path's
    shapes.  The bottleneck at the 16 geometries of phase 2 (the four R50
    identity stages at B=2, 1024 px, and at B=8 in the three buckets),
    with extents, and the head on a bf16 map at the three layer4 shapes
    (B=8, extents, fp32 weight).  Bar: the kernel's error against the
    fp32 plain version (the same bf16-rounded inputs, fp32 throughout) is
    no worse than 1.5x the bf16 plain version's own; the head holds to
    its plain version at rtol 1e-5 / atol 1e-6 (both pool the upcast map
    in fp32).  Timed as phase 2: one call between CUDA events (kernel and
    bf16 plain version) and the device time per call; the bound counts
    2-byte activations and weights (fp32 affines) and the dense bf16
    tensor-core rate."""
    g = torch.Generator(device="cuda").manual_seed(12)
    bf = torch.bfloat16
    geoms = [(2, C, Cw, side, nblk, 1024)
             for C, Cw, side, nblk in R50_IDENTITY]
    geoms += [(8, C, Cw, side * px // 1024, nblk, px)
              for px in BUCKETS for C, Cw, side, nblk in R50_IDENTITY]
    tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    by_all, worst, max_diff = set(), 0.0, 0.0
    for B, C, Cw, side, nblk, px in geoms:
        x, ws, ext = bottleneck_inputs(torch, rb, g, B, side, side, C, Cw)
        xb = x.to(bf)
        del x
        label = f"B={B} C={C} Cw={Cw} {side}x{side} ({px} px)"
        got = rb.fused_bottleneck(xb, *ws, extents=ext)
        plain = rb.fused_bottleneck_reference(xb, *ws, extents=ext)
        f32 = rb.fused_bottleneck_reference(xb.float(), *ws, extents=ext)
        torch.cuda.synchronize()
        if got.dtype != bf or not bool(got.isfinite().all()):
            raise AssertionError(f"bottleneck bf16 [{label}]: dtype "
                                 f"{got.dtype} or non-finite output")
        e_k = (got.double() - f32.double()).abs().max().item()
        e_p = (plain.double() - f32.double()).abs().max().item()
        d_kp = (got.double() - plain.double()).abs().max().item()
        if e_k > 1.5 * e_p:
            raise AssertionError(f"bottleneck bf16 [{label}]: kernel vs fp32 "
                                 f"{e_k:.3e} > 1.5 x plain bf16 vs fp32 "
                                 f"{e_p:.3e}")
        worst = max(worst, e_k / e_p)
        max_diff = max(max_diff, d_kp)
        del got, plain, f32
        run = lambda: rb.fused_bottleneck(xb, *ws, extents=ext)
        ms = cuda_ms(torch, run)
        plain_ms = cuda_ms(torch, lambda: rb.fused_bottleneck_reference(
            xb, *ws, extents=ext))
        dev = device_ms(torch, run)
        M = B * side * side
        Mv = int((ext[:, 0].clamp(0, side) * ext[:, 1].clamp(0, side)).sum())
        flops = 2 * (Mv + M) * C * Cw + 18 * M * Cw * Cw + 6 * M * C
        nbytes = (2 * (2 * M * C + 2 * C * Cw + 9 * Cw * Cw)
                  + 4 * (4 * Cw + 2 * C) + 8 * B)
        bnd, by = bound_ms(flops, nbytes, BF16_PEAK)
        print(f"bottleneck bf16 {label}: kernel vs fp32 {e_k:.3e}, plain "
              f"bf16 vs fp32 {e_p:.3e} (bar 1.5x), kernel vs plain bf16 "
              f"{d_kp:.3e}; kernel {ms:.4f} ms per call between CUDA events, "
              f"{dev:.4f} ms on the device, plain {plain_ms:.4f} ms, bound "
              f"{bnd:.4f} ms at bf16 ({by}), {flops / dev / 1e9:.1f} TFLOP/s "
              "on the device")
        if B == 2:
            tot["ms"] += nblk * ms
            tot["device_ms"] += nblk * dev
            tot["plain_ms"] += nblk * plain_ms
            tot["bound_ms"] += nblk * bnd
            by_all.add(by)
        del xb, ws
    print(f"bottleneck bf16, 12 identity blocks of one R50 pass (B=2, 1024 "
          f"px): kernel {tot['ms']:.4f} ms in calls between CUDA events, "
          f"{tot['device_ms']:.4f} ms on the device, plain "
          f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms at bf16; "
          f"worst kernel / plain error ratio {worst:.3f} (bar 1.5), kernel vs "
          f"plain bf16 at most {max_diff:.3e}")
    rows = {"bottleneck": dict(
        max_abs_err=max_diff, err_ratio_vs_fp32=worst, ms=tot["ms"],
        plain_ms=tot["plain_ms"],
        bound_ms=tot["bound_ms"],
        bound_by="bytes" if by_all == {"bytes"} else "operations",
        device_ms=tot["device_ms"])}

    C = D = 2048
    weight = torch.randn(D, C, device="cuda", generator=g) / math.sqrt(C)
    bias = 0.01 * torch.randn(D, device="cuda", generator=g)
    fp32 = dict(weight_dtype=torch.float32)
    head_err, head = 0.0, {}
    for side in (32, 24, 16):
        B = 8
        f = torch.randn(B, side, side, C, device="cuda",
                        generator=g).abs().to(bf)
        e = torch.randint(1, side + 1, (B, 2), device="cuda", generator=g,
                          dtype=torch.int32)
        for kw in (dict(fp32, extents=e), dict(weight_dtype=bf, extents=e),
                   fp32):
            got = gh.gem_whiten_l2(f, weight, bias, **kw)
            want = gh.gem_whiten_l2_reference(f, weight, bias, **kw)
            torch.cuda.synchronize()
            head_err = max(head_err, check_close(
                f"gem_head bf16 map {side}x{side}", got, want, 1e-5, 1e-6))
        run = lambda: gh.gem_whiten_l2(f, weight, bias, extents=e, **fp32)
        ms, dev = cuda_ms(torch, run), device_ms(torch, run)
        plain = cuda_ms(torch, lambda: gh.gem_whiten_l2_reference(
            f, weight, bias, extents=e, **fp32))
        cells = int((e[:, 0].clamp(0, side) * e[:, 1].clamp(0, side)).sum())
        flops = cells * C * 3 + 2 * B * C * D + 3 * B * D
        nbytes = 2 * cells * C + 4 * (D * C + D + 2 * B + B * D)
        bnd, by = bound_ms(flops, nbytes)
        print(f"gem_head bf16 map B={B} {side}x{side}x{C}->{D}, fp32 weight, "
              f"extents ({cells} of {B * side * side} cells valid): max|err| "
              f"{head_err:.3e} (rtol 1e-5, atol 1e-6); kernel {ms:.4f} ms per "
              f"call, {dev:.4f} ms on the device, plain {plain:.4f} ms, "
              f"bound {bnd:.4f} ms ({by})")
        head[side] = dict(max_abs_err=head_err, ms=ms, plain_ms=plain,
                          bound_ms=bnd, bound_by=by, device_ms=dev)
    rows["gem_head"] = head[32]
    return rows


PROFILE_GROUPS = (  # (group, substrings of kernel names), first match wins
    ("bottleneck kernel", BOTTLENECK_LAUNCHES),
    ("gem_head kernel", HEAD_LAUNCHES),
    ("cuDNN convolution", ("conv", "xmma", "implicit_gemm", "Nchw", "Nhwc",
                           "nchw", "nhwc")),
    ("cuDNN batch norm", ("bn_fw",)),
    ("resize / search matmul", ("gemm", "bmm", "Gemm")),
)


def _union_ms(intervals):
    """Length of the union of (start, end) microsecond intervals, in ms."""
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def phase_profile(torch, run, label):
    """Device time by kernel over one ``run()`` (torch.profiler / CUPTI),
    by group and top kernels, and the device's busy share in that same
    run: the union of its kernel intervals (copies and memsets apart)
    over the run's wall clock.  The profiler adds host time to that wall,
    so the share is a lower bound of the busy share with the profiler
    off.  Only kernel-level events are summed (operator rows would count
    the same time twice)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    is_copy = lambda key: "Memcpy" in key or "Memset" in key
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not is_copy(e.key)]
    if not rows:
        print("profile: the profiler recorded no device time (not measured)")
        return
    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in on_device]
    kern = [(e.time_range.start, e.time_range.end) for e in on_device
            if not is_copy(e.name)]
    busy_ms, copy_busy_ms = _union_ms(kern), _union_ms(spans)
    rows.sort(key=lambda e: -e.self_device_time_total)
    total = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"profile ({label}): kernel time {total:.1f} ms summed, "
          f"{busy_ms:.1f} ms as a union of intervals ({copy_busy_ms:.1f} ms "
          f"with copies) over this run's wall {prof_wall_ms:.1f} ms "
          f"(profiler on): device busy >= {100 * busy_ms / prof_wall_ms:.1f}%"
          f" (kernels), {100 * copy_busy_ms / prof_wall_ms:.1f}% (with "
          f"copies)")
    groups: dict[str, float] = {}
    for e in rows:
        g = next((name for name, keys in PROFILE_GROUPS
                  if any(k in e.key for k in keys)), "other (elementwise)")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  group {ms:9.2f} ms {100 * ms / total:5.1f}%  {g}")
    for e in rows[:12]:
        ms = e.self_device_time_total / 1e3
        print(f"  {ms:9.2f} ms {100 * ms / total:5.1f}% x{e.count:<6d} "
              f"{e.key[:100]}")


SERVE_N = 1_400_000  # GLDv2-index scale: 2.87 GB int8, 5.7 GB bf16 at 2048
SERVE_K = 100


def _jpeg_encoder():
    """``encode(rgb uint8) -> JPEG bytes`` through OpenCV or PIL, or None
    when neither is installed."""
    try:
        import cv2

        def enc(img):
            ok, buf = cv2.imencode(".jpg", cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                                   [cv2.IMWRITE_JPEG_QUALITY, 95])
            if not ok:
                raise RuntimeError("cv2.imencode failed")
            return buf.tobytes()
        return enc
    except ImportError:
        pass
    try:
        import io

        from PIL import Image
    except ImportError:
        return None

    def enc(img):
        out = io.BytesIO()
        Image.fromarray(img).save(out, format="JPEG", quality=95)
        return out.getvalue()
    return enc


def _reset_launches(gh, rb):
    gh.gem_whiten_l2.launches = 0
    rb.fused_bottleneck.launches = 0


def _no_launches(gh, rb, what: str) -> dict:
    """The counts since ``_reset_launches``, for a run whose model has no
    block of either kernel's function: raises unless both are 0."""
    counts = {"gem_head": gh.gem_whiten_l2.launches,
              "bottleneck": rb.fused_bottleneck.launches}
    if any(counts.values()):
        raise AssertionError(f"{what}: launches {counts}, want none")
    return counts


def _read_launches(gh, rb, step: str) -> dict:
    counts = {"gem_head": gh.gem_whiten_l2.launches,
              "bottleneck": rb.fused_bottleneck.launches}
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"serving step '{step}'")
    return counts


def _distinct(scores, tol=1e-6):
    gap = np.abs(np.diff(scores, axis=1))
    d = np.ones_like(scores, bool)
    d[:, 1:] &= gap > tol
    d[:, :-1] &= gap > tol
    return d


def _same_ids(name, ids, want_ids, scores, tol=1e-6):
    d = _distinct(scores, tol)
    bad = int((ids != want_ids)[d].sum())
    if bad:
        raise AssertionError(f"{name}: {bad} ids differ on distinct scores")
    return int(d.sum())


def _fixture_map(torch, vecs, labels, q_idx):
    from research_image_retrieval_tpu_torch.data import make_synthetic_gnd
    from research_image_retrieval_tpu_torch.evaluation import (
        compute_map_and_print,
    )
    from research_image_retrieval_tpu_torch.index import rank_full

    ranks = rank_full(vecs[q_idx], vecs, device="cuda")
    return compute_map_and_print("roxford5k", "global", "synthetic", ranks,
                                 make_synthetic_gnd(labels, q_idx),
                                 kappas=[1, 5, 10])


def _build_gallery(torch, head: np.ndarray, n: int, seed: int = 0):
    """(fp32, bf16, int8, scales) device galleries of ``n`` x D: ``head``
    (the fixture's descriptors) then unit rows from a seeded CUDA
    generator, made in 65536-row blocks on the card."""
    from research_image_retrieval_tpu_torch.ops import quantize_gallery_int8

    d = head.shape[1]
    g32 = torch.empty((n, d), dtype=torch.float32, device="cuda")
    g32[:len(head)] = torch.from_numpy(head).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for b in range(len(head), n, 65536):
        e = min(b + 65536, n)
        blk = torch.randn((e - b, d), device="cuda", generator=gen)
        g32[b:e] = blk / torch.linalg.vector_norm(blk, dim=1, keepdim=True)
    q8, s8 = quantize_gallery_int8(g32)
    return g32, g32.to(torch.bfloat16), q8, s8


def _int8_pair_scores(torch, q, q8, s8, rows) -> np.ndarray:
    """The int8 engine's score of each query with the gallery row
    ``rows[i]``, recomputed outside the engine: the query quantized as the
    engine does, the exact integer dot product, then ``s32 * (s_q * s_g)``
    in fp32."""
    from research_image_retrieval_tpu_torch.ops import quantize_gallery_int8

    qq, sq = quantize_gallery_int8(q)
    r = torch.from_numpy(np.asarray(rows)).to(q.device)
    dots = (qq.to(torch.int64) * q8[r].to(torch.int64)).sum(dim=1)
    return (dots.to(torch.float32) * (sq * s8[r])).cpu().numpy()


def _load_clients(svc, queries, clients: int, per_client: int, k: int):
    """``clients`` threads, each sending ``per_client`` one-query
    requests back to back; returns per-request ms (host clock), QPS and
    the service's engine-call / batch counts over the run."""
    import threading

    before = svc.stats()
    lat = [[] for _ in range(clients)]
    errs = []

    def client(c):
        try:
            for r in range(per_client):
                q = queries[(c * per_client + r) % len(queries)]
                t0 = time.perf_counter()
                svc.search(q, k=k)
                lat[c].append((time.perf_counter() - t0) * 1e3)
        except Exception as e:  # reported after the join
            errs.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    if errs or any(t.is_alive() for t in threads):
        raise AssertionError(f"load run failed: {errs or 'a client hung'}")
    after = svc.stats()
    ms = np.sort(np.concatenate([np.asarray(v) for v in lat]))
    return dict(p50=float(np.percentile(ms, 50)),
                p99=float(np.percentile(ms, 99)),
                qps=len(ms) / wall,
                engine_calls=after["engine_calls"] - before["engine_calls"],
                batches=(after["coalesced_batches"]
                         - before["coalesced_batches"]))


def _post(url, payload):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def phase_serving(torch, gh, rb, gpu_model, phase4_map) -> dict:
    """Phase 6: the serving stack at full width through its entry points:
    the extract CLI on the 16 x 8 fixture (JPEG files when an encoder is
    installed, else its in-memory function), a 1.4M x 2048 gallery on the
    card, ``SearchService`` (int8 and exact engines) against direct
    engine calls, latency under 1 and 8 clients, the HTTP front end with
    an ``ImageExtractor``, and the CLI path's mAP against phase 4's.
    Returns each kernel's launch count per serving step."""
    import base64
    import threading

    from research_image_retrieval_tpu_torch.cli import extract as cli_extract
    from research_image_retrieval_tpu_torch.evaluation.driver import (
        _load_model,
    )
    from research_image_retrieval_tpu_torch.ops import topk_stream
    from research_image_retrieval_tpu_torch.serve import (
        ImageExtractor,
        SearchService,
        make_http_server,
    )
    from research_image_retrieval_tpu_torch.serve.http import (
        decode_image_bytes,
    )
    from research_image_retrieval_tpu_torch.utils.config import EvalConfig

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    ckpt = os.path.join(work, "gem_r50_seed0.pt")
    torch.save({k: v.cpu() for k, v in gpu_model.state_dict().items()}, ckpt)
    imgs, labels = serving_fixture(16, 1024)
    names = [f"{i:03d}.jpg" for i in range(len(imgs))]
    q_idx = np.arange(0, len(imgs), 8)
    steps = {}

    # -- 6.1 index the fixture through the extract CLI's code -------------
    enc = _jpeg_encoder()
    _reset_launches(gh, rb)
    t0 = time.perf_counter()
    if enc is not None:
        jdir = os.path.join(work, "fixture")
        os.makedirs(jdir)
        jpegs = [enc(im) for im in imgs]
        for name, buf in zip(names, jpegs):
            with open(os.path.join(jdir, name), "wb") as f:
                f.write(buf)
        for tag, extra in (("float", []), ("int8", ["--quantize-int8"])):
            cli_extract.main(["--images", jdir, "--checkpoint", ckpt,
                              "--multiscale", "--batch-size", "8",
                              "--output", os.path.join(work, f"{tag}.npz"),
                              *extra])
        route = "JPEG files through cli.extract main()"
    else:
        jpegs = None
        model = _load_model(EvalConfig(checkpoint=ckpt), device="cuda")
        for tag, quant in (("float", False), ("int8", True)):
            np.savez(os.path.join(work, f"{tag}.npz"), **cli_extract
                     .extract_index(model, imgs, names, multiscale=True,
                                    batch_size=8, quantize_int8=quant))
        route = ("in-memory arrays through cli.extract.extract_index (no "
                 "JPEG encoder: the file decode was not driven)")
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    steps["cli_extract"] = _read_launches(gh, rb, "extract CLI")
    fl, i8 = (np.load(os.path.join(work, f"{t}.npz")) for t in ("float",
                                                                 "int8"))
    if (fl["vecs"].shape != (len(imgs), 2048)
            or not np.isfinite(fl["vecs"]).all()):
        raise AssertionError(f"CLI index: shape {fl['vecs'].shape}")
    if list(fl["names"]) != names or list(i8["names"]) != names:
        raise AssertionError("CLI index names out of order")
    q8_chk, s8_chk = topk_stream.quantize_gallery_int8(
        torch.from_numpy(fl["vecs"]))
    if not (np.array_equal(q8_chk.numpy(), i8["vecs_int8"])
            and np.array_equal(s8_chk.numpy(), i8["scales"])):
        raise AssertionError("the int8 index is not the float index "
                             "quantized")
    print(f"serving 6.1: fixture indexed via {route}: 2 x {len(imgs)} "
          f"images at 1024 px ms3 in {cli_s:.2f} s (float + int8 index, "
          f"model load included); launches {steps['cli_extract']}")

    # -- 6.6 (run first: its descriptors head the gallery) ---------------
    model = _load_model(EvalConfig(checkpoint=ckpt), device="cuda")
    mem = cli_extract.extract_index(model, imgs, names, multiscale=True,
                                    batch_size=8, device="cuda")["vecs"]
    mem_map = _fixture_map(torch, mem, labels, q_idx)
    jpeg_map = _fixture_map(torch, fl["vecs"], labels, q_idx)
    if tuple(mem_map) != tuple(phase4_map):
        raise AssertionError(f"CLI-path mAP {mem_map} != phase 4 "
                             f"{phase4_map}")
    print(f"serving 6.6: mAP of cli.extract's function on the in-memory "
          f"fixture E/M/H {mem_map} == phase 4 {tuple(phase4_map)}; "
          f"{'JPEG' if jpegs else 'in-memory'} route (cli.extract main) "
          f"{jpeg_map} (printed, not checked)")
    del model

    # -- 6.2 a 1.4M x 2048 gallery on the card ----------------------------
    t0 = time.perf_counter()
    g32, g16, q8, s8 = _build_gallery(torch, mem, SERVE_N)
    torch.cuda.synchronize()
    print(f"serving 6.2: gallery {SERVE_N} x 2048 built on the card in "
          f"{time.perf_counter() - t0:.2f} s: int8 {q8.numel() / 1e9:.3f} "
          f"GB + scales, bf16 {2 * g16.numel() / 1e9:.3f} GB (fp32 "
          f"{4 * g32.numel() / 1e9:.3f} GB kept for the recall reference)")
    gen = torch.Generator(device="cuda").manual_seed(1)
    rq = torch.randn((64, 2048), device="cuda", generator=gen)
    rq = (rq / torch.linalg.vector_norm(rq, dim=1, keepdim=True))
    fq = torch.from_numpy(mem[q_idx]).cuda()

    # direct engine calls: the chunk sweep and the stream's bound
    for eng in ("int8", "exact"):
        for chunk in (131072, 262144, None):
            for nq in (1, 32):
                q = rq[:nq]
                if eng == "int8":
                    fn = lambda: topk_stream.int8_streaming_topk(
                        q, q8, s8, k=SERVE_K, chunk=chunk)
                else:
                    fn = lambda: topk_stream.scan_streaming_topk(
                        q, g16, k=SERVE_K, chunk=chunk)
                with torch.no_grad():
                    ms = cuda_ms(torch, fn, iters=5, warmup=1)
                print(f"serving engine {eng} Q={nq} chunk "
                      f"{chunk or 'default'}: {ms:.4f} ms per call (CUDA "
                      f"events, host dispatch included)")
    print(f"serving engine bounds: int8 stream "
          f"{q8.numel() / HBM_RATE * 1e3:.4f} ms ({q8.numel() / 1e9:.3f} GB "
          f"at 3.35 TB/s), bf16 stream {2 * g16.numel() / HBM_RATE * 1e3:.4f}"
          f" ms")

    # -- 6.3 engine checks --------------------------------------------------
    # int8 and exact-on-bf16 are the serving stores; the exact service on
    # the fp32 gallery (the caller's tensor, no copy) fronts the HTTP step:
    # with seeded random weights the fixture's descriptors lie closer
    # together than int8 or bf16 storage resolves (printed below)
    svc8 = SearchService(vecs_int8=q8, scales=s8, engine="int8", k=SERVE_K,
                         max_batch=32)
    svc16 = SearchService(g16, engine="exact", k=SERVE_K, max_batch=32,
                          store_dtype="bfloat16")
    svc32 = SearchService(g32, engine="exact", k=SERVE_K, max_batch=32,
                          store_dtype="float32")
    server = None
    nq = len(q_idx)
    lab = np.asarray(labels)
    in_class = lambda ids: int(((ids < len(imgs)) & (lab[np.minimum(
        ids, len(imgs) - 1)] == lab[q_idx])).sum())
    try:
        t0 = time.perf_counter()
        for svc in (svc8, svc16, svc32):
            svc.warmup()
        print(f"serving 6.3: warmup of buckets 1..32 for three services "
              f"{time.perf_counter() - t0:.2f} s")
        with torch.no_grad():
            direct = {name: [t.cpu().numpy() for t in fn()] for name, fn in (
                ("int8", lambda: topk_stream.int8_streaming_topk(
                    fq, q8, s8, k=SERVE_K)),
                ("exact-bf16", lambda: topk_stream.scan_streaming_topk(
                    fq, g16, k=SERVE_K, chunk=None)),
                ("exact-fp32", lambda: topk_stream.scan_streaming_topk(
                    fq, g32, k=SERVE_K, chunk=None)))}
            ref = topk_stream.scan_streaming_topk(rq, g32, k=SERVE_K,
                                                  chunk=None)[1].cpu()
            r8 = topk_stream.int8_streaming_topk(rq, q8, s8,
                                                 k=SERVE_K)[1].cpu()
            r16 = topk_stream.scan_streaming_topk(rq, g16, k=SERVE_K,
                                                  chunk=None)[1].cpu()
        served, agree = {}, []
        for name, svc in (("int8", svc8), ("exact-bf16", svc16),
                          ("exact-fp32", svc32)):
            sv, iv = served[name] = svc.search(mem[q_idx])
            ds, di = direct[name]
            n = _same_ids(f"{name} service vs engine", iv, di, sv)
            check_close(f"{name} service scores", torch.from_numpy(sv),
                        torch.from_numpy(ds), 0.0,
                        0.0 if name == "int8" else 1e-5)
            agree.append(f"{name} {n}")
        s8v, i8v = served["int8"]
        i16v = served["exact-bf16"][1]
        s32v, i32v = served["exact-fp32"]
        if not np.array_equal(i32v[:, 0], q_idx):
            raise AssertionError(f"fp32 exact top-1 {i32v[:, 0]}: not the "
                                 "queries' own rows")
        # the int8 top-1 is the exact top-1 unless quantization reorders
        # them: its int8 score is recomputed outside the engine, and the
        # fp32 top-1 row's int8 score may not exceed it
        own8 = _int8_pair_scores(torch, fq, q8, s8, i8v[:, 0])
        top8 = _int8_pair_scores(torch, fq, q8, s8, i32v[:, 0])
        check_close("int8 top-1 score vs recomputed", torch.from_numpy(
            s8v[:, 0]), torch.from_numpy(own8), 1e-6, 0.0)
        if (top8 > s8v[:, 0] + 1e-6).any():
            raise AssertionError(f"the int8 engine missed the fp32 top-1 "
                                 f"rows' higher int8 scores: {top8} vs "
                                 f"{s8v[:, 0]}")
        flips = int((i8v[:, 0] != i32v[:, 0]).sum())
        # how far apart the fixture's descriptors are, against the int8
        # score error on the queries' own rows
        sim = mem[q_idx] @ mem.T
        same = lab[None, :] == lab[q_idx][:, None]
        sim[np.arange(nq), q_idx] = -np.inf
        own_err = np.abs(_int8_pair_scores(torch, fq, q8, s8, q_idx)
                         - np.einsum("qd,qd->q", mem[q_idx], mem[q_idx]))
        margin = s32v[:, 0] - s32v[:, 1]
        print(f"serving 6.3: fixture spread, fp32 cosine of each query to "
              f"its nearest other row in its class: median "
              f"{np.median(np.where(same, sim, -np.inf).max(1)):.6f}, in "
              f"another class: median "
              f"{np.median(np.where(same, -np.inf, sim).max(1)):.6f} max "
              f"{np.where(same, -np.inf, sim).max():.6f}; fp32 top-1 / "
              f"top-2 margin min {margin.min():.3e} median "
              f"{np.median(margin):.3e}; int8 score error on the own rows: "
              f"max {own_err.max():.3e}")
        rec = lambda a, b: float(np.mean([len(set(x) & set(y)) / SERVE_K
                                          for x, y in zip(a.numpy(),
                                                          b.numpy())]))
        print(f"serving 6.3: service == direct engine call on the {nq} "
              f"fixture queries ({', '.join(agree)} distinct-score ids; "
              f"int8 scores equal, float within 1e-5); fp32 exact top-1 == "
              f"own row {nq}/{nq}; int8 top-1 == fp32 top-1 {nq - flips}/"
              f"{nq} (the other {flips}: the int8 scores reorder the two "
              f"rows, checked), in the query's class "
              f"{in_class(i8v[:, 0])}/{nq}; bf16-store exact top-1 == fp32 "
              f"{int((i16v[:, 0] == i32v[:, 0]).sum())}/{nq}, in class "
              f"{in_class(i16v[:, 0])}/{nq}; recall@{SERVE_K} vs the exact "
              f"fp32 engine, 64 random unit queries: int8 "
              f"{rec(r8, ref):.4f}, exact on the bf16 store "
              f"{rec(r16, ref):.4f}")
        del ref

        # -- 6.4 latency ----------------------------------------------------
        queries = rq.cpu().numpy()
        for name, svc in (("int8", svc8), ("exact-bf16", svc16)):
            for clients in (1, 8):
                r = _load_clients(svc, queries, clients, 40, SERVE_K)
                print(f"serving 6.4 latency {name} engine, {clients} "
                      f"client(s) x 40 one-query requests, k={SERVE_K}, "
                      f"N={SERVE_N}: p50 {r['p50']:.3f} ms, p99 "
                      f"{r['p99']:.3f} ms, {r['qps']:.1f} QPS, "
                      f"engine_calls {r['engine_calls']}, "
                      f"coalesced_batches {r['batches']} (host clock, "
                      f"window 2 ms)")

        # -- 6.5 HTTP with an ImageExtractor ---------------------------------
        _reset_launches(gh, rb)
        extractor = ImageExtractor("gem_r50", checkpoint=ckpt, imsize=1024,
                                   multiscale=True, batch_size=8)
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        server = make_http_server(svc32, port=port, extractor=extractor)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{port}"
        import urllib.request

        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if health["gallery_size"] != SERVE_N or not health["image_search"]:
            raise AssertionError(f"/healthz: {health}")
        out = _post(url + "/search", {"vectors": mem[q_idx].tolist(),
                                      "k": SERVE_K})
        ids = np.array([[m["index"] for m in r["matches"]]
                        for r in out["results"]])
        _same_ids("POST /search vs service", ids, i32v, s32v)
        got = extractor([imgs[i] for i in q_idx])
        dev_err = float(np.abs(got - mem[q_idx]).max())
        if dev_err > 1e-5:
            raise AssertionError(f"ImageExtractor descriptors differ from "
                                 f"the index rows by {dev_err:.3e}")
        _, i_raw = svc32.search(got, k=1)
        if not np.array_equal(i_raw[:, 0], q_idx):
            raise AssertionError(f"ImageExtractor on raw arrays: top-1 "
                                 f"{i_raw[:, 0]}, want {q_idx}")
        _, i_raw8 = svc8.search(got, k=1)
        msg = "no JPEG encoder: /search/image not driven"
        if jpegs is not None:
            t0 = time.perf_counter()
            out = _post(url + "/search/image", {
                "images_b64": [base64.b64encode(jpegs[i]).decode()
                               for i in q_idx], "k": 5})
            img_s = time.perf_counter() - t0
            top = np.array([r["matches"][0]["index"] for r in out["results"]])
            if in_class(top) != nq:
                raise AssertionError(f"/search/image top-1 {top} not in "
                                     "the queries' classes")
            jv = extractor([decode_image_bytes(jpegs[i], max_side=1024)
                            for i in q_idx])
            _, top8 = svc8.search(jv, k=1)
            cos = np.einsum("qd,qd->q", jv, mem[q_idx])
            msg = (f"POST /search/image, {nq} JPEG queries in one request "
                   f"({img_s:.2f} s): top-1 in its own class {nq}/{nq}, "
                   f"its own row {int((top == q_idx).sum())}/{nq} (on the "
                   f"int8 service: class {in_class(top8[:, 0])}/{nq}, own "
                   f"row {int((top8[:, 0] == q_idx).sum())}/{nq}); cosine "
                   f"of each JPEG query to its raw image's row: min "
                   f"{cos.min():.6f}")
        steps["image_extractor"] = _read_launches(gh, rb, "HTTP / image")
        print(f"serving 6.5: HTTP over the fp32 exact service: GET /healthz "
              f"ok; POST /search == service ids, own rows {nq}/{nq}; "
              f"ImageExtractor on the raw query arrays: within "
              f"{dev_err:.2e} of the index rows, own row at top-1 {nq}/{nq} "
              f"(int8 service {int((i_raw8[:, 0] == q_idx).sum())}/{nq}); "
              f"{msg}; launches {steps['image_extractor']}")
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        for svc in (svc8, svc16, svc32):
            svc.close()
    if jpegs is None:
        raise AssertionError("6.7 needs the fixture as JPEG files (OpenCV or "
                             "PIL to encode them)")
    phase_rerank_cli(torch, work, jdir, names, imgs, labels, q_idx, ckpt,
                     fl["vecs"])
    shutil.rmtree(work, ignore_errors=True)
    return steps


def _revisited_layout(root, jdir, names, imgs, labels, q_idx) -> list:
    """Lay the fixture's JPEG files out as a Revisited dataset under
    ``root`` (``roxford5k/jpg``, ``gnd_roxford5k.pkl``; the first image of
    each class a query, its box the whole image); returns the gnd."""
    import pickle

    from research_image_retrieval_tpu_torch.data import make_synthetic_gnd

    jpg = os.path.join(root, "roxford5k", "jpg")
    os.makedirs(jpg)
    for n in names:
        shutil.copy(os.path.join(jdir, n), os.path.join(jpg, n))
    stems = [os.path.splitext(n)[0] for n in names]
    gnd = make_synthetic_gnd(labels, q_idx)
    for g, q in zip(gnd, q_idx):
        g["bbx"] = (0.0, 0.0, float(imgs[q].shape[1]),
                    float(imgs[q].shape[0]))
    with open(os.path.join(root, "roxford5k", "gnd_roxford5k.pkl"), "wb") as f:
        pickle.dump({"imlist": stems, "qimlist": [stems[q] for q in q_idx],
                     "gnd": gnd}, f)
    return gnd


def phase_rerank_cli(torch, work, jdir, names, imgs, labels, q_idx, ckpt,
                     vecs):
    """6.7: ``cli.evaluate`` with ``--iqe`` (a seeded random-init IQE MLP
    written as flattened flax params, the ``.npz`` layout a converted JAX
    checkpoint has) and ``--superglobal`` on the fixture laid out as a
    Revisited dataset (the JPEGs of 6.1; the first image of each class a
    query, its box the whole image).  Its E/M/H mAP is held against the
    same pipeline (``evaluation.driver._rank``) on 6.1's index of the same
    files: equal within 0.5 points (the two extractions batch the images
    differently, so cuDNN may sum in other orders)."""
    from research_image_retrieval_tpu_torch.cli import evaluate as cli_eval
    from research_image_retrieval_tpu_torch.evaluation import (
        compute_map_and_print,
    )
    from research_image_retrieval_tpu_torch.evaluation.driver import _rank
    from research_image_retrieval_tpu_torch.index import (
        IterativeQueryExpansion,
        rank_full,
    )
    from research_image_retrieval_tpu_torch.utils.config import EvalConfig

    root = os.path.join(work, "revisited")
    gnd = _revisited_layout(root, jdir, names, imgs, labels, q_idx)
    stems = [os.path.splitext(n)[0] for n in names]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(6)
        iqe = IterativeQueryExpansion(vecs.shape[1])
    iqe_npz = os.path.join(work, "iqe_random_init.npz")
    np.savez(iqe_npz, **{f"params/{m}/{k}": (
        getattr(iqe, m).weight.detach().numpy().T if k == "kernel"
        else getattr(iqe, m).bias.detach().numpy())
        for m in ("expansion_fc1", "expansion_fc2")
        for k in ("kernel", "bias")})
    out = os.path.join(work, "rerank.json")
    sg_m = 50
    t0 = time.perf_counter()
    cli_eval.main(["--datasets", "roxford5k", "--data-root", root,
                   "--checkpoint", ckpt, "--multiscale", "--iqe",
                   "--iqe-checkpoint", iqe_npz, "--superglobal", "--sg-m",
                   str(sg_m), "--output", out])
    cli_s = time.perf_counter() - t0
    with open(out) as f:
        got = tuple(json.load(f)["roxford5k"])
    cfg = EvalConfig(iqe=True, iqe_checkpoint=iqe_npz, superglobal=True,
                     sg_m=sg_m)
    want = compute_map_and_print("roxford5k", "global", "test",
                                 _rank(vecs[q_idx], vecs, cfg, "cuda"), gnd,
                                 kappas=[1, 5, 10])
    plain = compute_map_and_print("roxford5k", "global", "test",
                                  rank_full(vecs[q_idx], vecs, device="cuda"),
                                  gnd, kappas=[1, 5, 10])
    if not all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in got) or \
            max(abs(a - b) for a, b in zip(got, want)) > 0.5:
        raise AssertionError(f"6.7 cli.evaluate --iqe --superglobal mAP {got}"
                             f" != the same pipeline on 6.1's index {want}")
    print(f"serving 6.7: cli.evaluate --multiscale --iqe (seeded random-init "
          f"MLP from a flattened-flax .npz) --superglobal --sg-m {sg_m} on the "
          f"fixture as a Revisited dataset ({len(stems)} images, "
          f"{len(q_idx)} queries) in {cli_s:.1f} s: E/M/H {got}; the same "
          f"pipeline on 6.1's index {tuple(want)}; plain ranking "
          f"{tuple(plain)}")


# -- phase 7: training on the card -------------------------------------------

TRAIN_PX = 512          # TrainConfig.imsize
TRAIN_CLASSES = 81313   # the GLDv2-clean head
RIGOROUS = dict(test_accuracy=98.6, reference_mAP=0.7832,
                self_excluded_mAP=0.9967)  # benchmarks/rigorous_synthetic_gem_r50.json
RIGOROUS_PX, RIGOROUS_EPOCHS = 224, 6  # that record's config
TRAIN_GROUPS = (  # (group, substrings of lower-cased kernel names)
    ("batch norm", ("batch_norm", "bn_fw", "bn_bw")),
    ("cuDNN layout transposes", ("nchwtonhwc", "nhwctonchw")),
    ("conv backward (weight)", ("wgrad",)),
    ("conv backward (data)", ("dgrad",)),
    ("conv forward", ("fprop", "convolve", "conv", "implicit_gemm",
                      "xmma")),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("classifier / whiten GEMMs", ("gemm", "cutlass", "kernel2")),
)


def _leaf_devs(got: dict, want: dict) -> dict:
    """Per key: max |got - want| over the largest |want| of the leaf."""
    return {k: float((got[k] - want[k]).abs().max()
                     / want[k].abs().max().clamp(min=1e-30)) for k in want}


def conv_linear_macs(torch, model, px: int) -> int:
    """Multiply-adds of one image's forward through every Conv2d and Linear
    of ``model`` at ``px`` x ``px`` (counted from the layers' shapes)."""
    macs = []

    def conv(m, i, o):
        macs.append(o.numel() // o.shape[0] * m.in_channels // m.groups
                    * m.kernel_size[0] * m.kernel_size[1])

    hooks = [m.register_forward_hook(conv) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model.backbone(torch.zeros(1, px, px, 3, device=next(
            model.parameters()).device))
    for h in hooks:
        h.remove()
    lin = model.whiten.in_features * model.whiten.out_features \
        + model.classifier_w.numel()
    return sum(macs) + lin


def _grouped(rows, groups, fallback="elementwise / other"):
    out: dict[str, float] = {}
    for e in rows:
        key = e.key.lower()
        g = next((name for name, keys in groups
                  if any(k in key for k in keys)), fallback)
        out[g] = out.get(g, 0.0) + e.self_device_time_total / 1e3
    return out


def phase_train_step(torch, smi: str, dtype: str = "float32") -> dict:
    """7.1: the train step at full width (GeM-R50, 81,313-way ArcFace,
    512 px uint8 batches drawn on the card, SGD with TrainConfig's
    defaults) at compute dtype ``dtype``, at TrainConfig's batch or the
    largest power of two below it that fits; then, for float32, the same
    step at reduced size against the CPU (``check_cuda_train_step``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from research_image_retrieval_tpu_torch.data import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )
    from research_image_retrieval_tpu_torch.models import get_model
    from research_image_retrieval_tpu_torch.train import (
        create_train_state,
        make_sgd_optimizer,
        make_train_step,
    )
    from research_image_retrieval_tpu_torch.train.device_check import (
        SHAPE as STEP_CHECK,
    )
    from research_image_retrieval_tpu_torch.train.device_check import (
        check_cuda_train_step,
    )
    from research_image_retrieval_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig()
    t0 = time.perf_counter()
    state = create_train_state(
        get_model("gem_r50", num_classes=TRAIN_CLASSES, dtype=dtype), 0,
        make_sgd_optimizer(cfg.base_lr, momentum=cfg.momentum,
                           weight_decay=cfg.weight_decay,
                           clip_max_norm=cfg.clip_max_norm), device="cuda")
    init_s = time.perf_counter() - t0
    step = make_train_step((IMAGENET_MEAN, IMAGENET_STD))
    g = torch.Generator(device="cuda").manual_seed(0)
    B, tried = cfg.batch_size, []
    while True:
        try:
            x = torch.randint(0, 256, (B, TRAIN_PX, TRAIN_PX, 3),
                              dtype=torch.uint8, device="cuda", generator=g)
            y = torch.randint(0, TRAIN_CLASSES, (B,), device="cuda",
                              generator=g)
            torch.cuda.reset_peak_memory_stats()
            state, m = step(state, x, y)
            torch.cuda.synchronize()
            break
        except torch.cuda.OutOfMemoryError:
            tried.append(B)
            x = y = None
            state.optimizer.zero_grad()
            torch.cuda.empty_cache()
            B //= 2
            if B < 8:
                raise
    tag = "7.1" if dtype == "float32" else "7.1-bf16"
    if tried:
        print(f"train {tag}: batch {tried} does not fit in device memory; "
              f"cut to {B} (the largest power of two that fits)")
    for _ in range(2):
        state, m = step(state, x, y)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(10):
        state, m = step(state, x, y)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / 10
    peak = torch.cuda.max_memory_allocated()
    loss, gn = float(m["loss"]), float(m["grad_norm"])
    bad = [n for n, p in state.model.named_parameters()
           if not bool(torch.isfinite(p.grad).all())]
    if not (math.isfinite(loss) and math.isfinite(gn)) or bad:
        raise AssertionError(f"train step: loss {loss}, grad_norm {gn}, "
                             f"non-finite gradients in {bad[:5]}")
    flops = 3 * 2 * conv_linear_macs(torch, state.model, TRAIN_PX) * B
    peak_rate, rate_name = ((FP32_PEAK, "fp32 FMA") if dtype == "float32"
                            else (BF16_PEAK, "dense bf16 tensor-core"))
    bound = flops / peak_rate * 1e3
    print(f"train {tag}: GeM-R50 at {dtype}, {TRAIN_CLASSES}-way ArcFace "
          f"(s 32, m 0.15), "
          f"{TRAIN_PX} px uint8, batch {B}, SGD lr {cfg.base_lr} nesterov "
          f"momentum {cfg.momentum} wd {cfg.weight_decay} clip "
          f"{cfg.clip_max_norm}: {ms:.1f} ms per step (10 steps between CUDA "
          f"events after 3), {1e3 * B / ms:.1f} img/s, peak "
          f"{peak / 2 ** 30:.2f} GiB allocated, "
          f"{flops / ms / 1e9:.1f} TFLOP/s of {flops / B / 1e9:.1f} GFLOP "
          f"per image (3 x forward conv + linear FLOPs) against the "
          f"{rate_name} bound {bound:.1f} ms ({100 * bound / ms:.1f}%); "
          f"loss {loss:.4f}, "
          f"grad_norm {gn:.4f}; model init {init_s:.1f} s [{smi}]")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, m = step(state, x, y)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0 and "Memcpy" not in e.key
            and "Memset" not in e.key]
    if rows:
        groups = _grouped(rows, TRAIN_GROUPS)
        total = sum(groups.values())
        print(f"train {tag} profile (one step, printed only): {total:.1f} "
              "ms of kernels")
        for name, t in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"  group {t:9.2f} ms {100 * t / total:5.1f}%  {name}")
        rows.sort(key=lambda e: -e.self_device_time_total)
        for e in rows[:10]:
            t = e.self_device_time_total / 1e3
            print(f"  {t:9.2f} ms {100 * t / total:5.1f}% x{e.count:<5d} "
                  f"{e.key[:100]}")
    else:
        print(f"train {tag} profile: no device time recorded (not "
              "measured)")
    del state, x, y, m, prof
    torch.cuda.empty_cache()
    out = dict(batch=B, ms=ms, peak=peak, tried=tried, bound=bound,
               img_s=1e3 * B / ms, tflops=flops / ms / 1e9)
    if dtype != "float32":
        return out
    par = check_cuda_train_step()
    print(f"train 7.1: one step at batch {STEP_CHECK['batch']}, "
          f"{STEP_CHECK['px']} px, resnet50, {STEP_CHECK['classes']} classes, "
          "cuda vs cpu from one state in float64 (deviation / bar, worst "
          "leaf): " + "; ".join(f"{k} {d:.2e} / {b} {leaf}"
                                for k, (d, b, leaf) in par.items())
          + "; in float32, TF32 off through backward() and the caller's "
          "flags restored")
    return out


def _record_file(path: str, n_classes: int = 128, per_class: int = 2):
    """``n_classes`` x ``per_class`` procedural JPEGs at 512 x 683 (seeded)
    under labels spread across the 81,313-way head, 81312 included."""
    from research_image_retrieval_tpu_torch.data import write_records

    enc = _jpeg_encoder()
    if enc is None:
        raise AssertionError("no JPEG encoder (OpenCV or PIL) for phase 7.2")
    labels = np.round(np.linspace(0, TRAIN_CLASSES - 1, n_classes)).astype(int)
    imgs = procedural_images([(512, 683)] * (n_classes * per_class), seed=71)
    items = ((enc(im), int(labels[i // per_class]))
             for i, im in enumerate(imgs))
    return write_records(path, items)


def _stop_after(n: int):
    """A ``PreemptionGuard`` class whose guard asks to stop after ``n``
    steps (``request_stop``, as a SIGTERM would)."""
    from research_image_retrieval_tpu_torch.train.preemption import (
        PreemptionGuard,
    )

    class Guard(PreemptionGuard):
        def __init__(self):
            super().__init__(signals=())
            self.seen = 0

        @property
        def should_stop(self):
            self.seen += 1
            if self.seen >= n:
                self.request_stop()
            return super().should_stop

    return Guard


def phase_train_cli(torch, gh, rb, smi: str) -> dict:
    """7.2: ``cli.train.main`` over an 81,313-way record file, twice from
    the same seed: straight through 2 epochs (profiled: img/s with the
    host pipeline, the card's busy share), and stopped by the preemption
    guard after epoch 0 then resumed; the two runs' final parameters must
    be bit-equal (both inside ``utils.profiling.deterministic_mode()``,
    the process started with ``CUBLAS_WORKSPACE_CONFIG`` set: ``main``
    sets it first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from research_image_retrieval_tpu_torch.cli.train import main as train_cli
    from research_image_retrieval_tpu_torch.models import (
        get_model,
        training_init,
    )
    from research_image_retrieval_tpu_torch.train import driver as drv
    from research_image_retrieval_tpu_torch.utils.profiling import (
        deterministic_mode,
    )

    work = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rec = os.path.join(work, "train.rirrec")
    t0 = time.perf_counter()
    n = _record_file(rec)
    print(f"train 7.2: wrote {n} JPEGs (512 x 683, 2 per class, 128 labels "
          f"in [0, {TRAIN_CLASSES})) to a .rirrec in "
          f"{time.perf_counter() - t0:.1f} s")
    B, per_epoch = 32, 4  # 128 train images (one per class to validation)
    args = ["--data-root", rec, "--device", "cuda", "--num-epochs", "2",
            "--batch-size", str(B), "--imsize", str(TRAIN_PX),
            "--num-workers", "8", "--save-freq", "2"]
    real_step, real_guard = drv.make_train_step, drv.PreemptionGuard
    calls: list[float] = []

    def timed_factory(input_norm=None, **kw):
        step = real_step(input_norm, **kw)

        def timed(state, imgs, labels):
            calls.append(time.perf_counter())
            with record_function("train_step"):
                return step(state, imgs, labels)
        return timed

    gh.gem_whiten_l2.launches = 0
    rb.fused_bottleneck.launches = 0
    try:
        with deterministic_mode():
            drv.make_train_step = timed_factory
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                train_cli(args + ["--directory", os.path.join(work, "a")])
                torch.cuda.synchronize()
            wall_a = time.perf_counter() - t0
            drv.make_train_step = real_step
            launches = {"gem_head": gh.gem_whiten_l2.launches,
                        "bottleneck": rb.fused_bottleneck.launches}
            t0 = time.perf_counter()
            drv.PreemptionGuard = _stop_after(per_epoch)
            train_cli(args + ["--directory", os.path.join(work, "b")])
            drv.PreemptionGuard = real_guard
            train_cli(args + ["--directory", os.path.join(work, "b"),
                              "--resume", "latest"])
            wall_b = time.perf_counter() - t0
    finally:
        drv.make_train_step, drv.PreemptionGuard = real_step, real_guard
    if len(calls) != 2 * per_epoch:
        raise AssertionError(f"7.2 made {len(calls)} train steps, want "
                             f"{2 * per_epoch}")
    steps = sorted((e.time_range.start, e.time_range.end) for e in
                   prof.events() if e.name == "train_step")
    kern = [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and "Memcpy" not in e.name and "Memset" not in e.name]
    busy = span = 0.0
    for ep in range(2):  # from the first step's call to the last's, per epoch
        lo, hi = steps[ep * per_epoch][0], steps[(ep + 1) * per_epoch - 1][0]
        span += (hi - lo) / 1e3
        busy += _union_ms([(max(s, lo), min(e, hi)) for s, e in kern
                           if e > lo and s < hi])
    host_s = sum(calls[(ep + 1) * per_epoch - 1] - calls[ep * per_epoch]
                 for ep in range(2))
    img_s = 2 * (per_epoch - 1) * B / host_s
    hist = [json.loads(line) for line in open(os.path.join(
        work, "a", "metrics.jsonl"))]
    pa = torch.load(os.path.join(work, "a", "epoch_00002.pt"),
                    weights_only=True)["model"]
    pb = torch.load(os.path.join(work, "b", "epoch_00002.pt"),
                    weights_only=True)["model"]
    init = get_model("gem_r50", num_classes=TRAIN_CLASSES)
    training_init(init, torch.Generator().manual_seed(11))  # cfg.seed
    p0 = init.state_dict()
    moved = {k: (pa[k].double() - p0[k].double()) for k in pa
             if pa[k].is_floating_point()}
    devs = _leaf_devs({k: pb[k].double() - p0[k].double() for k in moved},
                      moved)
    worst = max(devs, key=devs.get)
    same = all(torch.equal(pa[k], pb[k]) for k in pa)
    if not same:
        raise AssertionError(f"7.2 resume inside deterministic_mode() is not "
                             f"bit-equal to the straight run: {worst} moved "
                             f"{devs[worst]:.3e} of its largest change apart")
    print(f"train 7.2: cli.train.main, {TRAIN_CLASSES}-way head, {TRAIN_PX} "
          f"px, batch {B}, 8 decode / augment threads, deterministic_mode(): "
          f"{img_s:.1f} img/s including the host pipeline (steps 1-{per_epoch}"
          f" of each epoch, host clock, profiler on), device busy "
          f"{100 * busy / span:.1f}% of that window (union of kernel "
          f"intervals); straight run {wall_a:.1f} s, stop + resume "
          f"{wall_b:.1f} s; resumed vs straight: every leaf's change from "
          f"the init within {devs[worst]:.2e} of its largest change "
          f"(bitwise equal: {same}); validation launches {launches} [{smi}]")
    print(f"train 7.2 history (metrics.jsonl of the straight run): {hist}")
    shutil.rmtree(work, ignore_errors=True)
    return dict(launches=launches, img_s=img_s, busy=busy / span)


def reference_protocol_map(feats: np.ndarray, labels: np.ndarray) -> dict:
    """Leave-one-out mAP / P@k with the query kept IN its ranking at
    relevance 0 (the rigorous harness's own protocol)."""
    f = feats / np.linalg.norm(feats, axis=1, keepdims=True)
    sim = f @ f.T
    n = len(f)
    aps, p_at = [], {k: [] for k in (1, 5, 10)}
    for i in range(n):
        rel = (labels == labels[i]).astype(np.float64)
        rel[i] = 0.0
        srel = rel[np.argsort(-sim[i])]
        if srel.sum() > 0:
            prec = np.cumsum(srel) / np.arange(1, n + 1)
            aps.append(float((prec * srel).sum() / srel.sum()))
        for k in p_at:
            p_at[k].append(float(srel[:k].sum() / k))
    return {"mAP": float(np.mean(aps)),
            **{f"P@{k}": float(np.mean(v)) for k, v in p_at.items()}}


def self_excluded_map(feats: np.ndarray, labels: np.ndarray) -> float:
    """Revisited-protocol mAP, easy = the same class, junk = the query."""
    from research_image_retrieval_tpu_torch.evaluation.revisited import (
        evaluate_revisited,
    )

    f = feats / np.linalg.norm(feats, axis=1, keepdims=True)
    ranks = np.argsort(-(f @ f.T).T, axis=0)
    gnd = []
    for i in range(len(f)):
        same = np.flatnonzero(labels == labels[i])
        gnd.append({"easy": same[same != i], "hard": np.array([], int),
                    "junk": np.array([i])})
    return evaluate_revisited(ranks, gnd, dataset="synthetic").map_easy / 100


def phase_trained_kernels(torch, gh, rb, smi: str,
                          dtype: str = "float32") -> dict:
    """7.3: the rigorous synthetic task (benchmarks/
    rigorous_synthetic_gem_r50.json's config) trained by ``train(cfg)`` at
    compute dtype ``dtype`` (its validation runs the bottleneck kernel:
    launches counted), then its 500 test images through ``extract`` (both
    kernels) and through the kernels' plain versions on the card;
    accuracy, both mAPs and the int8 engine's agreement with the fp32
    engine.  At float32 the kernels' descriptors hold to the plain
    versions' at atol 1e-4; at bf16 both are held against the trained
    weights' fp32 descriptors, and the kernels' error may not exceed 1.5x
    the plain versions' own."""
    from research_image_retrieval_tpu_torch.data import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        SyntheticRetrievalDataset,
    )
    from research_image_retrieval_tpu_torch.index import extract_vectors
    from research_image_retrieval_tpu_torch.models import backbone as bb
    from research_image_retrieval_tpu_torch.models import gem as gem_mod
    from research_image_retrieval_tpu_torch.ops.topk_stream import (
        int8_streaming_topk,
        quantize_gallery_int8,
        streaming_topk,
    )
    from research_image_retrieval_tpu_torch.train.driver import train
    from research_image_retrieval_tpu_torch.train.loop import make_eval_step
    from research_image_retrieval_tpu_torch.utils.config import TrainConfig

    from research_image_retrieval_tpu_torch.models import get_model

    tag = "7.3" if dtype == "float32" else "7.3-bf16"
    work = os.path.join(ROOT, "build", "chip_smoke_rigorous")
    shutil.rmtree(work, ignore_errors=True)
    cfg = TrainConfig(compute_dtype=dtype,
        model="gem_r50", model_overrides=dict(outputdim=512, s=16.0, m=0.05),
        imsize=RIGOROUS_PX, batch_size=32, num_workers=8, final_lr=1e-5,
        weight_decay=1e-4, warmup_epochs=1, num_epochs=RIGOROUS_EPOCHS,
        optimizer="adamw",
        base_lr=1e-3, synthetic_classes=50, synthetic_samples=30,
        synthetic_val_samples=10, synthetic_uint8=True, directory=work,
        print_freq=0, plot_freq=0, seed=11, save_freq=RIGOROUS_EPOCHS,
        device="cuda")
    _reset_launches(gh, rb)
    t0 = time.perf_counter()
    state, history = train(cfg)
    train_s = time.perf_counter() - t0
    val_launches = {"gem_head": gh.gem_whiten_l2.launches,
                    "bottleneck": rb.fused_bottleneck.launches}
    model = state.model.eval()
    norm = (IMAGENET_MEAN, IMAGENET_STD)
    test = SyntheticRetrievalDataset(num_classes=50, samples_per_class=10,
                                     image_size=RIGOROUS_PX, seed=cfg.seed + 2,
                                     uint8=True, signature_seed=cfg.seed)
    imgs, labels = test.as_arrays()
    ev = make_eval_step(norm)
    errs = [float(ev(state, imgs[i:i + 50], labels[i:i + 50])["top1_err"])
            for i in range(0, len(imgs), 50)]
    acc = 100.0 - float(np.mean(errs))
    run = lambda: extract_vectors(lambda x, v: model.extract(x, v),
                                  list(imgs), scales=(1.0,), bucket=128,
                                  device_scales=True, input_norm=norm,
                                  device="cuda")
    gh.gem_whiten_l2.launches = 0
    rb.fused_bottleneck.launches = 0
    vecs = run()
    launches = {"gem_head": gh.gem_whiten_l2.launches,
                "bottleneck": rb.fused_bottleneck.launches}
    kern = (bb.fused_bottleneck, gem_mod.gem_whiten_l2)
    bb.fused_bottleneck = rb.fused_bottleneck_reference
    gem_mod.gem_whiten_l2 = gh.gem_whiten_l2_reference
    try:
        plain = run()
    finally:
        bb.fused_bottleneck, gem_mod.gem_whiten_l2 = kern
    if vecs.shape != (500, 512) or not np.isfinite(vecs).all():
        raise AssertionError(f"{tag} descriptors: {vecs.shape}")
    if dtype == "float32":
        err = check_close("7.3 kernel vs plain descriptors",
                          torch.from_numpy(vecs), torch.from_numpy(plain),
                          0.0, 1e-4)
        bar = "atol 1e-4"
    else:  # both bf16 forms against the same weights computed in fp32
        twin = get_model("gem_r50", num_classes=state.model.classifier_w
                         .shape[0], **cfg.model_overrides).cuda().eval()
        twin.load_state_dict(state.model.state_dict())
        model = twin
        ref32 = run()
        err = float(np.abs(vecs - ref32).max())
        err_plain = float(np.abs(plain - ref32).max())
        if not err <= 1.5 * err_plain:
            raise AssertionError(f"7.3-bf16: kernel descriptors {err:.3e} "
                                 "from the fp32 ones, more than 1.5 x the "
                                 f"plain versions' {err_plain:.3e}")
        bar = (f"vs the fp32 descriptors; plain bf16 {err_plain:.2e}, bar "
               f"1.5x; kernel vs plain {np.abs(vecs - plain).max():.2e}")
        del twin, ref32
    ref = reference_protocol_map(vecs, labels)
    self_ex = self_excluded_map(vecs, labels)
    q8, s8 = quantize_gallery_int8(torch.from_numpy(vecs).to("cuda"))
    _, i8 = int8_streaming_topk(torch.from_numpy(vecs).to("cuda"), q8, s8,
                                k=2)
    i8 = i8.cpu().numpy()
    _, i32 = streaming_topk(vecs, vecs, k=2, device="cuda")
    agree1 = float((i8[:, 0] == i32[:, 0]).mean())
    agree2 = float((i8[:, 1] == i32[:, 1]).mean())
    same_cls = float((labels[i8[:, 1]] == labels).mean())
    print(f"train {tag}: rigorous synthetic task at {dtype} (50 classes, "
          f"{RIGOROUS_PX} px,"
          f" 30 train / 10 test per class, {RIGOROUS_EPOCHS} epochs, AdamW lr "
          "1e-3, batch 32, outputdim "
          f"512, s 16, m 0.05) via train(cfg) in {train_s:.1f} s; train loss "
          f"by epoch {[round(v, 4) for v in history['train_loss']]}, val top-1 "
          f"err {[round(v, 2) for v in history['val_top1_err']]}; "
          f"validation launches {val_launches} [{smi}]")
    print(f"train {tag}: test top-1 accuracy {acc:.2f}% (JAX record "
          f"{RIGOROUS['test_accuracy']}%); reference-protocol mAP "
          f"{ref['mAP']:.4f} P@5 {ref['P@5']:.4f} P@10 {ref['P@10']:.4f} (JAX "
          f"{RIGOROUS['reference_mAP']}); self-excluded Revisited mAP "
          f"{self_ex:.4f} (JAX {RIGOROUS['self_excluded_mAP']}); kernel "
          f"descriptors max|err| {err:.2e} ({bar}); extraction "
          f"launches {launches}; int8 engine vs fp32 engine: top-1 "
          f"{100 * agree1:.1f}% equal, nearest other row {100 * agree2:.1f}% "
          f"equal, int8's nearest other row in the query's class "
          f"{100 * same_cls:.1f}%")
    if acc < 90.0:
        raise AssertionError(f"{tag} test accuracy {acc:.2f}% < 90% floor")
    if val_launches["bottleneck"] == 0 or 0 in launches.values():
        raise AssertionError(f"{tag}: a kernel was not launched: validation "
                             f"{val_launches}, extraction {launches}")
    shutil.rmtree(work, ignore_errors=True)
    return dict(launches=launches, val_launches=val_launches, acc=acc,
                max_abs_err=err)


def phase_flagship(torch, gh, rb, smi: str) -> dict:
    """Phase 8: the rest of the flagship at full width, seeded weights
    (``seeded_init(seed=0)``): gem_r101, and gem_r50 with
    ``dilation_block5=True``.  For each: the main path (bucketed ms3,
    on-device scales) on CUDA against the port's CPU path on two images
    at 1e-4; the phase-4 fixture (128 images, 1024 px ms3) through
    ``serving_slice`` twice (the second run warm: img/s on the host
    clock), its mAP, and each kernel's launches over that run against the
    backbone passes it made (29 bottleneck launches per R101 pass, 10 per
    dilated R50 pass: its two dilated identity blocks run cuDNN)."""
    from research_image_retrieval_tpu_torch.data import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )
    from research_image_retrieval_tpu_torch.index import extract_vectors
    from research_image_retrieval_tpu_torch.models import (
        get_model,
        seeded_init,
    )

    imgs, labels = serving_fixture(16, 1024)
    few = [((im.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)
           for im in procedural_images([(512, 683), (384, 512)], seed=5)]
    kw = dict(scales=SCALES, bucket=128, batch_size=8, device_scales=True,
              antialias=False)
    out = {}
    for name, overrides, per_pass in (
            ("gem_r101", {}, 29),
            ("gem_r50 dilation_block5", dict(dilation_block5=True), 10)):
        cpu_model = get_model(name.split()[0], num_classes=8, **overrides)
        seeded_init(cpu_model, seed=0)
        cpu_model.eval()
        gpu_model = copy.deepcopy(cpu_model).cuda().eval()
        got = extract_vectors(lambda x, v: gpu_model.extract(x, v), few,
                              device="cuda", **kw)
        t0 = time.perf_counter()
        want = extract_vectors(lambda x, v: cpu_model.extract(x, v), few,
                               device="cpu", **kw)
        cpu_s = time.perf_counter() - t0
        err = check_close(f"8 {name} cuda vs cpu", torch.from_numpy(got),
                          torch.from_numpy(want), 0.0, 1e-4)
        del cpu_model
        passes = [0]
        hook = gpu_model.backbone.register_forward_hook(
            lambda *a: passes.__setitem__(0, passes[0] + 1))
        serving_slice(gpu_model, imgs, labels, SCALES, bucket=128, k=100,
                      device="cuda")  # warm: cuDNN plans of every bucket
        passes[0] = 0
        _reset_launches(gh, rb)
        res = serving_slice(gpu_model, imgs, labels, SCALES, bucket=128,
                            k=100, device="cuda")
        launches = {"gem_head": gh.gem_whiten_l2.launches,
                    "bottleneck": rb.fused_bottleneck.launches}
        hook.remove()
        if launches != {"gem_head": passes[0],
                        "bottleneck": per_pass * passes[0]}:
            raise AssertionError(f"8 {name}: launches {launches} over "
                                 f"{passes[0]} backbone passes, want "
                                 f"{per_pass} bottleneck launches per pass")
        if res["vecs"].shape != (len(imgs), 2048):
            raise AssertionError(f"8 {name}: descriptors {res['vecs'].shape}")
        img_s = len(imgs) / res["extract_s"]
        print(f"flagship 8 {name}: cuda vs cpu (2 images, ms3, bucket 128) "
              f"max|err| {err:.3e} (atol 1e-4; check {cpu_s:.1f} s); fixture "
              f"{len(imgs)} images at 1024 px ms3 warm: "
              f"{res['extract_s']:.2f} s = {img_s:.2f} img/s (host clock); "
              f"mAP E/M/H {res['mAP']}; launches {launches} over "
              f"{passes[0]} backbone passes ({per_pass} bottleneck launches "
              f"per pass) [{smi}]")
        out[name] = dict(launches=launches, img_s=img_s, mAP=res["mAP"],
                         max_abs_err=err)
        del gpu_model
        torch.cuda.empty_cache()
    return out


ZOO = (("dolg_r101", 29, 0, 512), ("solar_r101", 29, 0, 2048),
       ("delg_r50", 12, 1, 2048))  # model, bottleneck / head per pass, D


def _descriptors_close(torch, what, run, gpu_model, cpu_model) -> float:
    """max |err| of ``run``'s descriptors on the card against the CPU's
    (atol 1e-4)."""
    got = run(gpu_model, "cuda")
    want = run(cpu_model, "cpu")
    return check_close(f"{what} cuda vs cpu", torch.from_numpy(got),
                       torch.from_numpy(want), 0.0, 1e-4)


def full_width_model(torch, gh, rb, smi: str, label: str, name: str,
                     per_pass: int, heads: int, dim: int, imgs, labels,
                     few, compare=_descriptors_close, prepare=None,
                     **overrides):
    """One zoo preset at full width and depth, seeded weights
    (``seeded_init(seed=0)``, 8 classes): CUDA against the port's CPU
    path on the two images ``few`` (ms3, bucket 128, batches of 2) by
    ``compare`` (the descriptors at 1e-4); the zoo fixture
    (``ZOO_CLASSES``) through ``serving_slice``, after a warm-up on its
    first 8 images (every bucket shape): img/s on the host clock, the
    peak memory above what was allocated before it (the model's and
    earlier phases' tensors), its mAP and descriptor width;
    and each kernel's launches over that run against the backbone passes
    it made
    (a forward hook on ``backbone``, on CLIP's ``visual`` tower, or on
    the stem's ``conv1`` of a model without either).  Every extraction
    snaps extents to the model's ``extent_multiple`` (1 for a ResNet).
    ``prepare(torch, model)`` runs on the seeded CPU model first.
    Returns (results, the model on the card)."""
    from research_image_retrieval_tpu_torch.index import extract_vectors
    from research_image_retrieval_tpu_torch.models import (
        get_model,
        seeded_init,
    )

    cpu_model = get_model(name, num_classes=8, **overrides)
    seeded_init(cpu_model, seed=0)
    if prepare is not None:
        prepare(torch, cpu_model)
    cpu_model.eval()
    gpu_model = copy.deepcopy(cpu_model).cuda().eval()
    multiple = int(getattr(cpu_model, "extent_multiple", 1))
    kw = dict(scales=SCALES, bucket=128, batch_size=2, device_scales=True,
              antialias=False, extent_multiple=multiple)

    def run(model, device):
        return extract_vectors(lambda x, v: model.extract(x, v), few,
                               device=device, **kw)

    t0 = time.perf_counter()
    err = compare(torch, f"{label} {name}", run, gpu_model, cpu_model)
    cpu_s = time.perf_counter() - t0
    del cpu_model
    passes = [0]
    stem = next(getattr(gpu_model, a) for a in ("backbone", "visual", "conv1")
                if hasattr(gpu_model, a))
    hook = stem.register_forward_hook(
        lambda *a: passes.__setitem__(0, passes[0] + 1))
    # warm: cuDNN's plans; the first 8 images hold every bucket shape,
    # and a tail batch pads to the same batch size
    serving_slice(gpu_model, imgs[:8], labels[:8], SCALES, bucket=128,
                  k=8, device="cuda", extent_multiple=multiple)
    passes[0] = 0
    _reset_launches(gh, rb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # earlier phases' and the model's
    res = serving_slice(gpu_model, imgs, labels, SCALES, bucket=128, k=100,
                        device="cuda", extent_multiple=multiple)
    peak = torch.cuda.max_memory_allocated() - held
    launches = {"gem_head": gh.gem_whiten_l2.launches,
                "bottleneck": rb.fused_bottleneck.launches}
    hook.remove()
    if launches != {"gem_head": heads * passes[0],
                    "bottleneck": per_pass * passes[0]}:
        raise AssertionError(
            f"{label} {name}: launches {launches} over {passes[0]} backbone "
            f"passes, want {per_pass} bottleneck and {heads} head launches "
            "per pass")
    if res["vecs"].shape != (len(imgs), dim):
        raise AssertionError(f"{label} {name}: descriptors "
                             f"{res['vecs'].shape}, want D = {dim}")
    img_s = len(imgs) / res["extract_s"]
    print(f"zoo {label} {name}: cuda vs cpu (2 images, ms3, bucket 128, "
          f"extent multiple {multiple}) max|err| {err:.3e} (atol 1e-4; "
          f"check {cpu_s:.1f} s); fixture {len(imgs)} images at 1024 px ms3 "
          f"warm: {res['extract_s']:.2f} s = {img_s:.2f} img/s (host "
          f"clock), peak {peak / 2 ** 30:.2f} GiB above the "
          f"{held / 2 ** 30:.2f} GiB held before; mAP E/M/H {res['mAP']}; "
          f"D {dim}; launches {launches} over {passes[0]} backbone passes "
          f"({per_pass} bottleneck, {heads} head per pass) [{smi}]")
    return dict(launches=launches, passes=passes[0], img_s=img_s,
                mAP=res["mAP"], max_abs_err=err, peak=peak, held=held), \
        gpu_model


# the zoo phases' fixture: 8 classes x 8 renders at 1024 px, half of
# phase 4's, so that phases 9-13 keep the script inside its time limit
ZOO_CLASSES = 8


def _zoo_inputs():
    """(fixture images, labels, the two normalized CUDA-vs-CPU images)."""
    from research_image_retrieval_tpu_torch.data import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )

    imgs, labels = serving_fixture(ZOO_CLASSES, 1024)
    few = [((im.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)
           for im in procedural_images([(512, 683), (384, 512)], seed=5)]
    return imgs, labels, few


def phase_zoo(torch, gh, rb, smi: str) -> dict:
    """Phase 9.1: the ResNet zoo presets at full width and depth, seeded
    weights: dolg_r101, solar_r101 and delg_r50, each through
    ``full_width_model`` (29 / 29 / 12 bottleneck launches and 0 / 0 / 1
    head launches per pass: DOLG's GeM feeds ``fc_t`` and SOLAR
    L2-normalizes before its whiten, so neither is the head's function).
    Returns the models' results and the delg_r50 on the card for 9.2."""
    imgs, labels, few = _zoo_inputs()
    out, delg = {}, None
    for name, per_pass, heads, dim in ZOO:
        out[name], gpu_model = full_width_model(
            torch, gh, rb, smi, "9.1", name, per_pass, heads, dim, imgs,
            labels, few)
        if name == "delg_r50":
            delg = gpu_model
        else:
            del gpu_model
        torch.cuda.empty_cache()
    return out, delg


# preset, bottleneck / head launches per backbone pass, D
ZOO_MORE = (("spca_r101", 29, 1, 2048), ("sosnet_r50", 12, 0, 2048),
            ("spoc_r50", 12, 0, 2048), ("senet_g2_r50", 0, 0, 2048),
            ("adaptive_hybrid_r50", 12, 0, 2048))


def phase_zoo_more(torch, gh, rb, smi: str):
    """Phase 10.1: the next zoo presets (``utils/config.py PRESETS``, with
    spca_r101's ``model_overrides``) at full width and depth through
    ``full_width_model``: SpCa R101 runs the head kernel on its fused
    map (29 bottleneck + 1 head launches per pass); SoSNet, SpoC and
    AdaptiveHybrid only the bottleneck (12 per pass: none is GeM ->
    projection -> L2); SENet-G2+ neither (its SE gate sits inside each
    residual branch and its G2+ affine between pool and projection).
    Returns the results and the adaptive_hybrid_r50 on the card."""
    from research_image_retrieval_tpu_torch.utils.config import get_preset

    imgs, labels, few = _zoo_inputs()
    out, hybrid = {}, None
    for name, per_pass, heads, dim in ZOO_MORE:
        preset = get_preset(name)
        out[name], gpu_model = full_width_model(
            torch, gh, rb, smi, "10.1", preset.model, per_pass, heads, dim,
            imgs, labels, few, **preset.model_overrides)
        if name == "adaptive_hybrid_r50":
            hybrid = gpu_model
        else:
            del gpu_model
        torch.cuda.empty_cache()
    return out, hybrid


def phase_hybrid_gallery(torch, gh, rb, smi: str, model) -> dict:
    """Phase 10.2: ``index.HybridGallery`` on the card with 10.1's
    adaptive_hybrid_r50 and a QAFF drawn by ``training_init``'s laws
    (seed 0): the phase-4 fixture's 128 images resized to 512 x 512 and
    normalized are added, its 16 queries (the first render of each
    class) searched at top 100 one by one.  Times ``add`` (host clock,
    synchronized) and each search (CUDA events, median of 16).  Then a
    card gallery of the first 64 images (8 classes) is held against the
    port's CPU gallery of the same images and weights, each of those 8
    classes' queries searched on both (ids equal where neighbouring
    scores differ by more than 1e-6, scores within 1e-5): 64 and not 128
    images, so that the CPU half stays within the script's time."""
    from research_image_retrieval_tpu_torch.data import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )
    from research_image_retrieval_tpu_torch.index import (
        HybridGallery,
        resize_bilinear_np,
    )
    from research_image_retrieval_tpu_torch.models import QAFF, training_init

    imgs, labels = serving_fixture(16, 1024)
    batch = np.stack([(resize_bilinear_np(im, 512, 512) / 255.0
                       - IMAGENET_MEAN) / IMAGENET_STD for im in imgs]
                     ).astype(np.float32)
    q_idx = np.arange(0, len(imgs), 8)
    qaff = QAFF(2048)
    training_init(qaff, torch.Generator().manual_seed(0))
    cpu_model, cpu_qaff = copy.deepcopy(model).cpu(), copy.deepcopy(qaff)
    _reset_launches(gh, rb)
    gallery = HybridGallery(model, qaff, batch_size=32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gallery.add(batch, labels=labels)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    times = []
    for q in q_idx:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        gallery.search(batch[q], top_k=100)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    launches = {"gem_head": gh.gem_whiten_l2.launches,
                "bottleneck": rb.fused_bottleneck.launches}
    if launches["bottleneck"] == 0:
        raise AssertionError(f"10.2: the bottleneck kernel was not launched: "
                             f"{launches}")
    n_cmp = 64
    cmp_q = q_idx[q_idx < n_cmp]
    small = HybridGallery(model, qaff, batch_size=32)
    small.add(batch[:n_cmp], labels=labels[:n_cmp])
    got = [small.search(batch[q], top_k=100)[:2] for q in cmp_q]
    t0 = time.perf_counter()
    ref = HybridGallery(cpu_model, cpu_qaff, batch_size=32, device="cpu")
    ref.add(batch[:n_cmp], labels=labels[:n_cmp])
    want = [ref.search(batch[q], top_k=100)[:2] for q in cmp_q]
    cpu_s = time.perf_counter() - t0
    scores = np.concatenate([g[0] for g in got])
    ids = np.concatenate([g[1] for g in got])
    want_scores = np.concatenate([w[0] for w in want])
    want_ids = np.concatenate([w[1] for w in want])
    err = check_close("10.2 HybridGallery scores cuda vs cpu",
                      torch.from_numpy(scores), torch.from_numpy(want_scores),
                      0.0, 1e-5)
    n_distinct = _same_ids("10.2 HybridGallery ids", ids, want_ids,
                           want_scores, tol=1e-6)
    if not (ids[:, 0] == cmp_q).all():
        print(f"hybrid 10.2: own image at rank 1 for "
              f"{int((ids[:, 0] == cmp_q).sum())} of {len(cmp_q)} queries")
    ms = statistics.median(times)
    print(f"hybrid 10.2 HybridGallery: {len(imgs)} images at 512 px, add "
          f"{add_s:.2f} s (host clock); {len(q_idx)} queries at top 100: "
          f"{ms:.2f} ms per search (CUDA events, median; min "
          f"{min(times):.2f}, max {max(times):.2f}); launches {launches}; "
          f"on the first {n_cmp} images, {len(cmp_q)} queries at top "
          f"{n_cmp}: cuda vs cpu scores max|err| {err:.3e} (atol 1e-5), ids "
          f"equal on {n_distinct} distinct scores (cpu {cpu_s:.1f} s) "
          f"[{smi}]")
    return dict(launches=launches, add_s=add_s, search_ms=ms,
                max_abs_err=err)


def _recorded(module, name: str, calls: list):
    """Replace ``module.name`` by a wrapper that appends (args, result) of
    each call to ``calls``; returns a function that restores it."""
    real = getattr(module, name)

    def wrapped(*args, **kw):
        result = real(*args, **kw)
        calls.append((args, result))
        return result

    setattr(module, name, wrapped)
    return lambda: setattr(module, name, real)


def phase_local_rerank(torch, gh, rb, smi: str, model) -> dict:
    """Phase 9.2: ``cli.evaluate --model delg_r50 --local-rerank`` (ms3)
    on the zoo fixture as JPEG files laid out as a Revisited dataset
    (as 6.7), the seeded delg_r50 of 9.1 as a ``.pt`` checkpoint.  Its
    ranks must equal the direct pipeline's (``_local_rerank_ranks`` on
    the same model, given the CLI run's descriptors, ranks and loaders),
    and the geometric verification of every shortlisted pair on the card
    must give the CPU's inlier counts on the same locals and hypotheses
    (else the differing pairs are printed with how near each came to the
    2 px threshold).  Prints the mAP before and after the rerank and the
    rerank's wall time; returns the kernels' launches over the CLI run."""
    from research_image_retrieval_tpu_torch.cli import evaluate as cli_eval
    from research_image_retrieval_tpu_torch.evaluation import (
        compute_map_and_print,
    )
    from research_image_retrieval_tpu_torch.evaluation import driver
    from research_image_retrieval_tpu_torch.index import (
        geometric_verification_batch,
        search_topk,
    )

    enc = _jpeg_encoder()
    if enc is None:
        raise AssertionError("9.2 needs a JPEG encoder (OpenCV or PIL) to "
                             "lay the fixture out as files")
    work = os.path.join(ROOT, "build", "chip_smoke_zoo")
    shutil.rmtree(work, ignore_errors=True)
    jdir = os.path.join(work, "fixture")
    os.makedirs(jdir)
    imgs, labels = serving_fixture(ZOO_CLASSES, 1024)
    names = [f"{i:03d}.jpg" for i in range(len(imgs))]
    for name, img in zip(names, imgs):
        with open(os.path.join(jdir, name), "wb") as f:
            f.write(enc(img))
    q_idx = np.arange(0, len(imgs), 8)
    root = os.path.join(work, "revisited")
    gnd = _revisited_layout(root, jdir, names, imgs, labels, q_idx)
    ckpt = os.path.join(work, "delg_r50_seed0.pt")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, ckpt)
    out = os.path.join(work, "local_rerank.json")

    calls = []
    restore = _recorded(driver, "_local_rerank_ranks", calls)
    _reset_launches(gh, rb)
    t0 = time.perf_counter()
    try:
        cli_eval.main(["--model", "delg_r50", "--datasets", "roxford5k",
                       "--data-root", root, "--checkpoint", ckpt,
                       "--multiscale", "--local-rerank", "--output", out])
    finally:
        restore()
    cli_s = time.perf_counter() - t0
    launches = _read_launches(gh, rb, "9.2 cli.evaluate --local-rerank")
    with open(out) as f:
        got_map = tuple(json.load(f)["roxford5k"])
    (_, qvecs, vecs, ranks_in, q_loader, db_loader, cfg, dev), ranks = \
        calls[0]
    t0 = time.perf_counter()
    direct = driver._local_rerank_ranks(model, qvecs, vecs, ranks_in,
                                        q_loader, db_loader, cfg, "cuda")
    torch.cuda.synchronize()
    rerank_s = time.perf_counter() - t0
    if not np.array_equal(direct, ranks):
        raise AssertionError(
            f"9.2 cli.evaluate --local-rerank ranks differ from the direct "
            f"pipeline's on {int((direct != ranks).sum())} entries")
    before = compute_map_and_print("roxford5k", "global", "test", ranks_in,
                                   gnd, kappas=[1, 5, 10])
    after = compute_map_and_print("roxford5k", "global", "test", ranks, gnd,
                                  kappas=[1, 5, 10])
    if tuple(after) != got_map:
        raise AssertionError(f"9.2 CLI mAP {got_map} != its ranks' {after}")

    # every shortlisted pair verified on the card and on the CPU
    k = min(cfg.rerank_k, vecs.shape[0])
    _, indices = search_topk(qvecs, vecs, k=k, device="cuda")
    qd, qxy = driver.local_features(model, q_loader, np.arange(len(qvecs)),
                                    cfg.lr_top_attn, cfg.rerank_imsize,
                                    "cuda")
    union = np.unique(indices)
    gd, gxy = driver.local_features(model, db_loader, union, cfg.lr_top_attn,
                                    cfg.rerank_imsize, "cuda")
    qids = np.repeat(np.arange(len(qvecs)), k)
    gids = np.searchsorted(union, indices.reshape(-1))
    pair = (qd[qids], qxy[qids], gd[gids], gxy[gids])
    t0 = time.perf_counter()
    on_card, margin = geometric_verification_batch(*pair, device="cuda",
                                                   margins=True)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu, cpu_margin = geometric_verification_batch(*pair, device="cpu",
                                                      margins=True)
    cpu_s = time.perf_counter() - t0
    bad = np.nonzero(on_card != on_cpu)[0]
    for i in bad:
        print(f"9.2 pair {i} (query {qids[i]}, gallery {union[gids[i]]}): "
              f"card {on_card[i]:.0f} inliers, cpu {on_cpu[i]:.0f}; nearest "
              f"|err^2 - 4| card {margin[i]:.3e}, cpu {cpu_margin[i]:.3e}")
    if len(bad):
        raise AssertionError(f"9.2: inlier counts differ on {len(bad)} of "
                             f"{len(on_card)} pairs between card and CPU")
    print(f"zoo 9.2 cli.evaluate --model delg_r50 --multiscale --local-rerank "
          f"on the fixture as a Revisited dataset ({len(imgs)} images, "
          f"{len(q_idx)} queries, top {k}, {qd.shape[1]} locals each at "
          f"{cfg.rerank_imsize} px) in {cli_s:.1f} s: mAP E/M/H before the "
          f"rerank {tuple(before)}, after {tuple(after)}; ranks == the direct "
          f"pipeline's (its rerank {rerank_s:.2f} s wall); {len(on_card)} "
          f"pairs verified on the card ({card_s:.3f} s) == the CPU "
          f"({cpu_s:.2f} s), inliers {int(on_card.min())}-"
          f"{int(on_card.max())}, nearest |err^2 - 4| {margin.min():.3e}; "
          f"launches {launches} [{smi}]")
    shutil.rmtree(work, ignore_errors=True)
    return dict(launches=launches, before=before, after=after, cli_s=cli_s,
                rerank_s=rerank_s)


# preset, bottleneck / head launches per backbone pass, D
ZOO_TOKEN_HOW = (("token_r101", 29, 0, 1024), ("how_vlad_r50", 12, 0, 2048),
                 ("how_asmk_r50", 12, 0, 2048))
NEAR_TIE = 1e-5  # an ASMK selection may differ only where a gap is below


def _asmk_cuda_vs_cpu(torch, what, run, gpu_model, cpu_model) -> float:
    """ASMK's CUDA-vs-CPU check.  The selection is discontinuous in the
    distances, so each ``asmk_aggregate`` call of ``run`` (one per batch
    and scale, in the same order on both devices) is recorded on both,
    and its valid tokens' nearest centroids and keep bits compared
    first.  A token may differ only as a near tie: its two nearest
    distances, or its nearest distance and its image's threshold, within
    ``NEAR_TIE`` on the CPU (each printed with its gaps); any other
    difference fails.  Where a row's selection agrees, its ASMK vector
    is held at 1e-4; where every row agrees, the descriptors too.
    Returns the largest error held."""
    from research_image_retrieval_tpu_torch.models import how

    calls, desc = {"card": [], "cpu": []}, {}
    real = how.asmk_aggregate
    for key, dev, model in (("card", "cuda", gpu_model),
                            ("cpu", "cpu", cpu_model)):
        def recorded(x, centroids, weights, mask=None, _calls=calls[key]):
            _calls.append((x, centroids, mask, real(x, centroids, weights,
                                                    mask=mask)))
            return _calls[-1][-1]

        how.asmk_aggregate = recorded
        try:
            desc[key] = run(model, dev)
        finally:
            how.asmk_aggregate = real
    if len(calls["card"]) != len(calls["cpu"]) or not calls["cpu"]:
        raise AssertionError(f"{what}: {len(calls['card'])} ASMK calls on "
                             f"the card, {len(calls['cpu'])} on the CPU")
    err, ties, rows = 0.0, 0, 0
    for i, (g, c) in enumerate(zip(calls["card"], calls["cpu"])):
        sel = {}
        for key, (x, cen, mask, _) in (("card", g), ("cpu", c)):
            nearest, keep, dist, thresh = how.asmk_select(x, cen, mask)
            sel[key] = [t.detach().cpu().double().numpy()
                        for t in (nearest, keep, dist, thresh)]
        valid = (np.ones_like(sel["cpu"][1]) if c[2] is None
                 else c[2].cpu().numpy() > 0)
        nearest_bad = (sel["card"][0] != sel["cpu"][0]) & (valid > 0)
        keep_bad = sel["card"][1] != sel["cpu"][1]
        for b, n in zip(*np.nonzero(nearest_bad | keep_bad)):
            gaps = {}
            for key in ("cpu", "card"):
                d = np.sort(sel[key][2][b, n])
                gaps[key] = (d[1] - d[0], abs(d[0] - sel[key][3][b, 0]))
            cut = min(gaps["cpu"][0] if nearest_bad[b, n] else np.inf,
                      gaps["cpu"][1] if keep_bad[b, n] else np.inf)
            print(f"{what} ASMK call {i} image {b} token {n}: nearest "
                  f"{sel['card'][0][b, n]:.0f} / {sel['cpu'][0][b, n]:.0f}, "
                  f"keep {sel['card'][1][b, n]:.0f} / "
                  f"{sel['cpu'][1][b, n]:.0f} (card / cpu); gaps (two "
                  f"nearest, to the threshold) cpu {gaps['cpu'][0]:.3e}, "
                  f"{gaps['cpu'][1]:.3e}, card {gaps['card'][0]:.3e}, "
                  f"{gaps['card'][1]:.3e}")
            if cut >= NEAR_TIE:
                raise AssertionError(f"{what}: an ASMK selection differs "
                                     f"beyond a near tie ({cut:.3e})")
            ties += 1
        agree = ~(nearest_bad | keep_bad).any(axis=1)
        rows += int(agree.sum())
        if agree.any():
            err = max(err, check_close(
                f"{what} ASMK vectors (call {i}) cuda vs cpu",
                g[3][torch.from_numpy(agree).cuda()].cpu(),
                c[3][torch.from_numpy(agree)], 0.0, 1e-4))
    if ties == 0:
        err = max(err, check_close(
            f"{what} cuda vs cpu", torch.from_numpy(desc["card"]),
            torch.from_numpy(desc["cpu"]), 0.0, 1e-4))
    print(f"{what}: {len(calls['cpu'])} ASMK calls, {rows} rows with equal "
          f"selections held at 1e-4, {ties} near-tied tokens"
          + ("" if ties else "; descriptors held at 1e-4"))
    return err


def phase_token_how(torch, gh, rb, smi: str) -> dict:
    """Phase 11.1: the rest of the ResNet zoo's presets at full width and
    depth through ``full_width_model``: token_r101 (29 bottleneck
    launches per pass), how_vlad_r50 and how_asmk_r50 (12 each); no head
    launch (Token's head is its ``TokenRefine``, HOW's a VLAD or ASMK
    aggregation and a Linear).  ASMK's CUDA-vs-CPU check allows near
    ties only (``_asmk_cuda_vs_cpu``)."""
    from research_image_retrieval_tpu_torch.utils.config import get_preset

    imgs, labels, few = _zoo_inputs()
    out = {}
    for name, per_pass, heads, dim in ZOO_TOKEN_HOW:
        preset = get_preset(name)
        compare = (_asmk_cuda_vs_cpu if name == "how_asmk_r50"
                   else _descriptors_close)
        out[name], gpu_model = full_width_model(
            torch, gh, rb, smi, "11.1", preset.model, per_pass, heads, dim,
            imgs, labels, few, compare=compare, **preset.model_overrides)
        del gpu_model
        torch.cuda.empty_cache()
    return out


def _chunk_ms(torch, model, q, g, iters: int = 5) -> float:
    """Median ms of ``score_from_featuremaps`` on one chunk, CUDA events
    around each call after a warm-up."""
    times = []
    with torch.no_grad():
        model.score_from_featuremaps(q, g)
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            model.score_from_featuremaps(q, g)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_cvnet_rerank(torch, gh, rb, smi: str) -> dict:
    """Phase 11.2: ``cli.evaluate --model gem_r50 --multiscale
    --cvnet-rerank --rerank-k 20`` (default ``--rerank-imsize`` 224) on
    the zoo fixture as JPEG files laid out as a Revisited dataset
    (as 9.2), a seeded gem_r50 (8 classes) and a seeded
    ``CVNetRerank(resnet50, reduction_dim=256)`` given as ``.pt`` files.
    Its ranks must equal the direct ``_cvnet_rerank_ranks`` on the CLI
    run's inputs; the bottleneck launches inside the rerank must be 12
    per feature-map pass and the head's 0.  Every shortlisted pair is
    scored on the card and by the port's CPU scorer on the same maps:
    scores within 1e-5, reranked order equal where the blended scores
    differ by more than 1e-6.  Prints the mAP before and after, the
    feature-map seconds, the scorer's ms per 16-pair chunk (CUDA events)
    at 224 and 512 px, and the peak memory at 512."""
    from research_image_retrieval_tpu_torch.cli import evaluate as cli_eval
    from research_image_retrieval_tpu_torch.evaluation import (
        compute_map_and_print,
    )
    from research_image_retrieval_tpu_torch.evaluation import driver
    from research_image_retrieval_tpu_torch.index import (
        make_cvnet_batch_scorer,
        rerank_shortlist_batched,
        search_topk,
    )
    from research_image_retrieval_tpu_torch.models import (
        CVNetRerank,
        get_model,
        seeded_init,
    )

    enc = _jpeg_encoder()
    if enc is None:
        raise AssertionError("11.2 needs a JPEG encoder (OpenCV or PIL) to "
                             "lay the fixture out as files")
    work = os.path.join(ROOT, "build", "chip_smoke_cvnet")
    shutil.rmtree(work, ignore_errors=True)
    jdir = os.path.join(work, "fixture")
    os.makedirs(jdir)
    imgs, labels = serving_fixture(ZOO_CLASSES, 1024)
    names = [f"{i:03d}.jpg" for i in range(len(imgs))]
    for name, img in zip(names, imgs):
        with open(os.path.join(jdir, name), "wb") as f:
            f.write(enc(img))
    q_idx = np.arange(0, len(imgs), 8)
    root = os.path.join(work, "revisited")
    gnd = _revisited_layout(root, jdir, names, imgs, labels, q_idx)
    gem_ckpt = os.path.join(work, "gem_r50_seed0.pt")
    gem = get_model("gem_r50", num_classes=8)
    seeded_init(gem, seed=0)
    torch.save(gem.state_dict(), gem_ckpt)
    cv_ckpt = os.path.join(work, "cvnet_r50_seed0.pt")
    cv = CVNetRerank(backbone_name="resnet50", reduction_dim=256)
    seeded_init(cv, seed=0)
    torch.save(cv.state_dict(), cv_ckpt)
    del gem, cv
    out = os.path.join(work, "cvnet_rerank.json")

    # the rerank's own launches, feature-map passes and seconds
    calls, passes, inner = [], [0], {}
    real_rerank, real_fmaps = driver._cvnet_rerank_ranks, \
        driver.cvnet_featuremaps
    real_load = driver.load_cvnet
    real_pass = CVNetRerank.extract_featuremap

    def counted_pass(self, img):
        passes[0] += 1
        return real_pass(self, img)

    def timed_fmaps(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = real_fmaps(*args, **kw)
        torch.cuda.synchronize()
        inner["fmap_s"] = inner.get("fmap_s", 0.0) + time.perf_counter() - t0
        return f

    def recorded(*args, **kw):
        _reset_launches(gh, rb)
        passes[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ranks = real_rerank(*args, **kw)
        torch.cuda.synchronize()
        inner["rerank_s"] = time.perf_counter() - t0
        inner["launches"] = {"gem_head": gh.gem_whiten_l2.launches,
                             "bottleneck": rb.fused_bottleneck.launches}
        inner["passes"] = passes[0]
        calls.append((args, ranks))
        return ranks

    driver._cvnet_rerank_ranks, driver.cvnet_featuremaps = recorded, \
        timed_fmaps
    CVNetRerank.extract_featuremap = counted_pass
    t0 = time.perf_counter()
    try:
        cli_eval.main(["--model", "gem_r50", "--datasets", "roxford5k",
                       "--data-root", root, "--checkpoint", gem_ckpt,
                       "--multiscale", "--cvnet-rerank", "--rerank-k", "20",
                       "--rerank-checkpoint", cv_ckpt, "--output", out])
    finally:
        driver._cvnet_rerank_ranks, driver.cvnet_featuremaps = real_rerank, \
            real_fmaps
        CVNetRerank.extract_featuremap = real_pass
    cli_s = time.perf_counter() - t0
    launches, n_pass = inner["launches"], inner["passes"]
    if launches != {"gem_head": 0, "bottleneck": 12 * n_pass} or n_pass == 0:
        raise AssertionError(
            f"11.2: launches {launches} inside the rerank over {n_pass} "
            "feature-map passes, want 12 bottleneck and 0 head per pass")
    with open(out) as f:
        got_map = tuple(json.load(f)["roxford5k"])
    (qvecs, vecs, ranks_in, q_loader, db_loader, cfg, dev), ranks = calls[0]
    # the direct run's reranker and feature maps serve the checks below
    held = []
    driver.load_cvnet = lambda *a: held.append(real_load(*a)) or held[-1]
    driver.cvnet_featuremaps = lambda *a: held.append(real_fmaps(*a)) or \
        held[-1]
    try:
        direct = driver._cvnet_rerank_ranks(qvecs, vecs, ranks_in, q_loader,
                                            db_loader, cfg, "cuda")
    finally:
        driver.load_cvnet, driver.cvnet_featuremaps = real_load, real_fmaps
    if not np.array_equal(direct, ranks):
        raise AssertionError(
            f"11.2 cli.evaluate --cvnet-rerank ranks differ from the direct "
            f"pipeline's on {int((direct != ranks).sum())} entries")
    before = compute_map_and_print("roxford5k", "global", "test", ranks_in,
                                   gnd, kappas=[1, 5, 10])
    after = compute_map_and_print("roxford5k", "global", "test", ranks, gnd,
                                  kappas=[1, 5, 10])
    if tuple(after) != got_map:
        raise AssertionError(f"11.2 CLI mAP {got_map} != its ranks' {after}")

    # every shortlisted pair scored on the card and on the CPU
    model, qf, gf = held
    k = min(cfg.rerank_k, vecs.shape[0])
    scores, indices = search_topk(qvecs, vecs, k=k, device="cuda")
    union = np.unique(indices)
    qids = np.repeat(np.arange(len(qvecs)), k)
    gids = np.searchsorted(union, indices.reshape(-1))
    on_card = make_cvnet_batch_scorer(model, qf, gf)(qids, gids)
    cpu_model = copy.deepcopy(model).cpu()
    t0 = time.perf_counter()
    on_cpu = make_cvnet_batch_scorer(cpu_model, qf.cpu(), gf.cpu())(qids,
                                                                    gids)
    cpu_s = time.perf_counter() - t0
    err = check_close("11.2 CVNet pair scores cuda vs cpu",
                      torch.from_numpy(on_card), torch.from_numpy(on_cpu),
                      0.0, 1e-5)
    local = np.searchsorted(union, indices)
    card_s, card_i = rerank_shortlist_batched(
        scores, local, lambda a, b: on_card, blend=cfg.rerank_blend)
    cpu_sc, cpu_i = rerank_shortlist_batched(
        scores, local, lambda a, b: on_cpu, blend=cfg.rerank_blend)
    n_distinct = _same_ids("11.2 reranked order", card_i, cpu_i, cpu_sc)
    del cpu_model

    # the scorer per 16-pair chunk at 224 and 512 px
    ms224 = _chunk_ms(torch, model, qf[qids[:16]], gf[gids[:16]])
    f512 = driver.cvnet_featuremaps(model, db_loader, np.arange(32), 512)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms512 = _chunk_ms(torch, model, f512[:16], f512[16:])
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        s512 = model.score_from_featuremaps(f512[:16], f512[16:]).cpu()
    if not (torch.isfinite(s512).all() and ((s512 >= 0) & (s512 <= 1)).all()):
        raise AssertionError(f"11.2 scores at 512 px: {s512}")
    print(f"zoo 11.2 cli.evaluate --model gem_r50 --multiscale --cvnet-rerank "
          f"--rerank-k {k} on the fixture as a Revisited dataset "
          f"({len(imgs)} images, {len(q_idx)} queries, {len(qids)} pairs, "
          f"{cfg.rerank_imsize} px maps {tuple(qf.shape[1:])}) in "
          f"{cli_s:.1f} s: mAP E/M/H before the rerank {tuple(before)}, "
          f"after {tuple(after)}; ranks == the direct pipeline's; the rerank "
          f"{inner['rerank_s']:.2f} s wall, its feature maps "
          f"{inner['fmap_s']:.2f} s ({n_pass} passes); card vs cpu pair "
          f"scores max|err| {err:.3e} (atol 1e-5; cpu {cpu_s:.1f} s), "
          f"scores {on_card.min():.4f}-{on_card.max():.4f}, reranked ids "
          f"equal on {n_distinct} distinct scores; scorer per 16-pair chunk "
          f"{ms224:.2f} ms at 224 px, {ms512:.2f} ms at 512 px (maps "
          f"{tuple(f512.shape[1:])}, CUDA events, median of 5), peak "
          f"{peak / 2 ** 30:.2f} GiB at 512; launches {launches} over "
          f"{n_pass} feature-map passes [{smi}]")
    shutil.rmtree(work, ignore_errors=True)
    return dict(launches=launches, passes=n_pass, before=before, after=after,
                cli_s=cli_s, ms224=ms224, ms512=ms512, peak=peak,
                max_abs_err=err)


# model, bottleneck / head launches per pass, D
ZOO_TRANSFORMER = (("ultron_s", 0, 0, 512), ("vit_b16", 0, 0, 768),
                   ("clip_vit_b32", 0, 0, 512), ("clip_r50", 12, 0, 1024))
NEAR_TAU = 1e-6  # a CDConv rate may differ only this near a threshold
NEAR_STEP = 1e-4  # a rounded or thresholded value may differ only this near


def _half_gap(v):
    """Distance of ``v`` from the nearest rounding boundary (k + 0.5)."""
    return np.abs(v - np.floor(v) - 0.5)


def _forced_cuda_vs_cpu(torch, what, run, gpu_model, cpu_model, module,
                        specs, near: float = NEAR_STEP) -> float:
    """The CUDA-vs-CPU check of a model with step functions on its
    extraction path: ``specs`` is ``[(name, outputs, gaps)]`` over
    functions ``module.<name>`` (each called once per batch and scale,
    in the same order on both devices).  The card's calls are recorded,
    then the CPU's, while the CPU run goes on at the card's outputs of
    every such function (the same run where none differs), so that a
    difference in one call does not carry into the next.
    ``outputs(result)`` names a call's outputs as float64 numpy arrays;
    ``gaps(args, cpu outputs)`` gives, per output, each element's
    distance from its threshold or rounding boundary on the CPU.  An
    output may differ only where that distance is below ``near`` (each
    such element printed); the continuous inputs of every call are held
    at 1e-5 and the descriptors at 1e-4.  Returns the largest error
    held."""
    reals = {name: getattr(module, name) for name, _, _ in specs}
    calls = {key: {name: [] for name in reals} for key in ("card", "cpu")}

    def recorder(key, name):
        real, card, mine = reals[name], calls["card"][name], \
            calls[key][name]

        def rec(*args):
            res = real(*args)
            mine.append(([a.detach().cpu().double() if torch.is_tensor(a)
                          else a for a in args], res))
            if key == "card":
                return res
            if len(mine) > len(card):
                raise AssertionError(f"{what}: more {name} calls on the "
                                     f"CPU than the card's {len(card)}")
            forced = card[len(mine) - 1][1]
            if torch.is_tensor(forced):
                return forced.cpu()
            return tuple(t.cpu() for t in forced)

        return rec

    desc = {}
    for key, dev, model in (("card", "cuda", gpu_model),
                            ("cpu", "cpu", cpu_model)):
        for name in reals:
            setattr(module, name, recorder(key, name))
        try:
            desc[key] = run(model, dev)
        finally:
            for name, real in reals.items():
                setattr(module, name, real)
    err, near, counts = 0.0, 0, collections.Counter()
    for name, outputs, gaps in specs:
        card, cpu = calls["card"][name], calls["cpu"][name]
        if len(card) != len(cpu) or not cpu:
            raise AssertionError(f"{what}: {len(card)} {name} calls on the "
                                 f"card, {len(cpu)} on the CPU")
        for i, ((a_card, r_card), (a_cpu, r_cpu)) in enumerate(
                zip(card, cpu)):
            for a, b in zip(a_card, a_cpu):
                if torch.is_tensor(b):
                    err = max(err, check_close(f"{what} {name} input (call "
                                               f"{i})", a, b, 0.0, 1e-5))
            o_card, o_cpu = outputs(r_card), outputs(r_cpu)
            dist = gaps([a.numpy() if torch.is_tensor(a) else a
                         for a in a_cpu], o_cpu)
            for out in o_cpu:
                counts[out] += o_cpu[out].size
                for idx in zip(*np.nonzero(o_card[out] != o_cpu[out])):
                    d = float(dist[out][idx])
                    print(f"{what} {name} call {i} {out}{[int(j) for j in idx]}: "
                          f"{o_card[out][idx]:g} / {o_cpu[out][idx]:g} "
                          f"(card / cpu), {d:.3e} from its threshold on the "
                          "CPU")
                    if d >= near:
                        raise AssertionError(f"{what}: {out} differs "
                                             f"{d:.3e} from its threshold")
                    near += 1
    err = max(err, check_close(
        f"{what} cuda vs cpu", torch.from_numpy(desc["card"]),
        torch.from_numpy(desc["cpu"]), 0.0, 1e-4))
    print(f"{what}: "
          + ", ".join(f"{len(calls['cpu'][n])} {n}" for n in reals)
          + " calls; " + ", ".join(f"{n} {k} values"
                                   for k, n in counts.items())
          + f"; {near} near-threshold differences; descriptors held at 1e-4 "
          "(the CPU at the card's selections)")
    return err


def _cdconv_cuda_vs_cpu(torch, what, run, gpu_model, cpu_model) -> float:
    """ULTRON's CUDA-vs-CPU check.  CDConv's dilation rates are a step
    function of its channel attention, so each ``dilation_rates`` call of
    ``run`` (one per CDConv, batch and scale) is compared through
    ``_forced_cuda_vs_cpu``: the CPU runs at the card's rates, a
    channel's rate may differ only where its CPU attention lies within
    ``NEAR_TAU`` of ``tau1`` or ``tau2`` (each printed), every call's
    attentions are held at 1e-5 and the descriptors at 1e-4."""
    from research_image_retrieval_tpu_torch.models import ultron

    def rates(res):
        return {"rate": (res[1].long() + 2 * res[2].long()).cpu().double()
                .numpy()}

    def gaps(args, out):
        attn, tau1, tau2 = args
        return {"rate": np.minimum(np.abs(attn - tau1), np.abs(attn - tau2))}

    return _forced_cuda_vs_cpu(torch, what, run, gpu_model, cpu_model,
                               ultron, [("dilation_rates", rates, gaps)],
                               near=NEAR_TAU)


def _calibrate_bn(torch, model):
    """Every BN's running statistics set to one seeded batch's (a
    train-mode backbone pass at momentum 1 over 4 normal 128 x 160 images,
    on the CPU).  ULTRON-S's seeded statistics normalize nothing: its
    SCALA stage's residual stream doubles per block (|x| ~ 300 after
    stage 2), the window and pooling softmaxes saturate, and float32
    alone moves its descriptors ~4e-4 from float64 on the CPU; calibrated,
    ~3e-6, below the 1e-4 bar the card is held to."""
    from research_image_retrieval_tpu_torch.models import BatchNorm

    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    saved = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 1.0
    x = torch.randn(4, 128, 160, 3, generator=torch.Generator().manual_seed(1))
    model.train()
    with torch.no_grad():
        model.backbone(x)
    for m, mo in zip(bns, saved):
        m.momentum = mo
    model.eval()


def phase_transformers(torch, gh, rb, smi: str):
    """Phase 12.1: the transformer step of the zoo at full width and depth
    through ``full_width_model``, seeded weights: ultron_s (MadaCos head;
    extents snapped to 32), vit_b16 (16), clip_vit_b32 (32) and clip_r50
    (1: its ModifiedResNet takes any extents), 12 bottleneck launches per
    clip_r50 tower pass (layers (3, 4, 6, 3) less the four projection
    blocks) and none elsewhere; no model pools with the head's function.
    ULTRON's BN statistics are calibrated on a seeded batch
    (``_calibrate_bn``) and its CUDA-vs-CPU check allows CDConv rates to
    differ only next to a threshold (``_cdconv_cuda_vs_cpu``).  Returns
    the results and the ultron_s, vit_b16 and clip_r50 on the card for
    12.2."""
    imgs, labels, few = _zoo_inputs()
    out, keep = {}, {}
    for name, per_pass, heads, dim in ZOO_TRANSFORMER:
        ultron = name.startswith("ultron")
        out[name], gpu_model = full_width_model(
            torch, gh, rb, smi, "12.1", name, per_pass, heads, dim, imgs,
            labels, few,
            compare=_cdconv_cuda_vs_cpu if ultron else _descriptors_close,
            prepare=_calibrate_bn if ultron else None)
        if name != "clip_vit_b32":
            keep[name] = gpu_model
        del gpu_model
        torch.cuda.empty_cache()
    return out, keep


def _fixture_as_revisited(work: str):
    """The zoo fixture as JPEG files laid out as a Revisited dataset
    under ``work`` (as 9.2 and 11.2): (data root, images, query ids)."""
    enc = _jpeg_encoder()
    if enc is None:
        raise AssertionError("12.2 needs a JPEG encoder (OpenCV or PIL) to "
                             "lay the fixture out as files")
    shutil.rmtree(work, ignore_errors=True)
    jdir = os.path.join(work, "fixture")
    os.makedirs(jdir)
    imgs, labels = serving_fixture(ZOO_CLASSES, 1024)
    names = [f"{i:03d}.jpg" for i in range(len(imgs))]
    for name, img in zip(names, imgs):
        with open(os.path.join(jdir, name), "wb") as f:
            f.write(enc(img))
    q_idx = np.arange(0, len(imgs), 8)
    root = os.path.join(work, "revisited")
    _revisited_layout(root, jdir, names, imgs, labels, q_idx)
    return root, imgs, q_idx


def _extents_seen(cls, calls: list):
    """Record the [B, 2] extents of every ``extract`` call of a model
    class's instances; returns a function that restores it.  The wrapper
    keeps ``extract``'s signature, which the driver's probe reads."""
    real = cls.extract

    @functools.wraps(real)
    def wrapped(self, x, valid_hw=None):
        if valid_hw is not None:
            calls.append(valid_hw.detach().cpu().numpy().copy())
        return real(self, x, valid_hw)

    cls.extract = wrapped
    return lambda: setattr(cls, "extract", real)


def phase_transformer_entry_points(torch, gh, rb, smi: str,
                                   models: dict) -> dict:
    """Phase 12.2: the entry points pass the model's grid multiple.
    ``cli.evaluate --model ultron_s --multiscale`` on the fixture laid
    out as a Revisited dataset (12.1's seeded ultron_s as a ``.pt``): the
    driver hands ``extract_vectors`` the multiple 32, every extent the
    model sees is a multiple of 32 (a sample printed beside the images'
    own sizes), and its descriptors and ranks equal the direct
    pipeline's (the CLI's loaders through ``extract_vectors`` and
    ``rank_full`` with 12.1's model).  ``cli.extract --model clip_r50
    --dataset roxford5k --multiscale``: its descriptors equal the direct
    pipeline's at 1e-6 and so do their ranks, with 12 bottleneck launches
    per tower pass.  ``ImageExtractor`` with vit_b16 answers one image
    query through the service's multiple 16, equal to the direct
    extraction at 1e-6."""
    from research_image_retrieval_tpu_torch.cli import evaluate as cli_eval
    from research_image_retrieval_tpu_torch.cli import extract as cli_extract
    from research_image_retrieval_tpu_torch.data import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )
    from research_image_retrieval_tpu_torch.data.transforms import imthumbnail
    from research_image_retrieval_tpu_torch import index as index_pkg
    from research_image_retrieval_tpu_torch.evaluation import driver
    from research_image_retrieval_tpu_torch.index import (
        extract_vectors,
        rank_full,
    )
    from research_image_retrieval_tpu_torch.models import (
        ModifiedResNet,
        ULTRONRetrievalModel,
    )
    from research_image_retrieval_tpu_torch.serve import ImageExtractor

    norm = (IMAGENET_MEAN, IMAGENET_STD)
    work = os.path.join(ROOT, "build", "chip_smoke_transformer")
    root, imgs, q_idx = _fixture_as_revisited(work)
    ckpts = {}
    for name, model in models.items():
        ckpts[name] = os.path.join(work, f"{name}_seed0.pt")
        torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                   ckpts[name])
    out = {}

    # -- cli.evaluate --model ultron_s --------------------------------------
    ev_calls, rank_calls, seen = [], [], []
    real_ev = driver.extract_vectors

    def ev(*args, **kw):
        ev_calls.append((args, kw))
        return real_ev(*args, **kw)

    driver.extract_vectors = ev
    restore = [_recorded(driver, "_rank", rank_calls),
               _extents_seen(ULTRONRetrievalModel, seen)]
    _reset_launches(gh, rb)
    t0 = time.perf_counter()
    try:
        cli_eval.main(["--model", "ultron_s", "--datasets", "roxford5k",
                       "--data-root", root, "--checkpoint",
                       ckpts["ultron_s"], "--multiscale", "--output",
                       os.path.join(work, "ultron.json")])
    finally:
        driver.extract_vectors = real_ev
        for r in restore:
            r()
    cli_s = time.perf_counter() - t0
    launches = _no_launches(gh, rb, "12.2 cli.evaluate --model ultron_s")
    mults = [kw.get("extent_multiple") for _, kw in ev_calls]
    if mults != [32, 32] or len(rank_calls) != 1:
        raise AssertionError(f"12.2 cli.evaluate: extent multiples {mults}, "
                             f"{len(rank_calls)} rankings")
    ext = np.concatenate(seen)
    if (ext % 32).any():
        raise AssertionError("12.2 cli.evaluate --model ultron_s: extents "
                             f"{ext[(ext % 32).any(axis=1)][:4]} are not "
                             "multiples of 32")
    (qvecs, vecs, _, _), ranks = rank_calls[0]
    model = models["ultron_s"]
    fn = lambda x, v: model.extract(x, v)  # noqa: E731
    dvecs, dq = (extract_vectors(fn, args[1], **{**kw, "print_freq": 0})
                 for args, kw in ev_calls)
    direct = rank_full(dq, dvecs, device="cuda")
    err = max(float(np.abs(dvecs - vecs).max()),
              float(np.abs(dq - qvecs).max()))
    if err > 1e-6 or not np.array_equal(direct, ranks):
        raise AssertionError(f"12.2 cli.evaluate --model ultron_s: "
                             f"descriptors {err:.3e} from the direct "
                             f"pipeline's, ranks equal "
                             f"{np.array_equal(direct, ranks)}")
    sizes = [im.shape[:2] for im in imgs[:4]]
    sample = sorted({tuple(e) for e in ext.tolist()})[:6]
    print(f"zoo 12.2 cli.evaluate --model ultron_s --multiscale on the "
          f"fixture as a Revisited dataset ({len(imgs)} images, "
          f"{len(q_idx)} queries) in {cli_s:.1f} s: extract_vectors given "
          f"extent_multiple 32; image sizes {sizes} -> extents seen "
          f"{sample} ... ({len(ext)} rows, all multiples of 32); "
          f"descriptors == the direct pipeline's (max|err| {err:.3e}), "
          f"ranks equal; launches {launches} [{smi}]")
    out["12.2 cli.evaluate --model ultron_s"] = dict(launches=launches,
                                                     cli_s=cli_s)

    # -- cli.extract --model clip_r50 -------------------------------------
    passes = [0]
    real_fwd = ModifiedResNet.forward

    def counted(self, *args, **kw):
        passes[0] += 1
        return real_fwd(self, *args, **kw)

    ix_calls = []
    real_ix = index_pkg.extract_vectors

    def ix(fn, images, **kw):  # keeps the CLI's decoded thumbnails
        images = list(images)
        ix_calls.append((images, kw))
        return real_ix(fn, images, **kw)

    ModifiedResNet.forward, index_pkg.extract_vectors = counted, ix
    npz = os.path.join(work, "clip_r50.npz")
    _reset_launches(gh, rb)
    t0 = time.perf_counter()
    try:
        cli_extract.main(["--model", "clip_r50", "--checkpoint",
                          ckpts["clip_r50"], "--dataset", "roxford5k",
                          "--data-root", root, "--multiscale", "--output",
                          npz])
    finally:
        ModifiedResNet.forward, index_pkg.extract_vectors = real_fwd, real_ix
    cli_s = time.perf_counter() - t0
    launches = {"gem_head": gh.gem_whiten_l2.launches,
                "bottleneck": rb.fused_bottleneck.launches}
    if passes[0] == 0 or launches != {"gem_head": 0,
                                      "bottleneck": 12 * passes[0]}:
        raise AssertionError(f"12.2 cli.extract --model clip_r50: launches "
                             f"{launches} over {passes[0]} tower passes")
    with np.load(npz) as data:
        got = data["vecs"]
    model = models["clip_r50"]
    (items, kw), = ix_calls
    if kw.get("extent_multiple") != 1:
        raise AssertionError(f"12.2 cli.extract --model clip_r50: extent "
                             f"multiple {kw.get('extent_multiple')}, want 1")
    want = extract_vectors(lambda x, v: model.extract(x, v), items,
                           **{**kw, "print_freq": 0})
    err = float(np.abs(got - want).max())
    r_got = rank_full(got[q_idx], got, device="cuda")
    r_want = rank_full(want[q_idx], want, device="cuda")
    if err > 1e-6 or not np.array_equal(r_got, r_want):
        raise AssertionError(f"12.2 cli.extract --model clip_r50: "
                             f"descriptors {err:.3e} from the direct "
                             f"pipeline's, ranks equal "
                             f"{np.array_equal(r_got, r_want)}")
    print(f"zoo 12.2 cli.extract --model clip_r50 --dataset roxford5k "
          f"--multiscale in {cli_s:.1f} s: {got.shape} descriptors == the "
          f"direct pipeline's (max|err| {err:.3e}), ranks equal; launches "
          f"{launches} over {passes[0]} tower passes (12 bottleneck per "
          f"pass) [{smi}]")
    out["12.2 cli.extract --model clip_r50"] = dict(launches=launches,
                                                    cli_s=cli_s)

    # -- ImageExtractor with vit_b16 ------------------------------------------
    svc = ImageExtractor("vit_b16", checkpoint=ckpts["vit_b16"], imsize=1024,
                         device="cuda")
    if svc._multiple != 16:
        raise AssertionError(f"12.2 ImageExtractor(vit_b16): multiple "
                             f"{svc._multiple}, want 16")
    img = imgs[1]  # 70% of the width
    seen = []
    restore = _extents_seen(type(svc._model), seen)
    _reset_launches(gh, rb)
    t0 = time.perf_counter()
    try:
        got = svc([img])
    finally:
        restore()
    ms = (time.perf_counter() - t0) * 1e3
    launches = _no_launches(gh, rb, "12.2 ImageExtractor(vit_b16)")
    model = models["vit_b16"]
    want = extract_vectors(lambda x, v: model.extract(x, v),
                           [imthumbnail(img, 1024)], scales=(1.0,),
                           bucket=128, device_scales=True, input_norm=norm,
                           extent_multiple=16, device="cuda")
    err = float(np.abs(got - want).max())
    seen = np.concatenate(seen)
    if err > 1e-6 or (seen % 16).any():
        raise AssertionError(f"12.2 ImageExtractor(vit_b16): {err:.3e} from "
                             f"the direct extraction, extents {seen}")
    print(f"zoo 12.2 ImageExtractor(vit_b16): one {img.shape[:2]} image "
          f"query in {ms:.1f} ms (first call, host clock) through the "
          f"service's multiple 16: extents {seen[:1].tolist()}, descriptor "
          f"== the direct extraction (max|err| {err:.3e}); launches "
          f"{launches} [{smi}]")
    out["12.2 ImageExtractor(vit_b16)"] = dict(launches=launches, ms=ms)
    del svc
    shutil.rmtree(work, ignore_errors=True)
    return out


# model, bottleneck / head launches per backbone pass, D
ZOO_PROTOTYPES = (("spectrum_r50", 12, 0, 512), ("iris_r50", 12, 0, 512),
                  ("sparse_r50", 12, 0, 512), ("hamlet_r50", 12, 0, 512))
def _iris_cuda_vs_cpu(torch, what, run, gpu_model, cpu_model) -> float:
    """IRIS: CASTLE's gate ``sigmoid(.) > 0.5`` zeroes a whole image's
    attended vector, so each gate is compared first (a difference only
    within ``NEAR_STEP`` of 0.5) and the CPU runs at the card's gates."""
    from research_image_retrieval_tpu_torch.models import iris

    return _forced_cuda_vs_cpu(
        torch, what, run, gpu_model, cpu_model, iris, [(
            "causal_gate",
            lambda gate: {"gate": gate.detach().cpu().double().numpy()},
            lambda args, out: {"gate": np.abs(args[0] - args[1])})])


def _sparse_cuda_vs_cpu(torch, what, run, gpu_model, cpu_model) -> float:
    """SPARSE: its encoder's ``k``, mask and its quantizer's bits and
    codes are step functions of continuous values, so both are compared
    first: ``k`` where ``D (1 - sparsity)`` is within ``NEAR_STEP`` of a
    .5 boundary, a mask bit where |x| is that near the threshold, bits
    where ``2 + 6 importance`` and codes where the clipped ``x / scale +
    zero_point`` are that near a .5 boundary; the CPU runs at the card's
    selections."""
    from research_image_retrieval_tpu_torch.models import sparse

    def select_out(res):
        k, threshold, mask = res
        return {"k": k.detach().cpu().double().numpy(),
                "mask": mask.detach().cpu().double().numpy()}

    def select_gaps(args, out):
        x, sparsity = args
        sorted_abs = np.sort(np.abs(x), axis=1)
        thr = np.take_along_axis(sorted_abs, out["k"].astype(int)[:, None]
                                 - 1, axis=1)
        return {"k": _half_gap(x.shape[1] * (1.0 - sparsity[:, 0])),
                "mask": np.abs(np.abs(x) - thr)}

    def codes_out(res):
        return {"bits": res[0].detach().cpu().double().numpy(),
                "codes": res[1].detach().cpu().double().numpy()}

    def codes_gaps(args, out):
        x_scaled, importance, lo, hi = args
        qmax = 2.0 ** out["bits"] - 1.0
        return {"bits": _half_gap(lo + (hi - lo) * importance),
                "codes": _half_gap(np.minimum(np.maximum(x_scaled, 0.0),
                                              qmax))}

    return _forced_cuda_vs_cpu(
        torch, what, run, gpu_model, cpu_model, sparse,
        [("sparse_select", select_out, select_gaps),
         ("quantize_codes", codes_out, codes_gaps)])


def phase_prototypes(torch, gh, rb, smi: str) -> dict:
    """Phase 13.1: the four research prototypes at full width and depth
    through ``full_width_model`` (ResNet-50, 512-d, seeded weights): 12
    bottleneck launches per backbone pass (HAMLET's taps of layer2-4
    included) and no head launch (none is GeM -> whitening -> L2).
    IRIS's and SPARSE's CUDA-vs-CPU checks compare their selections
    first and run the CPU at the card's (``_iris_cuda_vs_cpu``,
    ``_sparse_cuda_vs_cpu``)."""
    imgs, labels, few = _zoo_inputs()
    compares = {"iris_r50": _iris_cuda_vs_cpu,
                "sparse_r50": _sparse_cuda_vs_cpu}
    out = {}
    for name, per_pass, heads, dim in ZOO_PROTOTYPES:
        out[name], gpu_model = full_width_model(
            torch, gh, rb, smi, "13.1", name, per_pass, heads, dim, imgs,
            labels, few, compare=compares.get(name, _descriptors_close))
        del gpu_model
        torch.cuda.empty_cache()
    return out


# model, overrides, with a teacher table (text_dim 768, DistilBERT's)
PROTOTYPE_STEPS = (("sparse_r50", {}, True), ("hamlet_r50", {}, True),
                   ("spectrum_r50", {}, False),
                   ("iris_r50", {"dropout": 0.0}, False))


def phase_prototype_train(torch, smi: str) -> None:
    """Phase 13.2: each prototype's train step on the card against the
    CPU (``check_cuda_train_step`` at its SHAPE and BARS, float64, after
    the float32 TF32 check), SPARSE and HAMLET distilling from a seeded
    [classes, 768] teacher table held on the card and gathered there by
    label; IRIS at dropout 0."""
    from research_image_retrieval_tpu_torch.train.device_check import (
        SHAPE,
        check_cuda_train_step,
    )

    rng = np.random.default_rng(SHAPE["seed"] + 13)
    for name, overrides, teacher in PROTOTYPE_STEPS:
        table = None
        if teacher:
            table = torch.from_numpy(rng.standard_normal(
                (SHAPE["classes"], 768)).astype(np.float32)).cuda()
        t0 = time.perf_counter()
        par = check_cuda_train_step(name, overrides, teacher_table=table)
        print(f"train 13.2 {name}{' + teacher table' if teacher else ''}"
              f"{' ' + str(overrides) if overrides else ''}: one step at "
              f"batch {SHAPE['batch']}, {SHAPE['px']} px, resnet50, "
              f"{SHAPE['classes']} classes, cuda vs cpu in float64 "
              "(deviation / bar, worst leaf): "
              + "; ".join(f"{k} {d:.2e} / {b} {leaf}"
                          for k, (d, b, leaf) in par.items())
              + f"; TF32 off in float32 ({time.perf_counter() - t0:.1f} s) "
              f"[{smi}]")
        del table
        torch.cuda.empty_cache()


# token_r101 under its own rules (``device_check.RULES``: a zero running
# mean at the zero-leaf bar, grad_norm against the CPU's measured floor);
# spca_r101 under BARS, its distance masks in the model's dtype
ZOO_STEPS = (("ultron_s", ("adamw", "sgd")), ("token_r101", ("sgd",)),
             ("spca_r101", ("sgd",)))


def phase_zoo_train(torch, smi: str) -> None:
    """Phase 13.3: the zoo's train steps on the card against the CPU
    (``check_cuda_train_step``, float64, after the float32 TF32 check):
    ultron_s's AdamW step, then an SGD step after the hand-off, as
    ``adamw_then_sgd`` does; one SGD step each of token_r101 and
    spca_r101."""
    from research_image_retrieval_tpu_torch.train.device_check import (
        SHAPE,
        check_cuda_train_step,
    )

    for name, optimizers in ZOO_STEPS:
        t0 = time.perf_counter()
        par = check_cuda_train_step(name, optimizers=optimizers)
        print(f"train 13.3 {name} ({' -> '.join(optimizers)}): batch "
              f"{SHAPE['batch']}, {SHAPE['px']} px, {SHAPE['classes']} "
              "classes, cuda vs cpu in float64 (deviation / bar, worst "
              "leaf): " + "; ".join(f"{k} {d:.2e} / {b} {leaf}"
                                    for k, (d, b, leaf) in par.items())
              + f"; TF32 off in float32 ({time.perf_counter() - t0:.1f} s) "
              f"[{smi}]")
        torch.cuda.empty_cache()


def _free_port() -> int:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def phase_nccl_world_of_one(torch, smi: str, plain: dict) -> None:
    """14.1: one NCCL rank (``init_distributed_mode(force=True)``) runs
    7.1's step at full width (GeM-R50, 81,313-way ArcFace, 512 px uint8,
    7.1's batch, SGD with TrainConfig's defaults) through
    ``make_train_step(mesh=make_mesh(1, 1))``: every collective of the
    layout runs (BN statistics and backward sums, the gradient buckets,
    the metrics).  Three steps from one init inside
    ``deterministic_mode()`` against the plain step's three (each leaf's
    deviation over its largest change, bar 1e-6); then ms per step of
    each, 3 steps between CUDA events after 1."""
    import torch.distributed as dist

    from research_image_retrieval_tpu_torch.data import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )
    from research_image_retrieval_tpu_torch.models import get_model
    from research_image_retrieval_tpu_torch.parallel import (
        init_distributed_mode,
        make_mesh,
    )
    from research_image_retrieval_tpu_torch.train import (
        create_train_state,
        make_sgd_optimizer,
        make_train_step,
    )
    from research_image_retrieval_tpu_torch.utils.config import TrainConfig
    from research_image_retrieval_tpu_torch.utils.profiling import (
        deterministic_mode,
    )

    t_phase = time.perf_counter()
    init_distributed_mode(f"127.0.0.1:{_free_port()}", device="cuda:0",
                          force=True, quiet_non_main=False)
    try:
        backend = dist.get_backend()
        if backend != "nccl":
            raise AssertionError(f"14.1 ran on {backend}, not NCCL")
        mesh = make_mesh(1, 1)
        cfg = TrainConfig()
        tx = make_sgd_optimizer(cfg.base_lr, momentum=cfg.momentum,
                                weight_decay=cfg.weight_decay,
                                clip_max_norm=cfg.clip_max_norm)
        state = create_train_state(get_model("gem_r50",
                                             num_classes=TRAIN_CLASSES),
                                   0, tx, device="cuda")
        init = {k: v.detach().cpu() for k, v in
                state.model.state_dict().items()}
        B = plain["batch"]
        g = torch.Generator(device="cuda").manual_seed(14)
        batches = [(torch.randint(0, 256, (B, TRAIN_PX, TRAIN_PX, 3),
                                  dtype=torch.uint8, device="cuda",
                                  generator=g),
                    torch.randint(0, TRAIN_CLASSES, (B,), device="cuda",
                                  generator=g)) for _ in range(3)]
        norm = (IMAGENET_MEAN, IMAGENET_STD)
        steps = {"plain": make_train_step(norm),
                 "nccl": make_train_step(norm, mesh=mesh)}

        def fresh():
            state.model.load_state_dict(init)
            state.optimizer = tx.init(state.model)
            state.step = 0

        after, loss = {}, {}
        for name, step in steps.items():
            fresh()
            with deterministic_mode():
                for x, y in batches:
                    _, m = step(state, x, y)
            loss[name] = float(m["loss"])
            after[name] = {n: p.detach().cpu() for n, p in
                           state.model.named_parameters()}
        devs = {}
        for n, want in after["plain"].items():
            change = (want - init[n]).abs().max().clamp(min=1e-30)
            devs[n] = float((after["nccl"][n] - want).abs().max() / change)
        worst = max(devs, key=devs.get)
        if not devs[worst] <= 1e-6 or loss["plain"] != loss["nccl"]:
            raise AssertionError(f"14.1: NCCL step vs plain: {worst} "
                                 f"{devs[worst]:.3e} of its change (bar "
                                 f"1e-6), losses {loss}")
        ms = {}
        for name, step in steps.items():
            fresh()
            step(state, *batches[0])
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            a.record()
            for x, y in batches:
                step(state, x, y)
            b.record()
            b.synchronize()
            ms[name] = a.elapsed_time(b) / len(batches)
        print(f"train 14.1: NCCL at world size 1, GeM-R50 {TRAIN_CLASSES}-way "
              f"ArcFace, {TRAIN_PX} px, batch {B}: 3 steps through "
              f"make_train_step(mesh=(1, 1)) vs the plain step in "
              f"deterministic_mode: worst leaf {worst} {devs[worst]:.3e} of "
              f"its change (bar 1e-6), loss {loss['nccl']:.6f} == "
              f"{loss['plain']:.6f}; ms per step (3 steps between CUDA "
              f"events after 1): NCCL layout {ms['nccl']:.1f}, plain "
              f"{ms['plain']:.1f} (7.1: {plain['ms']:.1f}); "
              f"{time.perf_counter() - t_phase:.1f} s [{smi}]")
        del state, batches, after, init
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def phase_dist_dryrun(torch, gh, rb, smi: str) -> dict:
    """14.2: ``parallel.dryrun_worker`` as two gloo ranks sharing
    ``cuda:0`` (the float64 layout steps at ``device_check``'s size, the
    cross-process search, rank-sharded extraction of 16 fixture images
    at full width); the ranks' launch counts must sum to the
    single-process run's, both non-zero."""
    work = os.path.join(ROOT, "build", "chip_smoke_dist")
    os.makedirs(work, exist_ok=True)
    imgs, labels = serving_fixture(2, 1024)
    fixture = os.path.join(work, "fixture.npz")
    np.savez(fixture, labels=np.asarray(labels),
             **{f"img_{i}": im for i, im in enumerate(imgs)})
    env = {**os.environ, "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "2"}
    cmd = [sys.executable, "-m",
           "research_image_retrieval_tpu_torch.parallel.dryrun_worker",
           "--device", "cuda:0", "--size", "check", "--fixture", fixture]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, cwd=ROOT, env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=400)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    shutil.rmtree(work, ignore_errors=True)
    rows = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        line = [ln for ln in out.splitlines()
                if ln.startswith(f"RANK{r}_DRYRUN_OK ")]
        if p.returncode != 0 or not line:
            raise AssertionError(f"14.2 rank {r} exited {p.returncode}:\n"
                                 f"{out[-3000:]}")
        rows.append(json.loads(line[0].split(" ", 1)[1]))
    single = rows[0]["launches"]["single"]
    summed = {k: sum(row["launches"]["sharded"][k] for row in rows)
              for k in single}
    if summed != single or 0 in single.values() or \
            rows[1]["launches"]["single"] != single:
        raise AssertionError(f"14.2 launches: ranks' sharded "
                             f"{[row['launches']['sharded'] for row in rows]}"
                             f" vs single {single}")
    if rows[0]["mAP"] != rows[1]["mAP"]:
        raise AssertionError(f"14.2 mAP {rows[0]['mAP']} vs {rows[1]['mAP']}")
    steps = "; ".join(
        f"{lay}: " + ", ".join(f"{k} {v:.2e}" for k, v in dev.items())
        for lay, dev in rows[0]["steps"].items())
    print(f"dist 14.2: dryrun_worker, 2 gloo ranks sharing cuda:0, "
          f"{time.perf_counter() - t0:.1f} s: float64 layout steps vs the "
          f"single-device step at batch 2, 128 px, resnet50, 512 classes "
          f"(loss / grad_norm relative, parameters / BN statistics "
          f"absolute; bars 1e-10 / 1e-9): {steps}; cross-process search "
          f"exact + int8 ids == single engine; rank-sharded extraction of "
          f"{rows[0]['images']} fixture images (gem_r50, 1024 px ms3, "
          f"batch 1): max |dev| {max(r['extract_dev'] for r in rows):.3e} "
          f"(bar 1e-5), mAP E/M/H {rows[0]['mAP']} on both ranks == single "
          f"process; launches per rank {[r['launches']['sharded'] for r in rows]}"
          f" sum to the single run's {single} [{smi}]")
    return {"single": single, "ranks": [r["launches"]["sharded"]
                                        for r in rows]}


def phase_sharded_serving(torch, smi: str) -> None:
    """14.3: ``SearchService`` over a 1.4M x 2048 gallery row-sharded over
    ``["cuda:0"] * 4`` against the unsharded service, exact (bf16 store)
    and int8: ids where the scores are distinct by more than 1e-6,
    scores (int8 equal, exact within 1e-5), then p50 / p99 at one client
    (40 one-query requests) of each."""
    from research_image_retrieval_tpu_torch.serve import SearchService

    t0 = time.perf_counter()
    head = np.random.default_rng(14).standard_normal((16, 2048))
    head = (head / np.linalg.norm(head, axis=1, keepdims=True)).astype(
        np.float32)
    g32, g16, q8, s8 = _build_gallery(torch, head, SERVE_N, seed=14)
    del g32
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(15)
    rq = torch.randn((64, 2048), device="cuda", generator=gen)
    queries = (rq / torch.linalg.vector_norm(rq, dim=1,
                                             keepdim=True)).cpu().numpy()
    shards = ["cuda:0"] * 4
    for name, kw in (("exact-bf16", dict(gallery=g16, engine="exact",
                                         store_dtype="bfloat16")),
                     ("int8", dict(vecs_int8=q8, scales=s8,
                                   engine="int8"))):
        lat = {}
        with SearchService(k=SERVE_K, max_batch=32, **kw) as one, \
                SearchService(k=SERVE_K, max_batch=32, mesh=shards,
                              **kw) as four:
            one.warmup()
            four.warmup()
            s1, i1 = one.search(queries[:32])
            s4, i4 = four.search(queries[:32])
            n = _same_ids(f"14.3 {name} sharded vs unsharded", i4, i1, s1)
            check_close(f"14.3 {name} scores", torch.from_numpy(s4),
                        torch.from_numpy(s1), 0.0,
                        0.0 if name == "int8" else 1e-5)
            if four.stats()["shards"] != 4:
                raise AssertionError(f"14.3 stats {four.stats()}")
            for label, svc in (("unsharded", one), ("4 shards", four)):
                lat[label] = _load_clients(svc, queries, 1, 40, SERVE_K)
        print(f"serving 14.3 {name}: {SERVE_N} x 2048 over "
              f"['cuda:0'] x 4 vs one shard: ids equal on {n} distinct "
              f"scores of 32 x {SERVE_K}, scores "
              f"{'equal' if name == 'int8' else 'within 1e-5'}; one client "
              f"x 40 one-query requests, k={SERVE_K}: p50 "
              f"{lat['4 shards']['p50']:.3f} ms sharded vs "
              f"{lat['unsharded']['p50']:.3f} ms unsharded, p99 "
              f"{lat['4 shards']['p99']:.3f} vs "
              f"{lat['unsharded']['p99']:.3f} ms (host clock) [{smi}]")
    del g16, q8, s8
    torch.cuda.empty_cache()
    print(f"serving 14.3: {time.perf_counter() - t0:.1f} s")


# -- phase 15: the split JPEG decode ----------------------------------------

DCT_K = 4  # coefficients per block side shipped by the host


def _dct_plan(items, kw, batch: int) -> int:
    """The dispatches ``extract_vectors(dct_decode=True)`` makes over
    ``items`` with ``kw``: per bucket key (``_DctAccumStream``'s, the RGB
    items' included), its items in batches of ``batch``."""
    import torch

    from research_image_retrieval_tpu_torch.index import extract as ex

    stream = ex._DctAccumStream(
        None, kw["bucket"], batch, kw["scales"], torch.device("cpu"),
        input_norm=kw["input_norm"], extent_multiple=kw["extent_multiple"])
    keys = collections.Counter(stream._key_and_task(i, item)[0]
                               for i, item in enumerate(items))
    return sum(-(-n // batch) for n in keys.values())


def phase_dct_decode(torch, gh, rb, smi: str, classes: int = 16,
                     imsize: int = 1024) -> dict:
    """Phase 15: the split JPEG decode (the host entropy-decodes with the
    port's own decoder, ``csrc/jpeg_coeffs.cc``, built here by g++ with no
    libjpeg; the card dequantizes, inverse-transforms, upsamples and
    converts) through ``cli.evaluate --model gem_r50 --multiscale
    --dct-decode 4`` at full width and depth (``seeded_init(seed=0)``,
    1024 px) on the phase-4 fixture's JPEGs laid out as a Revisited
    dataset, plus a progressive JPEG and a 2,100 px source (DCT-domain
    prescale to ``out_block`` 4) in the gallery.  The boxed queries take
    the RGB path, every gallery file the coefficient path.

    Checks: the card's k = 8 decode of two files (one baseline, the
    progressive one) within JAX's bars of OpenCV's full decode (max < 6
    inside the whole MCUs, printed with the edge MCUs too, where
    libjpeg's upsampling replicates the last valid chroma sample and
    the device decode, as JAX's, reads the encoder's padding; mean < 1
    on 0..255); the card's device decode equal to the CPU's
    (1e-3); every gallery item on the coefficient path; the kernels'
    launches equal to the bucket plan's (12 bottleneck and 1 head per
    backbone pass, 3 passes per batch); two descriptors (a fixture file
    and the 2,100 px one) within 1e-4 of the port's CPU DCT path; the
    CLI's mAP equal to the card descriptors' ranked on the CPU.  Prints
    the host decode ms per image, the wire bytes per image against the
    RGB thumbnail's, each descriptor's cosine to the RGB path's (raw and
    with the fixture's mean descriptor subtracted; JAX's bar 0.997) and
    the gallery's img/s on both paths (host clock, warm)."""
    import inspect

    import cv2

    from research_image_retrieval_tpu_torch.cli import evaluate as cli_eval
    from research_image_retrieval_tpu_torch.data import (
        ImageFromList,
        PrefetchedImages,
    )
    from research_image_retrieval_tpu_torch.data import native_decode as nd
    from research_image_retrieval_tpu_torch.evaluation import (
        compute_map_and_print,
    )
    from research_image_retrieval_tpu_torch.evaluation import driver
    from research_image_retrieval_tpu_torch.index import (
        extract_vectors,
        rank_full,
    )
    from research_image_retrieval_tpu_torch.models import (
        get_model,
        seeded_init,
    )
    from research_image_retrieval_tpu_torch.ops.jpeg_decode import (
        dct_decode_rgb,
    )

    t_phase = time.perf_counter()
    if not nd.coeffs_available():
        raise AssertionError("15: the coefficient decoder "
                             "(csrc/jpeg_coeffs.cc) did not build with g++")
    build_s = time.perf_counter() - t_phase
    work = os.path.join(ROOT, "build", "chip_smoke_dct")
    shutil.rmtree(work, ignore_errors=True)
    jdir = os.path.join(work, "fixture")
    os.makedirs(jdir)
    imgs, labels = serving_fixture(classes, imsize)
    nf = len(imgs)  # p003 and b002 follow
    bgr = lambda im: cv2.cvtColor(im, cv2.COLOR_RGB2BGR)  # noqa: E731
    files = {f"{i:03d}.jpg": cv2.imencode(
        ".jpg", bgr(im), [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes()
        for i, im in enumerate(imgs)}
    # a progressive copy of image 3 and a 2,100 px upscale of image 2
    files["p003.jpg"] = cv2.imencode(
        ".jpg", bgr(imgs[3]), [cv2.IMWRITE_JPEG_QUALITY, 95,
                               cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    h, w = imgs[2].shape[:2]
    side = 2100 * imsize // 1024  # out_block 4 at imsize
    big = cv2.resize(imgs[2], (side, round(h * side / w)),
                     interpolation=cv2.INTER_CUBIC)
    files["b002.jpg"] = cv2.imencode(
        ".jpg", bgr(big), [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes()
    names = list(files)
    for n in names:
        with open(os.path.join(jdir, n), "wb") as f:
            f.write(files[n])
    imgs = imgs + [imgs[3], big]
    labels = np.asarray(list(labels) + [labels[3], labels[2]])
    q_idx = np.arange(0, nf, 8)
    root = os.path.join(work, "revisited")
    gnd = _revisited_layout(root, jdir, names, imgs, labels, q_idx)

    # -- the host half: k = 8 on the card against OpenCV's full decode ---
    host = []
    for n in ("001.jpg", "p003.jpg"):
        co = nd.decode_jpeg_coeffs(files[n], k=8)
        t = [torch.from_numpy(a[None]).cuda() for a in
             (co.coef_y, co.coef_c, co.quant_y, co.quant_c)]
        dec = dct_decode_rgb(*t, co.subsamp, 8)[0, :co.h, :co.w].cpu()
        ref = torch.from_numpy(cv2.cvtColor(cv2.imdecode(
            np.frombuffer(files[n], np.uint8), cv2.IMREAD_COLOR),
            cv2.COLOR_BGR2RGB).astype(np.float32))
        d = (dec - ref).abs()
        # the last partial MCU row / column: libjpeg's fancy upsampling
        # replicates the last valid chroma sample, the device decode (as
        # JAX's) reads the encoder's padding there
        m = 16 if co.subsamp == 2 else 8
        inner = d[:co.h // m * m, :co.w // m * m]
        host.append((n, float(inner.max()), float(d.mean()), float(d.max())))
        if not (inner.max() < 6.0 and d.mean() < 1.0):
            raise AssertionError(f"15 {n}: k=8 card decode vs OpenCV max "
                                 f"{float(inner.max()):.3f} inside the "
                                 f"whole MCUs, mean {float(d.mean()):.4f} "
                                 "(bars 6, 1)")
    gal = [os.path.join(root, "roxford5k", "jpg", n) for n in names]
    t0 = time.perf_counter()
    coeffs = [nd.decode_jpeg_coeffs(files[n], k=DCT_K) for n in names]
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(names)
    loader = ImageFromList(gal, imsize=imsize, raw_uint8=True,
                           dct_coeffs=DCT_K)
    items = [loader[i] for i in range(len(gal))]
    wire = sum(it.nbytes + it.quant_y.nbytes + it.quant_c.nbytes
               for it in items) / len(items)
    rgb_bytes = sum(3 * it.target_hw[0] * it.target_hw[1]
                    for it in items) / len(items)
    if any(c is None for c in coeffs):
        raise AssertionError("15: the decoder refused a fixture file")

    # -- the device half: the card's decode against the CPU's ------------
    dev_err = 0.0
    for idx, name in ((1, "001.jpg"), (nf + 1, "b002.jpg")):
        it = items[idx]
        arrays = [torch.from_numpy(a[None]) for a in
                  (it.coef_y, it.coef_c, it.quant_y, it.quant_c)]
        cpu = dct_decode_rgb(*arrays, it.subsamp, it.out_block)
        card = dct_decode_rgb(*(a.cuda() for a in arrays), it.subsamp,
                              it.out_block).cpu()
        dev_err = max(dev_err, check_close(f"15 device decode {name}", card,
                                           cpu, 0.0, 1e-3))
    if items[nf + 1].out_block != 4 or items[nf].k != DCT_K:
        raise AssertionError(f"15: b002 out_block {items[nf + 1].out_block}, "
                             "want 4")

    # -- the slice: cli.evaluate --dct-decode 4 --------------------------
    ckpt = os.path.join(work, "gem_r50_seed0.pt")
    gem = get_model("gem_r50", num_classes=8)
    seeded_init(gem, seed=0)
    torch.save(gem.state_dict(), ckpt)
    out = os.path.join(work, "dct.json")
    calls = []
    real = driver.extract_vectors

    def recorded(fn, images, **kw):
        seen = []

        def feed():
            for img in images:
                seen.append(img)
                yield img
        vecs = real(fn, feed(), **kw)
        calls.append((seen, kw, vecs))
        return vecs

    driver.extract_vectors = recorded
    _reset_launches(gh, rb)
    t0 = time.perf_counter()
    try:
        cli_eval.main(["--model", "gem_r50", "--datasets", "roxford5k",
                       "--data-root", root, "--checkpoint", ckpt,
                       "--multiscale", "--dct-decode", str(DCT_K),
                       "--imsize", str(imsize), "--output", out])
    finally:
        driver.extract_vectors = real
    cli_s = time.perf_counter() - t0
    launches = {"gem_head": gh.gem_whiten_l2.launches,
                "bottleneck": rb.fused_bottleneck.launches}
    with open(out) as f:
        got_map = tuple(json.load(f)["roxford5k"])
    (g_items, kw, vecs), (q_items, _, qvecs) = calls
    paths = {"coefficients": sum(isinstance(i, nd.JpegCoeffs)
                                 for i in g_items + q_items)}
    paths["rgb"] = len(g_items) + len(q_items) - paths["coefficients"]
    if not all(isinstance(i, nd.JpegCoeffs) for i in g_items) or \
            any(isinstance(i, nd.JpegCoeffs) for i in q_items) or \
            g_items[nf].k != DCT_K or g_items[nf + 1].out_block != 4:
        raise AssertionError(f"15 routes: {paths}; every gallery file "
                             "(p003, b002 included) must take the "
                             "coefficient path, every boxed query RGB")
    batch = inspect.signature(real).parameters["batch_size"].default
    n_batches = _dct_plan(g_items, kw, batch) + _dct_plan(q_items, kw, batch)
    n_pass = len(kw["scales"]) * n_batches
    want = {"gem_head": n_pass, "bottleneck": 12 * n_pass}
    if launches != want:
        raise AssertionError(f"15 launches {launches}, the bucket plan's "
                             f"{want} ({n_batches} batches)")

    # -- descriptors and mAP against the CPU ------------------------------
    cpu_model = copy.deepcopy(gem).eval()
    ck = dict(kw, device="cpu", batch_size=1)  # the two differ in bucket
    t0 = time.perf_counter()
    cpu_vecs = extract_vectors(lambda x, v: cpu_model.extract(x, v),
                               [g_items[1], g_items[nf + 1]], **ck)
    cpu_s = time.perf_counter() - t0
    err = check_close("15 descriptors card vs cpu",
                      torch.from_numpy(vecs[[1, nf + 1]]),
                      torch.from_numpy(cpu_vecs), 0.0, 1e-4)
    # the CLI ranked on the card; the same descriptors ranked on the CPU
    # give the same ids wherever the scores are distinct, and its mAP
    card_ranks = rank_full(qvecs, vecs, device="cuda")
    cpu_ranks = rank_full(qvecs, vecs, device="cpu")
    scores = np.take_along_axis(qvecs.astype(np.float64) @ vecs.T.astype(
        np.float64), card_ranks.T, axis=1)
    n_distinct = _same_ids("15 ranks card vs cpu", cpu_ranks.T, card_ranks.T,
                           scores)
    cpu_map = compute_map_and_print("roxford5k", "global", "test",
                                    cpu_ranks, gnd, kappas=[1, 5, 10])
    if vecs.shape != (len(names), 2048) or (
            np.array_equal(cpu_ranks, card_ranks)
            and tuple(cpu_map) != got_map):
        raise AssertionError(f"15 mAP {got_map} vs the CPU's ranks "
                             f"{tuple(cpu_map)}; vecs {vecs.shape}")

    # -- the RGB path beside it: cosines and img/s (warm) ----------------
    model = gem.cuda().eval()
    fn = lambda x, v: model.extract(x, v)  # noqa: E731

    def timed(dct: bool):
        lo = PrefetchedImages(ImageFromList(
            gal, imsize=imsize, raw_uint8=True,
            dct_coeffs=DCT_K if dct else 0))
        torch.cuda.synchronize()
        t = time.perf_counter()
        v = extract_vectors(fn, lo, **dict(kw, device="cuda",
                                           dct_decode=dct))
        return v, len(gal) / (time.perf_counter() - t)

    rgb_vecs, _ = timed(False)
    _, rgb_rate = timed(False)
    dct_vecs, dct_rate = timed(True)
    cos = np.sum(dct_vecs * rgb_vecs, axis=1)
    mean = rgb_vecs.mean(axis=0)
    a, b = dct_vecs - mean, rgb_vecs - mean
    ccos = np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1)
                                    * np.linalg.norm(b, axis=1))
    del model, cpu_model, gem
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    print(f"dct 15: decoder build {build_s:.1f} s (g++, no libjpeg); host "
          f"half k=8 card decode vs OpenCV (max inside the whole MCUs / "
          f"mean on 0..255, bars 6 / 1; max with the partial edge MCUs): "
          + ", ".join(f"{n} {m:.3f} / {e:.4f}; {w:.3f}"
                      for n, m, e, w in host)
          + f"; host entropy decode {decode_ms:.2f} ms per image (one "
          f"thread, {len(names)} files, k={DCT_K}); wire "
          f"{wire / 1e6:.3f} MB per image against {rgb_bytes / 1e6:.3f} MB "
          f"RGB uint8 ({rgb_bytes / wire:.2f}x fewer); device decode card "
          f"vs cpu max|err| {dev_err:.2e} (atol 1e-3) [{smi}]")
    print(f"dct 15: cli.evaluate --model gem_r50 --multiscale --dct-decode "
          f"{DCT_K} ({len(names)} gallery files, {len(q_idx)} boxed "
          f"queries, {imsize} px) in {cli_s:.1f} s: items per path {paths} "
          f"(p003 progressive and b002 2100 px, out_block "
          f"{g_items[nf + 1].out_block}, on coefficients); launches {launches}"
          f" == the bucket plan's ({n_batches} batches x 3 scales x 12 / "
          f"1); descriptors card vs cpu (001, b002) max|err| {err:.3e} "
          f"(atol 1e-4, cpu {cpu_s:.1f} s); mAP E/M/H {got_map}, on the "
          f"CPU's ranks {tuple(cpu_map)} (ids equal on {n_distinct} "
          f"distinct scores); cosine to the RGB path min {cos.min():.5f} mean "
          f"{cos.mean():.5f} (JAX's bar 0.997; the fixture's descriptors "
          f"are nearly collinear), mean-subtracted min {ccos.min():.4f} "
          f"mean {ccos.mean():.4f}; gallery img/s (host clock, warm) "
          f"{dct_rate:.2f} split decode vs {rgb_rate:.2f} RGB "
          f"({time.perf_counter() - t_phase:.1f} s) [{smi}]")
    return {"launches": launches, "img_s": dct_rate, "rgb_img_s": rgb_rate,
            "decode_ms": decode_ms, "wire": wire, "rgb_bytes": rgb_bytes}


def main() -> int:
    # cuBLAS reads this when the process makes its first handle; 7.2's
    # deterministic_mode() needs it (utils/profiling.py)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from research_image_retrieval_tpu_torch.index import extract_vectors
    from research_image_retrieval_tpu_torch.models import (
        get_model,
        seeded_init,
    )
    from research_image_retrieval_tpu_torch.ops import _cuda
    from research_image_retrieval_tpu_torch.ops import gem_head as gh
    from research_image_retrieval_tpu_torch.ops import resblock as rb
    from research_image_retrieval_tpu_torch.data import (
        IMAGENET_MEAN,
        IMAGENET_STD,
    )
    from research_image_retrieval_tpu_torch.utils.device import fp32_precision

    # -- 1: card, versions, build ---------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"gpu: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    build_s = _cuda.build_all()
    print(f"kernel build: {build_s:.1f} s ({', '.join(_cuda.SOURCES)})")
    for name in _cuda.SOURCES:
        log = (_cuda.BUILD_DIR / f"{name}.log")
        for line in log.read_text().splitlines() if log.exists() else []:
            if any(k in line for k in ("registers", "spill", "arning")):
                print(f"  ptxas[{name}] {line.strip()}")
        print(f"  sass[{name}] tensor-core instructions: "
              f"{tensor_core_sass(_cuda.library_path(name))}")

    # -- 2: kernels against their plain versions -------------------------
    rows = {"gem_head": phase_gem_head(torch, gh),
            "bottleneck": phase_bottleneck(torch, rb, fp32_precision)}
    torch.cuda.empty_cache()
    rows_bf16 = phase_bf16_kernels(torch, gh, rb)
    torch.cuda.empty_cache()

    # -- 3: main path on CUDA vs the port's CPU path ---------------------
    cpu_model = get_model("gem_r50", num_classes=8)
    seeded_init(cpu_model, seed=0)
    cpu_model.eval()
    gpu_model = copy.deepcopy(cpu_model).cuda().eval()
    imgs = [((im.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)
            for im in procedural_images([(768, 1024), (1024, 683),
                                         (512, 512)], seed=3)]
    kw = dict(scales=SCALES, bucket=128, batch_size=8, device_scales=True,
              antialias=False)
    t0 = time.perf_counter()
    got = extract_vectors(lambda x, v: gpu_model.extract(x, v), imgs,
                          device="cuda", **kw)
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = extract_vectors(lambda x, v: cpu_model.extract(x, v), imgs,
                           device="cpu", **kw)
    t_cpu = time.perf_counter() - t0
    err = check_close("main path cuda vs cpu", torch.from_numpy(got),
                      torch.from_numpy(want), 0.0, 1e-4)
    print(f"main path (3 images, ms3, bucket 128) cuda vs cpu: max|err| "
          f"{err:.3e} (atol 1e-4); cuda {t_gpu:.2f} s, cpu {t_cpu:.2f} s")
    del cpu_model

    # -- 4: the serving slice at full width ------------------------------
    imgs, labels = serving_fixture(16, 1024)
    gh.gem_whiten_l2.launches = 0
    rb.fused_bottleneck.launches = 0
    rb.fused_bottleneck.tiles = rb.fused_bottleneck.split_tiles = 0
    res = serving_slice(gpu_model, imgs, labels, SCALES, bucket=128, k=100,
                        device="cuda")
    launches = {"gem_head": gh.gem_whiten_l2.launches,
                "bottleneck": rb.fused_bottleneck.launches}
    tiles = {"tiles": rb.fused_bottleneck.tiles,
             "split_tiles": rb.fused_bottleneck.split_tiles}
    if res["vecs"].shape != (len(imgs), 2048):
        raise AssertionError(f"descriptors: shape {res['vecs'].shape}")
    E, M, H = res["mAP"]
    print(f"serving slice: {len(imgs)} images at 1024 px ms3 (half "
          f"centre-cropped), extract {res['extract_s']:.2f} s = "
          f"{len(imgs) / res['extract_s']:.2f} img/s (host clock, first "
          f"run, includes cuDNN plan selection); mAP E {E} M {M} H {H}; "
          f"top-100 ids == rank_full on {res['n_distinct']} distinct "
          f"scores; launches {launches}; bottleneck stream-K tiles "
          f"{tiles}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    if tiles["split_tiles"] == 0:
        raise AssertionError(f"the bottleneck's schedule split no tile on "
                             f"the main path: {tiles}")

    # -- 5: steady-state extraction and where the device time goes -------
    imgs64, _ = serving_fixture(8, 1024)

    def run():
        return extract_vectors(lambda x, v: gpu_model.extract(x, v), imgs64,
                               scales=SCALES, bucket=128, device_scales=True,
                               input_norm=(IMAGENET_MEAN, IMAGENET_STD),
                               device="cuda")

    run()  # warm: every bucket shape of this set has been seen
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()  # ends in the host readback
    wall_ms = (time.perf_counter() - t0) * 1e3
    print(f"steady extraction: {len(imgs64)} images at 1024 px ms3 in "
          f"{wall_ms:.1f} ms = {1e3 * len(imgs64) / wall_ms:.2f} img/s "
          f"(host clock, warm)")
    phase_profile(torch, run, f"extract_vectors, {len(imgs64)} images, "
                  "1024 px ms3")
    del imgs64
    torch.cuda.empty_cache()

    # -- 6: the serving stack at full width -------------------------------
    t0 = time.perf_counter()
    serving = phase_serving(torch, gh, rb, gpu_model, res["mAP"])
    print(f"serving phase: {time.perf_counter() - t0:.1f} s")
    del gpu_model
    torch.cuda.empty_cache()

    # -- 7: training on the card ------------------------------------------
    t0 = time.perf_counter()
    step32 = phase_train_step(torch, smi)
    step16 = phase_train_step(torch, smi, dtype="bfloat16")
    print(f"train 7.1 at bf16 beside fp32: {step16['ms']:.1f} vs "
          f"{step32['ms']:.1f} ms per step, {step16['img_s']:.1f} vs "
          f"{step32['img_s']:.1f} img/s, {step16['tflops']:.1f} vs "
          f"{step32['tflops']:.1f} TFLOP/s ({100 * step16['bound'] / step16['ms']:.1f}% "
          f"of the bf16 bound, {100 * step32['bound'] / step32['ms']:.1f}% of "
          f"the fp32 one), peak {step16['peak'] / 2 ** 30:.2f} vs "
          f"{step32['peak'] / 2 ** 30:.2f} GiB, batch {step16['batch']} vs "
          f"{step32['batch']} [{smi}]")
    cli_run = phase_train_cli(torch, gh, rb, smi)
    trained = phase_trained_kernels(torch, gh, rb, smi)
    trained16 = phase_trained_kernels(torch, gh, rb, smi, dtype="bfloat16")
    print(f"training phase: {time.perf_counter() - t0:.1f} s")
    # 7.2's eval step pools without the head kernel (as the JAX eval step
    # does); 7.3's extraction runs both kernels
    if cli_run["launches"]["bottleneck"] == 0:
        raise AssertionError(f"the bottleneck kernel was not launched in "
                             f"7.2's validation: {cli_run['launches']}")

    # -- 8: gem_r101 and the dilated gem_r50 at full width ----------------
    t0 = time.perf_counter()
    flagship = phase_flagship(torch, gh, rb, smi)
    print(f"flagship phase: {time.perf_counter() - t0:.1f} s")

    # -- 9: the ResNet zoo and DELG's local-feature rerank ----------------
    t0 = time.perf_counter()
    zoo, delg = phase_zoo(torch, gh, rb, smi)
    rerank = phase_local_rerank(torch, gh, rb, smi, delg)
    del delg
    torch.cuda.empty_cache()
    print(f"zoo phase: {time.perf_counter() - t0:.1f} s [{smi}]")

    # -- 10: SpCa, SoSNet, SpoC, SENet-G2+, AdaptiveHybrid + QAFF gallery -
    t0 = time.perf_counter()
    zoo_more, hybrid = phase_zoo_more(torch, gh, rb, smi)
    gallery = phase_hybrid_gallery(torch, gh, rb, smi, hybrid)
    del hybrid
    torch.cuda.empty_cache()
    print(f"zoo phase 10: {time.perf_counter() - t0:.1f} s [{smi}]")

    # -- 11: Token, HOW-VLAD, HOW-ASMK and CVNet's rerank -----------------
    t0 = time.perf_counter()
    token_how = phase_token_how(torch, gh, rb, smi)
    cvnet = phase_cvnet_rerank(torch, gh, rb, smi)
    torch.cuda.empty_cache()
    print(f"zoo phase 11: {time.perf_counter() - t0:.1f} s [{smi}]")

    # -- 12: ULTRON, ViT, CLIP (both towers) and the grid multiple ---------
    t0 = time.perf_counter()
    transformers, keep = phase_transformers(torch, gh, rb, smi)
    entry = phase_transformer_entry_points(torch, gh, rb, smi, keep)
    del keep
    torch.cuda.empty_cache()
    print(f"zoo phase 12: {time.perf_counter() - t0:.1f} s [{smi}]")

    # -- 13: SPECTRUM, IRIS, SPARSE, HAMLET and their train steps ----------
    t0 = time.perf_counter()
    prototypes = phase_prototypes(torch, gh, rb, smi)
    phase_prototype_train(torch, smi)
    phase_zoo_train(torch, smi)
    torch.cuda.empty_cache()
    print(f"zoo phase 13: {time.perf_counter() - t0:.1f} s [{smi}]")

    # -- 14: multi-GPU on the one card ------------------------------------
    t0 = time.perf_counter()
    phase_nccl_world_of_one(torch, smi, step32)
    dist_run = phase_dist_dryrun(torch, gh, rb, smi)
    phase_sharded_serving(torch, smi)
    print(f"multi-GPU phase 14: {time.perf_counter() - t0:.1f} s [{smi}]")

    # -- 15: the split JPEG decode through cli.evaluate --dct-decode ------
    t0 = time.perf_counter()
    dct_run = phase_dct_decode(torch, gh, rb, smi)
    print(f"split-decode phase 15: {time.perf_counter() - t0:.1f} s [{smi}]")

    src = "research_image_retrieval_tpu_torch/csrc/"
    replaces = {
        "gem_head": "research_image_retrieval_tpu/ops/gem_pallas.py:84",
        "bottleneck": "research_image_retrieval_tpu/ops/resblock_pallas.py:157",
    }
    kernels = [dict(name=name, route="cuda", source=f"{src}{name}.cu",
                    replaces=replaces[name], launches=launches[name],
                    library_ms=None, **rows[name],
                    **(tiles if name == "bottleneck" else {}),
                    serving_launches={step: n[name]
                                      for step, n in serving.items()},
                    train_launches={
                        "7.2 validation": cli_run["launches"][name],
                        "7.3 validation": trained["val_launches"][name],
                        "7.3 trained-weights extraction":
                            trained["launches"][name]},
                    flagship_launches={k: v["launches"][name]
                                       for k, v in flagship.items()},
                    zoo_launches={
                        **{k: v["launches"][name] for k, v in zoo.items()},
                        "9.2 cli.evaluate --local-rerank":
                            rerank["launches"][name],
                        **{k: v["launches"][name]
                           for k, v in zoo_more.items()},
                        "10.2 HybridGallery": gallery["launches"][name],
                        **{k: v["launches"][name]
                           for k, v in token_how.items()},
                        "11.2 cli.evaluate --cvnet-rerank (the rerank)":
                            cvnet["launches"][name],
                        **{k: v["launches"][name]
                           for k, v in transformers.items()},
                        **{k: v["launches"][name] for k, v in entry.items()},
                        **{k: v["launches"][name]
                           for k, v in prototypes.items()}},
                    dist_launches={
                        "14.2 rank-sharded extraction, per rank":
                            [r[name] for r in dist_run["ranks"]],
                        "14.2 single process": dist_run["single"][name]},
                    dct_launches={
                        "15 cli.evaluate --dct-decode 4":
                            dct_run["launches"][name]})
               for name in ("gem_head", "bottleneck")]
    # the bf16 forms: their main path is a bf16 model's (7.3-bf16), its
    # extraction counted as ``launches``, its validation beside it
    kernels += [dict(name=f"{name}[bf16]", route="cuda",
                     source=f"{src}{name}.cu", replaces=replaces[name],
                     launches=trained16["launches"][name], library_ms=None,
                     **rows_bf16[name],
                     train_launches={
                         "7.3-bf16 validation":
                             trained16["val_launches"][name]})
                for name in ("gem_head", "bottleneck")]
    print(json.dumps({"kernels": kernels}))
    print(f"gpu: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
