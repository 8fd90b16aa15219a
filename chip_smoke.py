#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; there is no fallback):
  1. the card's name and power limit, the torch and CUDA versions, and a
     build of every CUDA kernel from ``research_image_retrieval_tpu_torch/csrc``;
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes: one call between CUDA events (kernel and plain
     version alike, the ``ms`` and ``plain_ms`` of the summary), the
     kernel's device time per call (CUDA events around calls queued
     behind a device-side wait, ``device_ms``), each launch's device time
     (torch.profiler, printed only), and its bounds;
  3. the main path (bucketed ms3 extraction with on-device scales) on
     CUDA against the port's own CPU path, same seeded GeM-R50 weights;
  4. the serving slice at full width (ResNet-50, 2048-d, 1024 px ms3):
     synthetic Revisited fixture -> extract -> rank -> streaming top-k ->
     E/M/H mAP, with each kernel's launch count over this run;
  5. a warm timed extraction of 64 fixture images on the same path
     (steady img/s), then a torch.profiler pass over the same run: device
     time by kernel group and the device's busy share.
The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Needs a CUDA device and the repo.
"""

from __future__ import annotations

import collections
import copy
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SCALES = (1.0, 2 ** -0.5, 0.5)
FP32_PEAK = 67e12   # H100 SXM fp32 (non-tensor) FLOP/s, NVIDIA data sheet
TF32X3_PEAK = 495e12 / 3  # fp32-accurate products as three TF32 products
HBM_RATE = 3.35e12  # H100 SXM HBM3 bytes/s
R50_IDENTITY = ((256, 64, 256, 2), (512, 128, 128, 3),
                (1024, 256, 64, 5), (2048, 512, 32, 2))  # C, Cw, side, blocks
BUCKETS = (1024, 768, 512)  # the 128 px buckets of 1024 px ms3 images


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
        yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                             indexing="ij")
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
                  device: str) -> dict:
    """The serving path on ``device``: raw uint8 images normalised and
    resized on the device (``extract_vectors``), the full ranking
    (``rank_full``), each query's top-``k`` (``streaming_topk``, exact),
    and the Revisited E/M/H mAP (the first image of each class of 8 is a
    query).  Raises unless the descriptors are finite unit vectors and
    the top-k ids equal the ranking's head wherever scores are distinct.
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
                           device=device)
    extract_s = time.perf_counter() - t0  # ends in the host readback
    if vecs.shape[0] != len(imgs) or not np.isfinite(vecs).all():
        raise AssertionError(f"descriptors: shape {vecs.shape}, finite "
                             f"{np.isfinite(vecs).all()}")
    norms = np.linalg.norm(vecs, axis=1)
    if np.abs(norms - 1).max() > 1e-4:
        raise AssertionError(f"descriptors not unit norm: {norms}")
    q_idx = np.arange(0, len(imgs), 8)
    ranks = rank_full(vecs[q_idx], vecs, device=device)
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


def phase_bottleneck(torch, rb, fp32_precision):
    """Kernel 2 at the shapes the main path launches: B=8 at the four R50
    identity stages of the three buckets (1024 / 768 / 512 px), and B=2 at
    1024 px (the rows of earlier runs).  Each geometry is checked against
    the plain version, without and with extents, and so are two that stress
    the tiling (M = 494, not a multiple of a tile).  Timed per geometry:
    one call between CUDA events, kernel and plain version alike (the
    wrapper's host time shows there when it exceeds the device's), the
    kernel's device time (``device_ms``) and each of its three launches
    (profiler), and, as a
    yardstick the port never calls, torch.matmul (fp32, TF32 off) on
    conv1's and conv3's GEMM shapes.  The bound counts conv1 on the valid
    rows only (the extents zero the rest of its output); conv2 and conv3
    run on every row."""
    g = torch.Generator(device="cuda").manual_seed(2)
    max_err = 0.0
    for C, Cw in ((256, 64), (2048, 512)):
        x, ws, ext = bottleneck_inputs(torch, rb, g, 2, 19, 13, C, Cw)
        max_err = max(max_err, check_bottleneck(
            torch, rb, f"B=2 C={C} Cw={Cw} 19x13", x, ws, ext))
    geoms = [(2, C, Cw, side, nblk, 1024)
             for C, Cw, side, nblk in R50_IDENTITY]
    geoms += [(8, C, Cw, side * px // 1024, nblk, px)
              for px in BUCKETS for C, Cw, side, nblk in R50_IDENTITY]
    tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0,
               fma_bound_ms=0.0)
    by_all = set()
    for B, C, Cw, side, nblk, px in geoms:
        x, ws, ext = bottleneck_inputs(torch, rb, g, B, side, side, C, Cw)
        label = f"B={B} C={C} Cw={Cw} {side}x{side} ({px} px)"
        max_err = max(max_err, check_bottleneck(torch, rb, label, x, ws,
                                                ext))
        run = lambda: rb.fused_bottleneck(x, *ws, extents=ext)
        ms = cuda_ms(torch, run)
        plain = cuda_ms(torch, lambda: rb.fused_bottleneck_reference(
            x, *ws, extents=ext))
        dev = device_ms(torch, run)
        launches = launch_breakdown(torch, run, BOTTLENECK_LAUNCHES,
                                    ("conv1", "conv2", "conv3"))
        M = B * side * side
        Mv = int((ext[:, 0].clamp(0, side) * ext[:, 1].clamp(0, side)).sum())
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
              f"CUDA events, {dev:.4f} ms on the device ({launches}), "
              f"plain {plain:.4f} ms, bound "
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


def main() -> int:
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
    res = serving_slice(gpu_model, imgs, labels, SCALES, bucket=128, k=100,
                        device="cuda")
    launches = {"gem_head": gh.gem_whiten_l2.launches,
                "bottleneck": rb.fused_bottleneck.launches}
    if res["vecs"].shape != (len(imgs), 2048):
        raise AssertionError(f"descriptors: shape {res['vecs'].shape}")
    E, M, H = res["mAP"]
    print(f"serving slice: {len(imgs)} images at 1024 px ms3 (half "
          f"centre-cropped), extract {res['extract_s']:.2f} s = "
          f"{len(imgs) / res['extract_s']:.2f} img/s (host clock, first "
          f"run, includes cuDNN plan selection); mAP E {E} M {M} H {H}; "
          f"top-100 ids == rank_full on {res['n_distinct']} distinct "
          f"scores; launches {launches}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")

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

    src = "research_image_retrieval_tpu_torch/csrc/"
    replaces = {
        "gem_head": "research_image_retrieval_tpu/ops/gem_pallas.py:84",
        "bottleneck": "research_image_retrieval_tpu/ops/resblock_pallas.py:157",
    }
    kernels = [dict(name=name, route="cuda", source=f"{src}{name}.cu",
                    replaces=replaces[name], launches=launches[name],
                    library_ms=None, **rows[name])
               for name in ("gem_head", "bottleneck")]
    print(json.dumps({"kernels": kernels}))
    print(f"gpu: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
