"""Image queries as ``cli.serve --model ... --multiscale --engine int8``
serves them: an open loop of ``POST /search/image`` requests, one JPEG
each, against ``serve.http.make_http_server`` fronting ``ImageExtractor``
and an int8 ``SearchService`` over a seeded gallery.

The load generator (``drivers/loadgen.py``) runs in a child process
started with ``subprocess``; it sends each request at its due time and
times it from then (so a stall counts against every request it delays)
to its reply.  The arrivals are a Poisson process at the mix's
``rate_rps``: ``round(rate * seconds)`` gaps at the quantiles of the
exponential distribution, in an order drawn from the seed, so every seed
offers the same number of requests over the same window.  Each pool JPEG
is sent equally often, in a seeded order.

Mix parameters: ``phones`` photos of ``phone`` (h, w) pixels, half of
them portrait; ``crops`` boxed crops with sides spread over ``crop_min``
to ``crop_max`` (the same sides for every seed); ``quality``; ``noise``;
``gallery_rows``; ``k``, ``max_batch``, ``window_ms``, ``imsize`` and
``multiscale`` as ``cli.serve``'s flags; ``rate_rps``; ``workers`` and
``timeout_s`` of the generator; the traced stretch.

Correctness: every reply of the window.  A benchmark-side wrapper
around ``SearchService.search`` keeps the descriptor each search was
asked with, found again by the ids it answered.  ``desc_max_abs`` holds
that descriptor against the reference's for the request's JPEG
(decoded with OpenCV, thumbnailed with OpenCV's Lanczos-4, extracted at
its own size); ``topk_score_gap`` holds each reply's scores against the
reference's int8 scoring of the same descriptor over the same gallery:
at each rank the gap to the reference's score at that rank and to the
reference's score of the id returned there.  A reply that never came is
a failure.
"""

from __future__ import annotations

import base64
import json
import math
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import inputs
from perfbench.drivers import common
from perfbench.harness import Outcome
from perfbench.reference import resize as ref_resize
from perfbench.reference import resnet_gem as ref
from perfbench.reference import search as ref_search
from perfbench.trace import Stretch, percentile

__all__ = ["compare", "pool_jpegs", "pool_sizes", "reference_descriptors",
           "run", "schedule", "sweep"]

LOADGEN = Path(__file__).resolve().with_name("loadgen.py")


def pool_sizes(mix: dict) -> list[tuple[int, int]]:
    """The JPEGs' (h, w), the same for every seed."""
    ph, pw = mix["phone"]
    sizes = [(ph, pw) if i % 2 == 0 else (pw, ph)
             for i in range(int(mix["phones"]))]
    lo, hi = int(mix["crop_min"]), int(mix["crop_max"])
    for i in range(int(mix["crops"])):
        sizes.append((lo + round((hi - lo) * ((i * 0.6180339887) % 1)),
                      lo + round((hi - lo) * ((i * 0.3819660113 + 0.5) % 1))))
    return sizes


def schedule(n: int, rate: float, seconds: float, pool: int, seed: int):
    """``[(due_s, pool index)]`` of ``n`` arrivals over ``seconds``:
    exponential gaps at their ``n`` quantiles, in a seeded order, scaled to
    the window; pool images used equally often in a seeded order."""
    rng = np.random.default_rng(seed)
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n) / rate
    gaps = rng.permutation(gaps)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    due *= seconds / gaps.sum()
    order = np.concatenate([rng.permutation(pool)
                            for _ in range(-(-n // pool))])[:n]
    return [(float(d), int(j)) for d, j in zip(due, order)]


class _TimedExtractor:
    """The extractor handed to the HTTP server: the program's, timed per
    call (lock wait included)."""

    def __init__(self, inner):
        self.inner = inner
        self.calls: list = []

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __call__(self, images):
        t = time.perf_counter()
        out = self.inner(images)
        self.calls.append((t, time.perf_counter() - t))
        return out


class _TimedService:
    """The service handed to the HTTP server: the program's, with each
    ``search`` timed and its query kept under the ids it answered."""

    def __init__(self, inner):
        self.inner = inner
        self.calls: list = []
        self.queries: dict = {}

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def search(self, vecs, k=None):
        t = time.perf_counter()
        scores, ids = self.inner.search(vecs, k=k)
        self.calls.append((t, time.perf_counter() - t))
        q = np.array(vecs, np.float32, ndmin=2)
        for r in range(ids.shape[0]):
            self.queries[np.asarray(ids[r], np.int64).tobytes()] = q[r]
        return scores, ids


def pool_jpegs(cell) -> list[bytes]:
    """The pool's JPEG files, encoded from seeded renders."""
    mix = cell.traffic
    imgs = inputs.renders(pool_sizes(mix), inputs.sub_seed(cell.seed,
                                                           "images"),
                          cell.device, noise=mix["noise"])
    return [inputs.encode_jpeg(im, mix["quality"]) for im in imgs]


def _bucket_key(h: int, w: int, imsize: int, bucket: int = 128):
    s = imsize / max(h, w)
    th, tw = max(int(round(h * s)), 1), max(int(round(w * s)), 1)
    return -(-th // bucket), -(-tw // bucket)


def _post(port: int, body: str):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/search/image", body=body.encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"warm-up request failed: {resp.status} "
                               f"{data[:300]!r}")
    finally:
        conn.close()


def _setup(cell) -> dict:
    from research_image_retrieval_tpu_torch.serve import (
        ImageExtractor,
        SearchService,
        make_http_server,
    )

    cfg, mix, dev = cell.config, cell.traffic, cell.device
    marks = [("start", time.perf_counter())]
    sizes = pool_sizes(mix)
    jpegs = pool_jpegs(cell)
    marks.append(("jpegs", time.perf_counter()))
    g32 = torch.empty((mix["gallery_rows"], cfg["outputdim"]),
                      dtype=torch.float32, device=dev)
    for b, blk in inputs.gallery_blocks(
            mix["gallery_rows"], cfg["outputdim"],
            inputs.sub_seed(cell.seed, "gallery"), dev):
        g32[b:b + blk.shape[0]] = blk
    svc = SearchService(g32, engine="int8", k=mix["k"],
                        max_batch=mix["max_batch"], window_ms=mix["window_ms"],
                        device=dev)
    del g32
    marks.append(("gallery", time.perf_counter()))
    extractor = ImageExtractor(cfg["model"], imsize=mix["imsize"],
                               multiscale=mix["multiscale"], device=dev)
    extractor._model.load_state_dict(inputs.resnet_gem_weights(
        cfg, inputs.sub_seed(cell.seed, "weights"), dev), strict=True)
    common.free(dev)
    marks.append(("extractor", time.perf_counter()))
    svc.warmup()
    timed_svc, timed_ext = _TimedService(svc), _TimedExtractor(extractor)
    server = make_http_server(timed_svc, host="127.0.0.1", port=0,
                              extractor=timed_ext)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    bodies = [json.dumps({"images_b64": [base64.b64encode(j).decode()],
                          "k": mix["k"]}) for j in jpegs]
    warm = {}
    for j, (h, w) in enumerate(sizes):
        warm.setdefault(_bucket_key(h, w, mix["imsize"]), j)
    for j in warm.values():  # every bucket shape of the pool, once
        _post(port, bodies[j])
    timed_svc.calls.clear()
    timed_ext.calls.clear()
    marks.append(("warm-up", time.perf_counter()))
    setup = ", ".join(f"{n} {b - a:.2f} s"
                      for (_, a), (n, b) in zip(marks, marks[1:]))
    return dict(setup=setup, svc=svc, extractor=extractor, timed_svc=timed_svc,
                timed_ext=timed_ext, server=server, thread=thread, port=port,
                bodies=bodies, jpegs=jpegs, sizes=sizes)


def _close(st: dict) -> None:
    st["server"].shutdown()
    st["server"].server_close()
    st["thread"].join(timeout=30)
    st["svc"].close()


def _window(st: dict, mix: dict, rate: float, seconds: float, seed: int,
            stretch: Stretch | None = None):
    """One open-loop window; returns (records, t_go, stats before, after)."""
    sched = schedule(max(1, round(rate * seconds)), rate, seconds,
                     len(st["bodies"]), seed)
    proc = subprocess.Popen([sys.executable, str(LOADGEN)],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True)
    try:
        proc.stdin.write(json.dumps({
            "port": st["port"], "path": "/search/image",
            "bodies": st["bodies"], "schedule": sched,
            "workers": mix["workers"], "timeout_s": mix["timeout_s"]}) + "\n")
        proc.stdin.flush()
        if proc.stdout.readline().strip() != "ready":
            raise RuntimeError("the load generator did not start")
        timers = []
        if stretch is not None:
            timers = [threading.Timer(mix["stretch_at"] * seconds,
                                      stretch.run_for, (mix["stretch_s"],))]
        before = st["svc"].stats()
        t_go = time.perf_counter()
        proc.stdin.write("go\n")
        proc.stdin.flush()
        for t in timers:
            t.start()
        line = proc.stdout.readline()
        for t in timers:
            t.join()
        after = st["svc"].stats()
        proc.stdin.close()
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    records = json.loads(line)
    return records, t_go, before, after


def _latencies_ms(records) -> list[float]:
    return [(r[4] - r[2]) * 1e3 if r[5] == 200 else math.inf
            for r in records]


def reference_descriptors(cell, jpegs, used, precision: str = "fp32"):
    """``{pool index: descriptor}`` of the reference: OpenCV's decode,
    its Lanczos-4 thumbnail, extraction at the thumbnail's own size."""
    import cv2

    cfg, mix, dev = cell.config, cell.traffic, cell.device
    imgs = []
    for j in used:
        bgr = cv2.imdecode(np.frombuffer(jpegs[j], np.uint8),
                           cv2.IMREAD_COLOR)
        imgs.append(ref_resize.thumbnail(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB),
                                         mix["imsize"]))
    weights = inputs.resnet_gem_weights(
        cfg, inputs.sub_seed(cell.seed, "weights"), dev)
    scales = (1.0, 2 ** -0.5, 0.5) if mix["multiscale"] else (1.0,)
    want = ref.descriptors(imgs, weights, cfg, scales, inputs.IMAGENET_MEAN,
                           inputs.IMAGENET_STD, dev, precision=precision)
    return dict(zip(used, want))


def compare(cell, answers, want: dict) -> dict:
    """``desc_max_abs`` and ``topk_score_gap`` of ``answers`` ``[(pool
    index, descriptor searched with or None, ids, scores)]`` against the
    reference's descriptors ``want`` and the reference's int8 scoring of
    each answer's own descriptor (see the module docstring)."""
    cfg, mix, dev = cell.config, cell.traffic, cell.device
    desc_gap = score_gap = 0.0
    found = [a for a in answers if a[1] is not None]
    if len(found) < len(answers):
        score_gap = math.inf
    for j, q, _, _ in found:
        desc_gap = max(desc_gap, float(np.abs(q - want[j]).max()))
    if found:
        uniq, inv = np.unique(np.stack([a[1] for a in found]), axis=0,
                              return_inverse=True)
        blocks = inputs.gallery_blocks(mix["gallery_rows"], cfg["outputdim"],
                                       inputs.sub_seed(cell.seed, "gallery"),
                                       dev)
        full = ref_search.scores(uniq, blocks, "int8")
        top = torch.topk(full, mix["k"], dim=1).values.cpu().numpy()
        for n, (_, _, ids, sc) in enumerate(found):
            u = int(np.ravel(inv)[n])
            at_ids = full[u][torch.as_tensor(ids, device=full.device)]
            gap = max(np.abs(sc - top[u, :len(sc)]).max(),
                      np.abs(sc - at_ids.cpu().numpy()).max())
            if len(set(ids.tolist())) < len(ids) or len(sc) != mix["k"]:
                gap = math.inf
            score_gap = max(score_gap, float(gap))
    return {"desc_max_abs": desc_gap, "topk_score_gap": score_gap}


def _answers(st: dict, records) -> list:
    """The window's replies as ``compare`` takes them, each with the
    descriptor its search was asked with (None where no search answered
    those ids)."""
    out = []
    for r in records:
        if r[5] != 200:
            continue
        m = r[6]["results"][0]["matches"]
        ids = np.array([x["index"] for x in m], np.int64)
        out.append((r[1], st["timed_svc"].queries.get(ids.tobytes()), ids,
                    np.array([x["score"] for x in m], np.float64)))
    return out


def run(cell) -> Outcome:
    from research_image_retrieval_tpu_torch.ops import resblock

    mix, dev = cell.traffic, cell.device
    st = _setup(cell)
    stretch = Stretch(dev) if cell.trace else None
    if stretch is not None:
        stretch.prepare()
    launches0 = resblock.fused_bottleneck.launches
    try:
        records, t_go, before, after = _window(
            st, mix, mix["rate_rps"], cell.seconds,
            inputs.sub_seed(cell.seed, "arrivals"), stretch)
    finally:
        _close(st)
    peak = common.memory_peak(dev)
    lat = _latencies_ms(records)
    failed = sum(1 for r in records if r[5] != 200)
    late = [(r[3] - r[2]) * 1e3 for r in records]
    ok = [x for x in lat if math.isfinite(x)]
    end = max((r[4] for r in records), default=0.0)
    ext_ms = [d * 1e3 for t, d in st["timed_ext"].calls]
    srch_ms = [d * 1e3 for t, d in st["timed_svc"].calls]
    dq = after["queries"] - before["queries"]
    dc = after["engine_calls"] - before["engine_calls"]
    notes = [
        f"requests {len(records)} at {mix['rate_rps']} req/s offered, "
        f"failed {failed}, last reply at {end:.3f} s of a "
        f"{cell.seconds} s window; latency ms p50 "
        f"{percentile(ok, 50) if ok else math.nan:.2f} p95 "
        f"{percentile(lat, 95):.2f} p99 {percentile(lat, 99):.2f}; "
        f"generator late ms p50 {percentile(late, 50):.3f} p95 "
        f"{percentile(late, 95):.3f}",
        f"extractor ms p50 {percentile(ext_ms, 50) if ext_ms else 0:.2f} "
        f"p95 {percentile(ext_ms, 95) if ext_ms else 0:.2f} "
        f"({len(ext_ms)}); search ms p50 "
        f"{percentile(srch_ms, 50) if srch_ms else 0:.3f} p95 "
        f"{percentile(srch_ms, 95) if srch_ms else 0:.3f}; queries {dq}, "
        f"engine calls {dc}, bottleneck launches "
        f"{resblock.fused_bottleneck.launches - launches0}; memory peak "
        f"{peak}; set-up: {st['setup']}"]
    obs = {"extractor_ms": ext_ms, "search_ms": srch_ms,
           "queries": dq, "engine_calls": dc}
    if stretch is not None and stretch.prof is not None:
        obs["trace"] = stretch.summary()
    svc = st.pop("svc")
    ext = st.pop("extractor")
    st.pop("server")
    del svc, ext
    common.free(dev)
    used = sorted({r[1] for r in records if r[5] == 200})
    gaps = compare(cell, _answers(st, records),
                   reference_descriptors(cell, st["jpegs"], used))
    return Outcome(
        attempted=len(records), failed=failed,
        metrics={"query_p95_ms": percentile(lat, 95)},
        checks={k: (v, cell.limits[k]) for k, v in gaps.items()},
        setup_end=t_go, memory_peak_bytes=peak, obs=obs, notes=notes)


def sweep(cell, rates, seconds: float) -> list[dict]:
    """Offer each rate in turn to one set-up (the knee is found once,
    when the cell is defined): per rate the completed rate, the latency
    quantiles, how late the generator ran, and the p50 of the first and
    the last third of the requests (a backlog that grows shows as the
    last third waiting longer)."""
    st = _setup(cell)
    rows = []
    try:
        for k, rate in enumerate(rates):
            records, _, before, after = _window(
                st, cell.traffic, rate, seconds,
                inputs.sub_seed(cell.seed, f"sweep{k}"))
            lat = _latencies_ms(records)
            third = max(1, len(lat) // 3)
            end = max(r[4] for r in records)
            rows.append({
                "rate": rate, "n": len(lat),
                "failed": sum(1 for r in records if r[5] != 200),
                "completed_per_s": len(lat) / end,
                "p50": percentile(lat, 50), "p95": percentile(lat, 95),
                "first_third_p50": percentile(lat[:third], 50),
                "last_third_p50": percentile(lat[-third:], 50),
                "late_p95": percentile([(r[3] - r[2]) * 1e3
                                        for r in records], 95),
                "per_call": (after["queries"] - before["queries"])
                / max(1, after["engine_calls"] - before["engine_calls"])})
            print(json.dumps(rows[-1]), flush=True)
    finally:
        _close(st)
    return rows
