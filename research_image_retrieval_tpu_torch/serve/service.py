"""Resident top-k search service with query micro-batching
(port of ``research_image_retrieval_tpu/serve/service.py``).

The service

* keeps the gallery on the device once (bf16 for the float engines by
  default, or int8 + per-row scales for the quantized engine); a gallery
  passed as a CUDA tensor is placed without a host copy,
* runs the engines on power-of-two query-batch buckets (1, 2, 4, ...
  ``max_batch``; padded queries are sliced off), so cuBLAS sees a bounded
  set of shapes and ``torch._int_mm`` always gets its >16 rows, and
* coalesces concurrent requests into one engine call inside a batching
  window (``window_ms``).

With ``mesh`` (a list of devices, ``parallel.default_search_mesh()``:
every local GPU; a device may repeat) the gallery is row-sharded over
them and each engine call streams every shard on its own device and
merges the ``[Q, k]`` candidates on the first
(``parallel/dist_search.py``); the exact and int8 engines only, as in
JAX.

All engine calls run on one worker thread, on a CUDA stream of its own;
callers block on an event, so the service is safe to drive from any
number of request threads.

``stats()`` sums each request's wait in the queue (enqueue to the worker
taking it) and each coalesced engine call's time, always.  While a
profiler records, each request's wait is stored as the span
``serve.queue_wait`` (``utils.profiling.record``: it starts on the
caller's thread and ends on the worker's) and each engine call runs
under ``serve.engine``, whose id is its first request's; the extractor's
calls hold ``serve.thumbnail``, ``serve.lock_wait`` and
``serve.extract``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import queue
import threading
import time

import numpy as np
import torch

from research_image_retrieval_tpu_torch.data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    imthumbnail,
    normalize,
)
from research_image_retrieval_tpu_torch.evaluation.driver import (
    _load_model,
    _make_extract_fn,
)
from research_image_retrieval_tpu_torch.index import extract_vectors
from research_image_retrieval_tpu_torch.ops.topk_stream import (
    approx_streaming_topk,
    int8_streaming_topk,
    quantize_gallery_int8,
    scan_streaming_topk,
)
from research_image_retrieval_tpu_torch.parallel.dist_search import (
    make_sharded_stream_fn,
    place_sharded_gallery,
)
from research_image_retrieval_tpu_torch.utils.config import EvalConfig
from research_image_retrieval_tpu_torch.utils.device import resolve_device
from research_image_retrieval_tpu_torch.utils.profiling import record, span

__all__ = ["ImageExtractor", "SearchService"]


@dataclasses.dataclass
class _Request:
    vecs: np.ndarray  # [n, D] fp32
    k: int
    done: threading.Event
    id: int = 0
    t_enq: int = 0   # time.perf_counter_ns at the enqueue
    t_take: int = 0  # ... when the worker took it
    scores: np.ndarray | None = None
    indices: np.ndarray | None = None
    error: BaseException | None = None


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _on(x, dev: torch.device, dtype=None) -> torch.Tensor:
    """``x`` (numpy or tensor) on ``dev``; a tensor already there is not
    copied through the host."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(dev, dtype)


class SearchService:
    """Device-resident gallery + micro-batched streaming top-k.

    Args:
      gallery: [N, D] float descriptors (numpy or a tensor, e.g. already
        on the card), or None when serving a prequantized index.
      names: optional [N] identifier array returned alongside indices.
      vecs_int8 / scales: prequantized gallery (``cli.extract
        --quantize-int8`` layout); implies ``engine="int8"`` by default.
      engine: "exact" (fp32 grouped stream), "approx" (bf16 scores), or
        "int8" (quantized stream).
      k: server-wide top-k (per-request k may be <= this).
      max_batch: largest coalesced query batch (power of two enforced).
      window_ms: how long the worker waits to coalesce more queries
        after the first one arrives.
      store_dtype: device storage dtype for the float engines
        ("bfloat16" halves the stream bytes; "float32").
      exact_fp32_scores: accepted for the JAX signature; the port's exact
        engine always scores in fp32.
      selection: int8 engine selector ("exact" group-max or "approx",
        both exact in the port).
      device: "cuda" (default; raises without a card) or "cpu".
      mesh: a list of devices to row-shard the gallery over (the first
        one merges and is the service's ``device``); None: one device.
    """

    def __init__(self, gallery=None, names=None, *, vecs_int8=None,
                 scales=None, engine: str | None = None, k: int = 100,
                 max_batch: int = 32, window_ms: float = 2.0,
                 store_dtype: str = "bfloat16",
                 exact_fp32_scores: bool = False, selection: str = "exact",
                 device="cuda", mesh=None):
        if engine is None:
            engine = "int8" if vecs_int8 is not None else "exact"
        if engine not in ("exact", "approx", "int8"):
            raise ValueError(f"unknown engine {engine!r}")
        if mesh is not None and engine == "approx":
            raise ValueError(
                "the sharded service supports engine='exact' or 'int8' "
                "(use engine='int8', selection='approx' for the fast "
                "serving point)")
        if selection not in ("exact", "approx"):
            raise ValueError(f"selection must be 'exact' or 'approx', "
                             f"got {selection!r}")
        del exact_fp32_scores  # always on
        self._mesh = None if mesh is None else [resolve_device(d)
                                                for d in mesh]
        self.device = dev = (resolve_device(device) if mesh is None
                             else self._mesh[0])
        self.engine = engine
        self.selection = selection
        with torch.no_grad():
            if engine == "int8":
                if vecs_int8 is None:
                    if gallery is None:
                        raise ValueError("int8 engine needs vecs_int8 or "
                                         "gallery")
                    vecs_int8, scales = quantize_gallery_int8(
                        _on(gallery, dev))
                self._qg = _on(vecs_int8, dev, torch.int8)
                self._gscales = _on(scales, dev, torch.float32)
                self._gallery = None
                n, d = self._qg.shape
            else:
                if gallery is None:
                    if vecs_int8 is None:
                        raise ValueError("float engines need a gallery")
                    gallery = (_on(vecs_int8, dev, torch.float32)
                               * _on(scales, dev, torch.float32)[:, None])
                self._gallery = _on(gallery, dev,
                                    getattr(torch, store_dtype))
                self._qg = self._gscales = None
                n, d = self._gallery.shape
            if self._mesh is not None:  # row blocks, one per device
                int8 = engine == "int8"
                self._shards = place_sharded_gallery(
                    self._qg if int8 else self._gallery, self._mesh,
                    self._gscales if int8 else None)[:2]
                self._qg = self._gscales = self._gallery = None
        self.n_gallery, self.dim = int(n), int(d)
        self.names = None if names is None else np.asarray(names)
        self.k = min(int(k), self.n_gallery)
        self.max_batch = _next_pow2(int(max_batch))
        self.window_s = float(window_ms) / 1e3
        self._stream = None
        if dev.type == "cuda":
            self._stream = torch.cuda.Stream(dev)
            for d in self._mesh or [dev]:
                torch.cuda.synchronize(d)  # placed before use

        self._runs: dict[int, object] = {}  # bucket -> engine call
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._latencies = collections.deque(maxlen=4096)
        self._counts = collections.Counter()
        self._ids = itertools.count()
        self._t0 = time.monotonic()
        self._worker = threading.Thread(target=self._worker_loop,
                                        name="rir-serve-worker", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- engine

    def _make_run(self, bucket: int):
        """The engine call for a [bucket, D] query batch on the device."""
        k = self.k  # chunk=None: each engine's device default
        if self._mesh is not None:
            g, s = self._shards
            run = make_sharded_stream_fn(
                self._mesh, self.n_gallery, g[0].shape[0], k=k, chunk=None,
                engine=self.engine, selection=self.selection)
            return lambda q: run(q, g, s)
        if self.engine == "int8":
            qg, gs, sel = self._qg, self._gscales, self.selection
            return lambda q: int8_streaming_topk(q, qg, gs, k=k, chunk=None,
                                                 selection=sel)
        g = self._gallery
        if self.engine == "approx":
            return lambda q: approx_streaming_topk(q, g, k=k, chunk=None)
        return lambda q: scan_streaming_topk(q, g, k=k, chunk=None)

    def _run_for(self, bucket: int):
        fn = self._runs.get(bucket)
        if fn is None:
            fn = self._make_run(bucket)
            with self._lock:  # stats() iterates the dict from other threads
                self._runs[bucket] = fn
        return fn

    def _on_worker_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def warmup(self):
        """Run every query bucket once up front (cuBLAS plans and the
        allocator's blocks off the request path)."""
        q = torch.zeros((self.max_batch, self.dim), dtype=torch.float32,
                        device=self.device)
        b = 1
        with self._on_worker_stream(), torch.no_grad():
            while b <= self.max_batch:
                s, _ = self._run_for(b)(q[:b])
                s.cpu()  # wait for the device
                b *= 2
        return self

    # ------------------------------------------------------------- worker

    def _worker_loop(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            if first is None:
                break
            first.t_take = time.perf_counter_ns()
            batch = [first]
            rows = first.vecs.shape[0]
            deadline = time.monotonic() + self.window_s
            while rows < self.max_batch:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    break
                try:
                    req = self._queue.get(timeout=wait)
                except queue.Empty:
                    break
                if req is None:
                    self._stop.set()
                    break
                req.t_take = time.perf_counter_ns()
                batch.append(req)
                rows += req.vecs.shape[0]
            self._execute(batch)
        # drain: fail any requests left behind at shutdown
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is not None:
                req.error = RuntimeError("service closed")
                req.done.set()

    def _execute(self, batch: list[_Request]):
        for req in batch:
            record("serve.queue_wait", req.t_enq, req.t_take, id=req.id)
        t0 = time.perf_counter_ns()
        try:
            allq = (batch[0].vecs if len(batch) == 1
                    else np.concatenate([r.vecs for r in batch], axis=0))
            total = allq.shape[0]
            scores = np.empty((total, self.k), np.float32)
            indices = np.empty((total, self.k), np.int32)
            calls = 0
            with self._on_worker_stream(), torch.no_grad(), \
                    span("serve.engine", id=batch[0].id) as sp:
                for start in range(0, total, self.max_batch):
                    sub = allq[start:start + self.max_batch]
                    n = sub.shape[0]
                    bucket = _next_pow2(n)
                    q = torch.zeros((bucket, self.dim), dtype=torch.float32)
                    q[:n] = torch.from_numpy(sub)
                    s, i = self._run_for(bucket)(q.to(self.device))
                    scores[start:start + n] = s[:n].cpu().numpy()
                    indices[start:start + n] = i[:n].cpu().numpy()
                    calls += 1
                if sp:
                    sp.count(queries=total, calls=calls)
            t1 = time.perf_counter_ns()
            row = 0
            for req in batch:
                n = req.vecs.shape[0]
                req.scores = scores[row:row + n, :req.k]
                req.indices = indices[row:row + n, :req.k]
                row += n
                req.done.set()
            with self._lock:
                self._counts["engine_calls"] += calls
                self._counts["coalesced_batches"] += 1
                self._counts["queries"] += total
                self._counts["engine_ns"] += t1 - t0
                self._counts["queue_wait_ns"] += sum(r.t_take - r.t_enq
                                                     for r in batch)
        except BaseException as e:  # deliver failures to the callers
            for req in batch:
                if not req.done.is_set():
                    req.error = e
                    req.done.set()

    # ---------------------------------------------------------------- api

    def search(self, vecs, k: int | None = None):
        """Blocking top-k search.  ``vecs`` is [n, D] (or [D]); returns
        ``(scores [n, k], indices [n, k])`` fp32/int32 numpy arrays."""
        if self._stop.is_set():
            raise RuntimeError("service closed")
        v = np.asarray(vecs, np.float32)
        if v.ndim == 1:
            v = v[None]
        if v.ndim != 2 or v.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}] queries, "
                             f"got {v.shape}")
        kk = self.k if k is None else int(k)
        if not 0 < kk <= self.k:
            raise ValueError(f"k must be in [1, {self.k}], got {kk}")
        req = _Request(np.ascontiguousarray(v), kk, threading.Event(),
                       id=next(self._ids))
        req.t_enq = time.perf_counter_ns()
        self._queue.put(req)
        # Bounded waits, re-checking liveness: close() may set _stop and
        # drain the queue between the _stop check above and the put; the
        # worker would then never answer this request.
        while not req.done.wait(timeout=0.1):
            if self._stop.is_set() and not self._worker.is_alive():
                raise RuntimeError("service closed")
        if req.error is not None:
            raise req.error
        with self._lock:
            self._counts["requests"] += 1
            self._latencies.append((time.perf_counter_ns() - req.t_enq)
                                   / 1e6)
        return req.scores, req.indices

    def match_names(self, indices) -> np.ndarray:
        if self.names is None:
            return np.asarray(indices)
        return self.names[np.asarray(indices)]

    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            counts = dict(self._counts)
            buckets = sorted(self._runs)
        out = {
            "engine": self.engine,
            "shards": None if self._mesh is None else len(self._mesh),
            "gallery_size": self.n_gallery,
            "dim": self.dim,
            "k": self.k,
            "max_batch": self.max_batch,
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "compiled_buckets": buckets,
            **{key: counts.get(key, 0)
               for key in ("requests", "queries", "engine_calls",
                           "coalesced_batches")},
            # where request time went: waits in the queue, engine calls
            "queue_wait_ms_total": round(counts.get("queue_wait_ns", 0)
                                         / 1e6, 3),
            "engine_ms_total": round(counts.get("engine_ns", 0) / 1e6, 3),
        }
        if lat:
            out["latency_ms"] = {
                "mean": round(sum(lat) / len(lat), 3),
                "p50": round(lat[len(lat) // 2], 3),
                "p99": round(lat[min(len(lat) - 1, int(len(lat) * 0.99))], 3),
            }
        return out

    def close(self):
        self._stop.set()
        self._queue.put(None)
        self._worker.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ loading

    @classmethod
    def from_npz(cls, path: str, **kw) -> "SearchService":
        """Build a service from a ``cli.extract`` index (.npz with either
        ``vecs`` or prequantized ``vecs_int8`` + ``scales``; the JAX
        package's ``rir-extract`` writes the same layout)."""
        with np.load(path, allow_pickle=False) as data:
            names = data["names"] if "names" in data else None
            if "vecs_int8" in data:
                engine = kw.pop("engine", None) or "int8"
                if engine == "int8":
                    return cls(vecs_int8=data["vecs_int8"],
                               scales=data["scales"], names=names,
                               engine=engine, **kw)
                gallery = (data["vecs_int8"].astype(np.float32)
                           * data["scales"][:, None])
                return cls(gallery, names=names, engine=engine, **kw)
            if "vecs" not in data:
                raise ValueError(f"{path} has neither 'vecs' nor 'vecs_int8' "
                                 f"(keys: {sorted(data.keys())})")
            return cls(data["vecs"], names=names, **kw)


class ImageExtractor:
    """Image -> L2-normalized descriptor for the /search/image endpoint.

    Loads the model as the evaluation driver does (``checkpoint`` as in
    ``EvalConfig``; none: ``seeded_init(seed=0)`` weights) and runs the
    bucketed masked extraction with raw uint8 sent to the device.
    Thread-safe: extraction calls are serialized on a lock.
    """

    def __init__(self, model: str, checkpoint: str | None = None,
                 imsize: int = 1024, multiscale: bool = False,
                 batch_size: int = 8, device="cuda"):
        self.device = resolve_device(device)
        cfg = EvalConfig(model=model, checkpoint=checkpoint, imsize=imsize)
        self._model = _load_model(cfg, device=self.device)
        self._extract, self._bucket, self._multiple = _make_extract_fn(
            self._model)
        self.model = model
        self.imsize = imsize
        self.scales = (1.0, 2 ** -0.5, 0.5) if multiscale else (1.0,)
        self.batch_size = batch_size
        self._lock = threading.Lock()

    def __call__(self, images) -> np.ndarray:
        """[H, W, 3] uint8 RGB images (list) -> [n, D] fp32 descriptors."""
        prepped = []
        dev = self._bucket is not None  # exact shapes: normalized on the host
        with span("serve.thumbnail"):
            for img in images:
                img = np.asarray(img, np.uint8)
                if self.imsize:
                    img = imthumbnail(img, self.imsize)
                prepped.append(np.ascontiguousarray(img) if dev else
                               normalize(img.astype(np.float32) / 255.0))
        with span("serve.lock_wait"):
            self._lock.acquire()
        try:
            with span("serve.extract"):
                vecs = extract_vectors(
                    self._extract, prepped, scales=self.scales,
                    bucket=self._bucket, batch_size=self.batch_size,
                    extent_multiple=self._multiple, device_scales=dev,
                    input_norm=(IMAGENET_MEAN, IMAGENET_STD) if dev else None,
                    device=self.device)
        finally:
            self._lock.release()
        return np.asarray(vecs, np.float32)
