"""PyTorch port, the program's spans (``utils/profiling.py span``) on the
CPU, and the benchmark's readers of them:

* with no profiler a span site gets the shared no-op and records nothing;
* under ``profile().start()`` / ``stop()`` (how the benchmark's traced
  stretch runs the profiler) spans are host events named as the program
  names them, never user annotations, with their parents and ids in the
  store; the store keeps the newest ``SPAN_CAP`` records;
* ``extract_vectors`` records its span tree, and each batch's counts
  equal the ones worked out here from the image sizes;
* the train step records ``train.step`` and its three phases;
* a ``SearchService`` round trip records ``serve.queue_wait`` and
  ``serve.engine`` under one request id, and ``stats()`` sums both;
* ``ImageExtractor`` records its lock wait, thumbnail and extraction;
* a ViT extraction records ``vit.embed``, ``vit.blocks`` (with its counts)
  and ``vit.head``, as host events;
* the four index readers on hand-made records.
"""

import math
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import harness
from research_image_retrieval_tpu_torch.index import extract_vectors
from research_image_retrieval_tpu_torch.serve import SearchService
from research_image_retrieval_tpu_torch.serve.service import ImageExtractor
from research_image_retrieval_tpu_torch.utils import profiling
from test_torch_model import few_torch_threads  # noqa: F401


class _Recording:
    """A profiler session as the benchmark's ``Stretch`` runs one, and the
    span records it added to the store."""

    def __enter__(self):
        self.first = profiling._store.n
        self.prof = profile(activities=[ProfilerActivity.CPU])
        self.prof.start()
        return self

    def __exit__(self, *exc):
        self.prof.stop()
        return False

    def records(self, prefix=""):
        return [r for r in profiling.spans() if r["index"] >= self.first
                and r["name"].startswith(prefix)]


def _named(recs, name):
    return [r for r in recs if r["name"] == name]


def test_span_off_is_the_shared_noop():
    assert not torch._C._autograd._profiler_enabled()
    before = profiling._store.n
    with profiling.span("test.off", id=3, rows=2) as s:
        s.count(rows=5)
    assert s is profiling._OFF and not s
    assert profiling.span("test.other") is profiling._OFF
    profiling.record("test.after", 1, 2, id=1)
    assert profiling._store.n == before


def test_spans_are_host_events_with_parents_and_ids():
    seen = {}

    def other_thread():
        with profiling.span("test.thread") as s:
            seen["rec"] = s.rec

    with _Recording() as rec:
        with profiling.span("test.outer", id=7, rows=2) as outer:
            outer.count(px=9)
            with profiling.span("test.inner"):
                torch.ones(3).add_(1)
            with profiling.span("test.sibling", id=8):
                pass
            t = threading.Thread(target=other_thread)
            t.start()
            t.join(timeout=30)
        assert not t.is_alive()
    events = {e.name: e for e in rec.prof.events()
              if e.name.startswith("test.")}
    # the other thread's span: stored, an event where the profiler
    # observes that thread
    assert {"test.outer", "test.inner", "test.sibling"} <= set(events)
    for e in events.values():
        assert e.is_user_annotation is False
        assert e.device_type == torch.autograd.DeviceType.CPU
    recs = {r["name"]: r for r in rec.records("test.")}
    o, i, s = recs["test.outer"], recs["test.inner"], recs["test.sibling"]
    assert o["parent"] is None and o["id"] == 7
    assert o["counts"] == {"rows": 2, "px": 9}
    assert i["parent"] == o["index"] and i["id"] == 7
    assert s["parent"] == o["index"] and s["id"] == 8
    assert recs["test.thread"]["parent"] is None  # nesting is per thread
    assert o["start_ns"] <= i["start_ns"] <= i["end_ns"] <= s["start_ns"]
    assert s["end_ns"] <= o["end_ns"]
    assert [r["index"] for r in rec.records("test.")] == sorted(
        r["index"] for r in recs.values())


def test_span_open_when_the_profiler_stops():
    """The benchmark stops its profiler inside the images' generator,
    that is inside an open ``extract.source``."""
    with _Recording() as rec:
        s = profiling.span("test.open")
        s.__enter__()
    s.__exit__(None, None, None)
    (r,) = rec.records("test.open")
    assert r["end_ns"] >= r["start_ns"]
    assert profiling.span("test.later") is profiling._OFF


def test_store_is_bounded(monkeypatch):
    assert profiling.SPAN_CAP == 100_000
    assert profiling._store.records.maxlen == profiling.SPAN_CAP
    monkeypatch.setattr(profiling, "_store", profiling._SpanStore(5))
    with _Recording():
        for k in range(12):
            with profiling.span("test.bounded", id=k):
                pass
        profiling.record("test.recorded", 10, 20, id=99, calls=1)
    got = profiling.spans()
    assert [r["index"] for r in got] == [8, 9, 10, 11, 12]
    assert [r["id"] for r in got] == [8, 9, 10, 11, 99]
    assert got[-1]["start_ns"] == 10 and got[-1]["counts"] == {"calls": 1}


# -- the extraction pipeline ---------------------------------------------------

SCALES = (1.0, 2 ** -0.5, 0.5)
BUCKET, BATCH = 32, 2
# two bucket shapes, (64, 96) and (96, 64); the last image's batch is a
# tail, flushed by the readback, in the slot its bucket's first batch
# left; (40, 70) and (70, 50) skip their smaller scales
SIZES = [(60, 90), (40, 70), (90, 60), (70, 50), (64, 96)]


def _images():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in SIZES]


def _extract_fn(x, valid_hw):
    return torch.stack([x.mean(dim=(1, 2, 3)), valid_hw[:, 0].float(),
                        valid_hw[:, 1].float()], dim=1)


def _expected_batches():
    """(rows, px_valid, px_fed, slot_alloc) of each dispatched batch,
    from the sizes: a bucket dispatches when it holds ``BATCH`` images,
    the rest at the end in the order the buckets first filled."""
    q = lambda v: -(-v // BUCKET) * BUCKET  # noqa: E731
    pending, order = {}, []
    for h, w in SIZES:
        key = (q(h), q(w))
        pending.setdefault(key, []).append((h, w))
        if len(pending[key]) == BATCH:
            order.append((key, pending[key]))
            pending[key] = []
    order += [(key, rows) for key, rows in pending.items() if rows]
    out, slots = [], [None] * 2  # pipeline_depth=2
    for b, ((bh, bw), rows) in enumerate(order):
        valid = 0
        for h, w in rows:
            for s in SCALES:
                oh, ow = math.floor(h * s), math.floor(w * s)
                if min(oh, ow) >= 36:
                    valid += oh * ow
        pads = [(bh, bw) if s == 1.0 else
                (q(math.floor(bh * s)), q(math.floor(bw * s)))
                for s in SCALES]
        fresh = slots[b % 2] != (bh, bw)
        slots[b % 2] = (bh, bw)
        out.append((len(rows), valid, BATCH * sum(h * w for h, w in pads),
                    int(fresh)))
    return out


def test_extract_vectors_records_its_span_tree():
    kw = dict(scales=SCALES, bucket=BUCKET, batch_size=BATCH,
              device_scales=True, pipeline_depth=2, device="cpu",
              input_norm=(np.array([0.4, 0.5, 0.6], np.float32),
                          np.array([0.2, 0.25, 0.3], np.float32)))
    plain = extract_vectors(_extract_fn, iter(_images()), **kw)
    with _Recording() as rec:
        traced = extract_vectors(_extract_fn, iter(_images()), **kw)
    np.testing.assert_array_equal(traced, plain)
    recs = rec.records("extract.")
    (call,) = _named(recs, "extract.vectors")
    sources = _named(recs, "extract.source")
    assert len(sources) == len(SIZES) + 1  # the last wait finds the end
    assert {r["parent"] for r in sources} == {call["index"]}
    batches = _named(recs, "extract.batch")
    (readback,) = _named(recs, "extract.readback")
    assert readback["parent"] == call["index"]
    # the tail batch is dispatched by the readback's flush
    assert [b["parent"] for b in batches] == [call["index"]] * 2 + [
        readback["index"]]
    assert [b["id"] for b in batches] == [0, 1, 2]
    for b in batches:
        kids = [r for r in recs if r["parent"] == b["index"]]
        assert [k["name"] for k in kids] == [
            "extract.assemble", "extract.h2d", "extract.dispatch"]
        assert {k["id"] for k in kids} == {b["id"]}
        assert all(b["start_ns"] <= k["start_ns"] <= k["end_ns"]
                   <= b["end_ns"] for k in kids)
    got = [(b["counts"]["rows"], b["counts"]["px_valid"],
            b["counts"]["px_fed"], b["counts"]["slot_alloc"])
           for b in batches]
    assert got == _expected_batches()
    assert [b["counts"]["rows_padded"] for b in batches] == [BATCH] * 3
    assert [s for *_, s in got] == [1, 1, 0]


def test_vit_records_its_spans_with_counts():
    from research_image_retrieval_tpu_torch.models import get_model

    torch.manual_seed(0)
    model = get_model("vit_b16", variant="test", outputdim=8, num_classes=4,
                      img_size=32).eval()
    x = torch.randn(2, 40, 48, 3)
    valid = torch.tensor([[40, 48], [32, 24]])
    plain = model.extract(x, valid)
    with _Recording() as rec:
        traced = model.extract(x, valid)
    torch.testing.assert_close(traced, plain, rtol=0, atol=0)
    recs = rec.records("vit.")
    assert [r["name"] for r in recs] == ["vit.embed", "vit.blocks",
                                         "vit.head"]
    assert all(r["parent"] is None and r["end_ns"] is not None
               for r in recs)
    n = 1 + (40 // 8) * (48 // 8)  # the CLS token and a 5 x 6 patch grid
    assert recs[1]["counts"] == {"tokens": 2 * n, "pairs": 2 * 2 * n * n,
                                 "layers": 2}
    assert recs[0]["counts"] == recs[2]["counts"] == {}
    assert recs[0]["end_ns"] <= recs[1]["start_ns"]
    assert recs[1]["end_ns"] <= recs[2]["start_ns"]
    events = [e for e in rec.prof.events() if e.name.startswith("vit.")]
    assert sorted(e.name for e in events) == ["vit.blocks", "vit.embed",
                                              "vit.head"]
    for e in events:
        assert e.is_user_annotation is False
        assert e.device_type == torch.autograd.DeviceType.CPU


# -- the train step and the server ---------------------------------------------

def test_train_step_records_its_phases():
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

    model = get_model("gem_r50", backbone_name="resnet18", outputdim=8,
                      num_classes=4)
    state = create_train_state(model, 0, make_sgd_optimizer(0.1), "cpu")
    step = make_train_step((IMAGENET_MEAN, IMAGENET_STD))
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    y = np.array([0, 3])
    state, _ = step(state, x, y)  # untraced: nothing recorded
    with _Recording() as rec:
        state, metrics = step(state, x, y)
    assert np.isfinite(float(metrics["loss"]))
    recs = rec.records("train.")
    (top,) = _named(recs, "train.step")
    assert top["id"] == 1 and top["parent"] is None
    kids = [r for r in recs if r["parent"] == top["index"]]
    assert [k["name"] for k in kids] == [
        "train.forward", "train.backward", "train.optimizer"]
    assert {k["id"] for k in kids} == {1}
    assert kids[0]["end_ns"] <= kids[1]["start_ns"]
    assert kids[1]["end_ns"] <= kids[2]["start_ns"]


def test_search_round_trip_shares_one_request_id():
    rng = np.random.default_rng(1)
    gallery = rng.standard_normal((64, 16)).astype(np.float32)
    with SearchService(gallery, engine="exact", k=3, max_batch=4,
                       window_ms=1.0, device="cpu") as svc:
        svc.search(gallery[:1])  # untraced: the totals count it
        with _Recording() as rec:
            _, idx = svc.search(gallery[5:6])
        st = svc.stats()
    assert idx[0, 0] == 5
    recs = rec.records("serve.")
    (wait,) = _named(recs, "serve.queue_wait")
    (engine,) = _named(recs, "serve.engine")
    assert wait["id"] == engine["id"] == 1
    assert wait["start_ns"] <= wait["end_ns"] <= engine["start_ns"]
    assert engine["counts"] == {"queries": 1, "calls": 1}
    assert st["requests"] == 2
    assert st["engine_ms_total"] > 0.0
    assert st["queue_wait_ms_total"] >= 0.0


def test_image_extractor_records_lock_thumbnail_and_extraction():
    ext = ImageExtractor.__new__(ImageExtractor)
    ext._extract, ext._bucket, ext._multiple = _extract_fn, 32, 1
    ext.imsize, ext.scales, ext.batch_size = 64, (1.0,), 2
    ext.device = torch.device("cpu")
    ext._lock = threading.Lock()
    img = np.random.default_rng(2).integers(0, 256, (80, 100, 3),
                                            dtype=np.uint8)
    with _Recording() as rec:
        vecs = ext([img, img[:60]])
    assert vecs.shape == (2, 3) and not ext._lock.locked()
    names = [r["name"] for r in rec.records("serve.")]
    assert names == ["serve.thumbnail", "serve.lock_wait", "serve.extract"]
    (call,) = _named(rec.records("extract."), "extract.vectors")
    assert call["parent"] == rec.records("serve.extract")[0]["index"]


# -- the benchmark's readers ---------------------------------------------------

def _rec(index, name, start_ms, end_ms, parent=None, **counts):
    return {"index": index, "name": name, "start_ns": int(start_ms * 1e6),
            "end_ns": None if end_ms is None else int(end_ms * 1e6),
            "parent": parent, "id": None, "counts": counts}


HAND_MADE = [
    _rec(0, "extract.source", 0, 1),
    _rec(1, "extract.batch", 1, 20, rows=8, rows_padded=8, px_valid=900,
         px_fed=1000, slot_alloc=1),
    _rec(2, "extract.slot_wait", 1, 5, parent=1),
    _rec(3, "extract.assemble", 5, 8, parent=1),
    _rec(4, "extract.h2d", 8, 9, parent=1),
    _rec(5, "extract.dispatch", 9, 19, parent=1),
    _rec(6, "extract.batch", 20, 30, rows=3, rows_padded=8, px_valid=300,
         px_fed=1000, slot_alloc=0),
    _rec(7, "extract.assemble", 20, 22, parent=6),
    _rec(8, "extract.h2d", 22, 23, parent=6),
    _rec(9, "extract.dispatch", 23, 29, parent=6),
    # a batch the stretch cut off, and phases of a batch that began before
    # it: neither counts
    _rec(10, "extract.batch", 30, None, px_valid=5, px_fed=5),
    _rec(11, "extract.assemble", 40, 90, parent=None),
    # the ViT's blocks inside two dispatches, and one the stretch cut off
    _rec(13, "vit.blocks", 10, 18, parent=5, tokens=40, pairs=1000,
         layers=2),
    _rec(14, "vit.blocks", 24, 28, parent=9, tokens=30, pairs=600, layers=2),
    _rec(15, "vit.blocks", 31, None, tokens=5, pairs=25, layers=2),
    _rec(12, "train.step", 0, 50),
]


@pytest.mark.parametrize("metric, want", [
    ("extract.valid_px_share.index", 60.0),
    ("extract.stage_ms.index", 3.5),     # (3 + 1 + 2 + 1) / 2
    ("extract.dispatch_ms.index", 8.0),  # (10 + 6) / 2
    ("vit.pair_valid_share.index_vit", 75.0),  # 2400 / (2 * (1000 + 600))
])
def test_index_readers_on_hand_made_spans(monkeypatch, metric, want):
    read = harness._reader(metric)
    assert read({}) is None  # no trace: nothing reported
    monkeypatch.setattr(profiling, "spans", lambda: list(HAND_MADE))
    # the valid pairs are the benchmark's own count of the stretch
    obs = {"trace": {"window_s": 1.0}, "attention": {"valid_pairs": 2400}}
    assert read(obs) == pytest.approx(want)
    monkeypatch.setattr(profiling, "spans", lambda: HAND_MADE[-1:])
    assert read(obs) is None  # no batch in the stretch
    monkeypatch.delattr(profiling, "spans")
    assert read(obs) is None  # a program without the store
