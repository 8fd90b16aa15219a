"""What the per-layer readers read of the program's own spans: the port's
``utils.profiling.spans()``, the records of its spans while a profiler
recorded.  In a run of the benchmark that is the traced stretch alone:
the warm-up, the checked steps and ``Stretch.prepare`` record none.  A
program without the store (a checkout from before it) gives None, and
its readers leave their metrics out."""

from __future__ import annotations

__all__ = ["batches", "child_ms_per_batch", "records"]


def records():
    """The program's span records, oldest first, or None where the
    program keeps none."""
    try:
        from research_image_retrieval_tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    return spans()


def batches(recs) -> list[dict]:
    """The finished ``extract.batch`` spans."""
    return [r for r in recs
            if r["name"] == "extract.batch" and r["end_ns"] is not None]


def child_ms_per_batch(recs, names) -> float | None:
    """Host ms per finished ``extract.batch`` span in its child spans
    called one of ``names``, or None without a batch."""
    ids = {r["index"] for r in batches(recs)}
    if not ids:
        return None
    ns = sum(r["end_ns"] - r["start_ns"] for r in recs
             if r["name"] in names and r["parent"] in ids
             and r["end_ns"] is not None)
    return ns / len(ids) / 1e6
