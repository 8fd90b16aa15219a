"""The host's staging time per batch while indexing: the mean over the
traced stretch's ``extract.batch`` spans (the program's) of the host ms
in their ``extract.assemble`` (slot allocation, padding fill, copies
into the pinned buffers) and ``extract.h2d`` (the side-stream copy's
launch) children."""

from perfbench import spans


def read(obs: dict):
    if not obs.get("trace"):
        return None
    recs = spans.records()
    if recs is None:
        return None
    return spans.child_ms_per_batch(recs, ("extract.assemble", "extract.h2d"))
