"""The host's dispatch time per batch while indexing: the mean over the
traced stretch's ``extract.batch`` spans (the program's) of the host ms
in their ``extract.dispatch`` child (every scale's resize, the model
and the accumulation, launched)."""

from perfbench import spans


def read(obs: dict):
    if not obs.get("trace"):
        return None
    recs = spans.records()
    if recs is None:
        return None
    return spans.child_ms_per_batch(recs, ("extract.dispatch",))
