"""The share of the pixels fed to the model that belong to an image,
while indexing: the ``px_valid`` over the ``px_fed`` counts of the
traced stretch's ``extract.batch`` spans (the program's, every scale
of each batch; ``px_fed`` is the batch's rows times each scale's padded
bucket), so it falls with bucket padding, tail rows and skipped
scales."""

from perfbench import spans


def read(obs: dict):
    if not obs.get("trace"):
        return None
    recs = spans.records()
    if recs is None:
        return None
    counts = [r["counts"] for r in spans.batches(recs)
              if "px_fed" in r["counts"]]
    fed = sum(c["px_fed"] for c in counts)
    if not fed:
        return None
    return 100.0 * sum(c["px_valid"] for c in counts) / fed
