"""The share of the query-key pairs the ViT blocks compute that lie
inside an image while indexing: the valid pairs of the traced stretch's
attention calls (every head's, from the key masks the benchmark kept)
over the ``pairs`` x ``layers`` counts of the stretch's ``vit.blocks``
spans (the program's: every pair of the padded bucket's tokens, every
head and layer), so it falls with bucket padding and tail rows."""

from perfbench import spans


def read(obs: dict):
    a = obs.get("attention")
    if not obs.get("trace") or not a:
        return None
    recs = spans.records()
    if recs is None:
        return None
    fed = sum(r["counts"]["pairs"] * r["counts"]["layers"] for r in recs
              if r["name"] == "vit.blocks" and r["end_ns"] is not None)
    if not fed:
        return None
    return 100.0 * a["valid_pairs"] / fed
