"""Search CLI: top-k over a saved descriptor index
(port of ``research_image_retrieval_tpu/cli/search.py``).

    python -m research_image_retrieval_tpu_torch.cli.search \
        --gallery gallery.npz --queries queries.npz --topk 10 \
        [--engine exact|approx|int8] [--alpha-qe] --output results.json

Engines: ``exact`` (fp32 grouped stream), ``approx`` (bf16 scores),
``int8`` (symmetric per-row quantized gallery).  A gallery written with
``--quantize-int8`` (``vecs_int8`` + ``scales``) is searched with the int8
engine by default; other engines (or --alpha-qe) dequantize it.  Either
package's ``.npz`` index is read.
"""

from __future__ import annotations

import argparse
import json


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="top-k descriptor search")
    p.add_argument("--gallery", required=True, help=".npz from cli.extract")
    p.add_argument("--queries", required=True, help=".npz from cli.extract")
    p.add_argument("--topk", type=int, default=100)
    p.add_argument("--engine", choices=("exact", "approx", "int8"),
                   default=None,
                   help="top-k engine (default: int8 for a prequantized "
                        "gallery, exact otherwise)")
    p.add_argument("--approx", action="store_true",
                   help="alias for --engine approx")
    p.add_argument("--alpha-qe", action="store_true")
    p.add_argument("--qe-k", type=int, default=10)
    p.add_argument("--qe-alpha", type=float, default=3.0)
    p.add_argument("--output", default=None, help="write results JSON here")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from research_image_retrieval_tpu_torch.index import alpha_query_expansion
    from research_image_retrieval_tpu_torch.ops import (
        int8_streaming_topk,
        quantize_gallery_int8,
        streaming_topk,
    )
    from research_image_retrieval_tpu_torch.utils.device import (
        resolve_device,
    )

    dev = resolve_device(args.device)
    with np.load(args.gallery, allow_pickle=False) as f:
        gal = {k: f[k] for k in f.files}
    with np.load(args.queries, allow_pickle=False) as f:
        qry = {k: f[k] for k in f.files}
    if "vecs" in qry:
        qvecs = qry["vecs"]
    elif "vecs_int8" in qry:
        # the engines quantize queries on the fly: dequantize to floats
        qvecs = qry["vecs_int8"].astype(np.float32) * qry["scales"][:, None]
    else:
        raise SystemExit(f"{args.queries} has neither 'vecs' nor "
                         f"'vecs_int8' (keys: {sorted(qry)})")

    # an explicit engine (--engine or --approx) wins over the stored layout
    prequantized = "vecs_int8" in gal
    engine = args.engine or ("approx" if args.approx else
                             ("int8" if prequantized else "exact"))
    qg = gscales = gvecs = None
    if prequantized:
        qg, gscales = gal["vecs_int8"], gal["scales"]
        n_gal = len(qg)
        if engine != "int8" or args.alpha_qe:
            gvecs = qg.astype(np.float32) * gscales[:, None]
            if engine != "int8":
                print(f"note: {args.gallery} is int8; dequantizing for "
                      f"--engine {engine}")
    else:
        gvecs = gal["vecs"]
        n_gal = len(gvecs)
        if args.engine is None and not args.approx:
            print("note: float gallery -> --engine exact (fp32 stream); "
                  "extract with --quantize-int8 to serve the int8 engine")
    gnames = gal["names"] if "names" in gal else np.arange(n_gal)

    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    with torch.no_grad():
        if args.alpha_qe:
            qvecs = alpha_query_expansion(t(qvecs), t(gvecs), k=args.qe_k,
                                          alpha=args.qe_alpha).cpu().numpy()
        k = min(args.topk, n_gal)
        if engine == "int8":
            if qg is None:
                qg8, gs = quantize_gallery_int8(t(gvecs))
            else:
                qg8 = torch.as_tensor(qg, device=dev)
                gs = torch.as_tensor(gscales, device=dev)
            s, i = int8_streaming_topk(t(qvecs), qg8, gs, k=k)
            scores, idx = s.cpu().numpy(), i.cpu().numpy()
        else:
            scores, idx = streaming_topk(qvecs, gvecs, k=k,
                                         exact=engine == "exact", device=dev)

    results = []
    qnames = qry["names"] if "names" in qry else np.arange(len(qvecs))
    for qi in range(len(qvecs)):
        results.append({
            "query": str(qnames[qi]),
            "matches": [
                {"name": str(gnames[j]), "score": float(s)}
                for j, s in zip(idx[qi], scores[qi])
            ],
        })
        top = results[-1]["matches"][0]
        print(f"{results[-1]['query']}: {top['name']} ({top['score']:.4f}) "
              f"+ {k - 1} more")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
        print(f"wrote {len(results)} result lists -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
