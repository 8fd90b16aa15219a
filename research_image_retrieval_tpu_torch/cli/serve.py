"""Serving daemon: HTTP top-k search over a saved descriptor index
(port of ``research_image_retrieval_tpu/cli/serve.py``).

    python -m research_image_retrieval_tpu_torch.cli.serve \
        --gallery index.npz --port 8080 [--engine int8] [--sharded] \
        [--model gem_r50 --checkpoint gem_r50.pt --imsize 1024]

``--sharded`` row-shards the index over every local GPU (one process;
``parallel.default_search_mesh``), exact or int8 engine.

Then:

    curl localhost:8080/healthz
    curl -X POST localhost:8080/search -d '{"vectors": [[...]], "k": 10}'
    curl -X POST localhost:8080/search/image \
        -d '{"image_b64": "<jpeg base64>", "k": 10}'

Queries arriving concurrently are micro-batched into single engine calls
(``serve/service.py``); every query bucket runs once at start-up unless
``--no-warmup``.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="HTTP top-k search daemon")
    p.add_argument("--gallery", required=True, help=".npz from cli.extract")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--engine", choices=("exact", "approx", "int8"),
                   default=None,
                   help="top-k engine (default: int8 for a prequantized "
                        "index, exact otherwise)")
    p.add_argument("--topk", type=int, default=100,
                   help="server-wide max k (requests may ask for less)")
    p.add_argument("--max-batch", type=int, default=32,
                   help="largest coalesced query batch (rounded up to a "
                        "power of two)")
    p.add_argument("--window-ms", type=float, default=2.0,
                   help="micro-batching window after the first query")
    p.add_argument("--store-dtype", default="bfloat16",
                   choices=("bfloat16", "float32"),
                   help="device gallery dtype for the float engines")
    p.add_argument("--exact-fp32-scores", action="store_true",
                   help="accepted; the exact engine always scores in fp32")
    p.add_argument("--selection", choices=("exact", "approx"),
                   default="exact", help="int8 engine selector")
    p.add_argument("--sharded", action="store_true",
                   help="row-shard the index over every local device "
                        "(exact / int8 engines)")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip running every query bucket at startup")
    p.add_argument("--verbose", action="store_true",
                   help="log each HTTP request")
    # image-search endpoint (optional)
    p.add_argument("--model", default=None,
                   help="enable POST /search/image with this registry model")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--imsize", type=int, default=1024)
    p.add_argument("--multiscale", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from research_image_retrieval_tpu_torch.serve import (
        ImageExtractor,
        SearchService,
        make_http_server,
    )

    mesh = None
    if args.sharded:
        from research_image_retrieval_tpu_torch.parallel import (
            default_search_mesh,
        )

        mesh = default_search_mesh(args.device)
        print(f"sharding the gallery over {len(mesh)} devices")
    service = SearchService.from_npz(
        args.gallery,
        engine=args.engine,
        k=args.topk,
        max_batch=args.max_batch,
        window_ms=args.window_ms,
        store_dtype=args.store_dtype,
        exact_fp32_scores=args.exact_fp32_scores,
        selection=args.selection,
        device=args.device,
        mesh=mesh,
    )
    extractor = None
    if args.model:
        if not args.checkpoint:
            print(f"WARNING: --model {args.model} without --checkpoint: "
                  "image search runs seeded random weights (debug only)")
        extractor = ImageExtractor(args.model, checkpoint=args.checkpoint,
                                   imsize=args.imsize,
                                   multiscale=args.multiscale,
                                   device=args.device)
    if not args.no_warmup:
        print("warming engine buckets "
              f"(1..{service.max_batch}, k={service.k}) ...")
        service.warmup()

    server = make_http_server(service, host=args.host, port=args.port,
                              extractor=extractor, verbose=args.verbose)
    print(f"rir-serve: {service.engine} engine over "
          f"{service.n_gallery} x {service.dim} index on "
          f"http://{args.host}:{args.port} "
          f"(image search: {'on' if extractor else 'off'})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
