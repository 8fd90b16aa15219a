"""Profile the port's search service, unsharded and row-sharded, on one card.

Builds a seeded ``N x 2048`` unit-row gallery on the card (1.4M rows by
default, the GLDv2-index scale of ``chip_smoke.py`` phase 6), then for the
int8 and the exact-on-bf16 engines:

* one engine call at one query (the service's bucket 1), unsharded and
  over ``["cuda:0"] * S``: the wall per call (median of 20, each ending
  in the readback), under ``torch.profiler`` the kernels' busy time per
  call (the union of their intervals), kernel launches and
  ``cudaStreamSynchronize`` calls per call;
* ``SearchService.search`` latency at one client (40 one-query
  requests, the service's 2 ms batching window included): p50 / p99.

It checks that the sharded service returns the unsharded ids where the
scores are distinct by more than 1e-6.  Needs a CUDA card; imports no JAX.

    python tools/profile_sharded_search.py [--root DIR] [--shards 4]

``--root`` imports the port from another checkout (for example the parent
commit unpacked with ``git archive``), so two trees can be compared in one
session, each in its own process:

    for r in parent . . parent; do
        python tools/profile_sharded_search.py --root $r; done
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time

import numpy as np

SYNC = ("cudaStreamSynchronize", "cudaLaunchKernel")


def _busy_ms(events) -> float:
    """The union of the kernels' [start, end] intervals, in ms."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, lo, hi = 0.0, None, None
    for a, b in iv:
        if hi is None or a > hi:
            total += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return (total + (0.0 if hi is None else hi - lo)) / 1e3


def profile_call(torch, run, q, n: int = 20) -> dict:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        run(q)[0].cpu()
    walls = []
    for _ in range(n):
        t = time.perf_counter()
        run(q)[0].cpu()
        walls.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        for _ in range(n):
            run(q)[0].cpu()
    kernels = [e for e in p.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    calls = {e.key: e.count / n for e in p.key_averages() if e.key in SYNC}
    return dict(wall=float(np.median(walls)), busy=_busy_ms(kernels) / n,
                launches=calls.get("cudaLaunchKernel", 0.0),
                syncs=calls.get("cudaStreamSynchronize", 0.0))


def one_client(svc, queries, requests: int, k: int) -> dict:
    lat = []

    def client():
        for r in range(requests):
            t = time.perf_counter()
            svc.search(queries[r % len(queries)], k=k)
            lat.append((time.perf_counter() - t) * 1e3)

    th = threading.Thread(target=client)
    th.start()
    th.join(timeout=300)
    if th.is_alive() or len(lat) != requests:
        raise AssertionError("the client did not finish")
    return dict(p50=float(np.percentile(lat, 50)),
                p99=float(np.percentile(lat, 99)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout whose port is profiled")
    p.add_argument("--shards", type=int, default=4)
    p.add_argument("--n", type=int, default=1_400_000)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--seed", type=int, default=14)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("profile_sharded_search: no CUDA card", file=sys.stderr)
        return 1
    from research_image_retrieval_tpu_torch.ops import quantize_gallery_int8
    from research_image_retrieval_tpu_torch.serve import SearchService

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    tag = f"[{args.root}; {smi}]"
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    g16 = torch.empty((args.n, 2048), dtype=torch.bfloat16, device="cuda")
    q8 = torch.empty((args.n, 2048), dtype=torch.int8, device="cuda")
    s8 = torch.empty((args.n,), dtype=torch.float32, device="cuda")
    for b in range(0, args.n, 65536):
        e = min(b + 65536, args.n)
        blk = torch.randn((e - b, 2048), device="cuda", generator=gen)
        blk /= torch.linalg.vector_norm(blk, dim=1, keepdim=True)
        g16[b:e] = blk.to(torch.bfloat16)
        q8[b:e], s8[b:e] = quantize_gallery_int8(blk)
    rq = torch.randn((64, 2048), device="cuda", generator=gen)
    queries = (rq / torch.linalg.vector_norm(rq, dim=1, keepdim=True)
               ).cpu().numpy()
    q1 = torch.from_numpy(queries[:1].copy()).cuda()
    mesh = ["cuda:0"] * args.shards
    for name, kw in (("int8", dict(vecs_int8=q8, scales=s8, engine="int8")),
                     ("exact-bf16", dict(gallery=g16, engine="exact",
                                         store_dtype="bfloat16"))):
        with SearchService(k=args.k, max_batch=32, **kw) as one, \
                SearchService(k=args.k, max_batch=32, mesh=mesh,
                              **kw) as many:
            one.warmup()
            many.warmup()
            s1, i1 = one.search(queries[:32])
            _, i4 = many.search(queries[:32])
            gap = np.abs(np.diff(s1, axis=1)) > 1e-6
            distinct = np.ones_like(s1, bool)
            distinct[:, 1:] &= gap
            distinct[:, :-1] &= gap
            if (i4 != i1)[distinct].any():
                raise AssertionError(f"{name}: sharded ids differ")
            for label, svc in (("unsharded", one),
                               (f"{args.shards} shards", many)):
                with torch.no_grad(), svc._on_worker_stream():
                    c = profile_call(torch, svc._run_for(1), q1)
                lat = one_client(svc, queries, 40, args.k)
                print(f"{name} {label}: engine call at Q = 1: wall "
                      f"{c['wall']:.3f} ms, kernels busy {c['busy']:.3f} "
                      f"ms, {c['launches']:.0f} launches, "
                      f"{c['syncs']:.0f} stream syncs per call; one client "
                      f"x 40: p50 {lat['p50']:.3f} ms, p99 "
                      f"{lat['p99']:.3f} ms {tag}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
