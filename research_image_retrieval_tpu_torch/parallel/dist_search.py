"""Row-sharded gallery search: local streaming top-k per shard, then a
merge of the shards' candidates (port of
``research_image_retrieval_tpu/parallel/dist_search.py``).

Two forms of the JAX mesh:

* **in-process**: ``mesh`` is a list of devices (default: every local
  GPU, ``default_search_mesh``); one shard per entry, and a device may
  repeat.  Each shard runs the port's engine (``ops/topk_stream.py``) on
  its own device; the ``[Q, k]`` candidates merge on the first device.
  The engines never wait for the card, so one host thread queues every
  shard in turn while the cards run.  This is the form ``SearchService``
  and ``cli.serve --sharded`` use; it adds gallery capacity, and speed
  only where a shard's device time exceeds the host's cost to issue it
  (at one query the int8 engine is host-paced: ``PERF.md`` §6).
* **cross-process**: ``mesh`` is a ``parallel.mesh.Mesh``; the shards
  are the ranks of its data axis, each on its own device, and the merge
  runs on every rank after a gather (an ``all_reduce`` into a zero
  buffer, ``utils/collectives.py``).

As in JAX: the gallery is zero-padded to a multiple of the shard count;
each shard masks its pad rows (global id >= ``n_valid``) BEFORE its local
selection, so a zero row never displaces a real negative-similarity
neighbour; each shard selects ``k`` locally; ids are global and clipped
to ``n_valid - 1``.  The int8 engine quantizes per row before sharding
(quantize-then-shard equals shard-then-quantize) or takes a prequantized
gallery with its scales.
"""

from __future__ import annotations

import numpy as np
import torch

from research_image_retrieval_tpu_torch.ops.topk_stream import (
    int8_streaming_topk,
    quantize_gallery_int8,
    scan_streaming_topk,
)
from research_image_retrieval_tpu_torch.parallel.mesh import Mesh
from research_image_retrieval_tpu_torch.utils import collectives
from research_image_retrieval_tpu_torch.utils.device import resolve_device

__all__ = [
    "default_search_mesh",
    "make_sharded_stream_fn",
    "place_sharded_gallery",
    "sharded_search_topk",
    "sharded_streaming_topk",
]


def default_search_mesh(device="cuda") -> list:
    """Every local GPU (the serving layout); ``[cpu]`` for the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _shards(mesh) -> tuple[int, list | None]:
    """(shard count, in-process device list or None for a Mesh)."""
    if isinstance(mesh, Mesh):
        return mesh.shape["data"], None
    devices = [torch.device(d) for d in mesh]
    if not devices:
        raise ValueError("a sharded search needs at least one device")
    return len(devices), devices


def _as_tensor(x, dtype=None) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        x = torch.from_numpy(a if a.flags.writeable else a.copy())
    return x if dtype is None else x.to(dtype)


def _pad_rows(t: torch.Tensor, n_shards: int) -> torch.Tensor:
    pad = (-t.shape[0]) % n_shards
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])


def place_sharded_gallery(gallery, mesh, g_scales=None):
    """Pad a gallery to a multiple of the shard count and place its row
    blocks: ``(gallery shards, scale shards, n_valid)``.  In-process the
    shards are lists, one tensor per device; with a ``Mesh`` they are
    this rank's block, on the gallery's device if that is a card, else
    on the rank's card under NCCL, else on the CPU.  The scales are zeros
    when ``g_scales`` is None (the exact engine ignores them)."""
    n_shards, devices = _shards(mesh)
    g = _as_tensor(gallery)
    n = g.shape[0]
    g = _pad_rows(g, n_shards)
    s = (torch.zeros((g.shape[0],), dtype=torch.float32, device=g.device)
         if g_scales is None
         else _pad_rows(_as_tensor(g_scales, torch.float32).to(g.device),
                        n_shards))
    shard_n = g.shape[0] // n_shards
    if devices is None:
        i = mesh.coords["data"]
        dev = _rank_device(g)
        rows = slice(i * shard_n, (i + 1) * shard_n)
        return g[rows].to(dev), s[rows].to(dev), n
    return ([g[j * shard_n:(j + 1) * shard_n].to(d)
             for j, d in enumerate(devices)],
            [s[j * shard_n:(j + 1) * shard_n].to(d)
             for j, d in enumerate(devices)], n)


def _rank_device(t: torch.Tensor) -> torch.device:
    if t.device.type == "cuda":
        return t.device
    if torch.cuda.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def _merge(parts, n_valid: int, k: int, mesh=None):
    """The best ``k`` of the shards' candidates, ids clipped to
    ``n_valid - 1``.  ``parts`` holds one ``(scores [Q, kk], global ids
    [Q, kk])`` pair per in-process shard (merged on the first one's
    device), or this rank's one pair with a ``Mesh`` (the data ranks'
    candidates gathered first, on every rank)."""
    if isinstance(mesh, Mesh):
        (sc, ids), = parts
        n, j = mesh.shape["data"], mesh.coords["data"]
        kk = sc.shape[1]
        cols, group = slice(j * kk, (j + 1) * kk), mesh.group("data")
        all_s = collectives.gather_columns(sc, cols, kk * n, group)
        all_i = collectives.gather_columns(ids, cols, kk * n, group)
    else:
        first = parts[0][0].device
        all_s = torch.cat([p[0].to(first) for p in parts], dim=1)
        all_i = torch.cat([p[1].to(first) for p in parts], dim=1)
    ms, mi = torch.topk(all_s, k, dim=1)
    return ms, torch.clamp(torch.gather(all_i, 1, mi), 0, n_valid - 1)


def make_sharded_stream_fn(mesh, n_valid: int, shard_n: int, k: int = 100,
                           chunk: int | None = 65536, engine: str = "exact",
                           selection: str = "exact"):
    """``run(queries, gallery shards, scale shards) -> (scores [Q, k], ids
    [Q, k])`` over shards of ``shard_n`` rows of a gallery of ``n_valid``
    real rows, built once and reused (the serving daemon's form).
    In-process the results are on the first device; with a ``Mesh`` on
    every rank's device."""
    if engine not in ("exact", "int8"):
        raise ValueError(f"engine must be 'exact' or 'int8', got {engine!r}")
    _, devices = _shards(mesh)
    kk = min(k, shard_n)
    local_chunk = None if chunk is None else min(chunk, shard_n)

    def local(j, q, g, s):
        nv = int(np.clip(n_valid - j * shard_n, 0, shard_n))
        if engine == "int8":
            sc, ids = int8_streaming_topk(q, g, s, k=kk, chunk=local_chunk,
                                          n_valid=nv, selection=selection)
        else:
            sc, ids = scan_streaming_topk(q, g, k=kk, chunk=local_chunk,
                                          n_valid=nv)
        return sc, ids + j * shard_n

    if devices is None:
        j = mesh.coords["data"]

        def run(queries, g, s):
            q = _as_tensor(queries, torch.float32).to(g.device)
            return _merge([local(j, q, g, s)], n_valid, k, mesh)

        return run

    def run(queries, g_shards, s_shards):
        # on the first device once: a host copy to each would wait for
        # that device's queue
        q = _as_tensor(queries, torch.float32).to(devices[0])
        return _merge([local(j, q.to(d), g, s) for j, (d, g, s)
                       in enumerate(zip(devices, g_shards, s_shards))],
                      n_valid, k)

    return run


def sharded_search_topk(queries, gallery, k: int = 100, mesh=None):
    """Top-k with the whole ``[Q, shard_n]`` fp32 score block per shard
    (one chunk, no streaming).  ``queries`` [Q, D] and ``gallery`` [N, D]
    L2-normalized; returns ``(scores [Q, k], global ids [Q, k])``, best
    first."""
    g = _as_tensor(gallery, torch.float32)
    return sharded_streaming_topk(queries, g, k=k, mesh=mesh,
                                  chunk=max(1, g.shape[0]))


def sharded_streaming_topk(queries, gallery, k: int = 100, mesh=None,
                           chunk: int | None = 65536, engine: str = "exact",
                           g_scales=None):
    """Sharded search with a streaming top-k per shard: peak memory per
    shard is ``O(Q * (k + chunk))`` whatever the shard's size.

    ``engine="int8"`` quantizes a float gallery per row first, or takes
    ``gallery`` as the ``[N, D]`` int8 array with its ``g_scales`` [N]
    (``quantize_gallery_int8``; ``cli.extract --quantize-int8`` writes
    them), the serving form.  Returns ``(scores [Q, k], ids [Q, k])``."""
    if engine not in ("exact", "int8"):
        raise ValueError(f"engine must be 'exact' or 'int8', got {engine!r}")
    mesh = default_search_mesh() if mesh is None else mesh
    g = _as_tensor(gallery)
    prequantized = g.dtype == torch.int8
    if prequantized and engine != "int8":
        raise ValueError("an int8 gallery requires engine='int8' "
                         "(dequantize it yourself for the exact engine)")
    if prequantized and g_scales is None:
        raise ValueError("an int8 gallery needs its g_scales "
                         "(from quantize_gallery_int8)")
    if engine == "int8" and not prequantized:
        g, g_scales = quantize_gallery_int8(g)
    elif engine != "int8":
        g, g_scales = g.to(torch.float32), None
    n_shards, _ = _shards(mesh)
    g_sh, s_sh, n = place_sharded_gallery(g, mesh, g_scales)
    shard_n = -(-n // n_shards)
    run = make_sharded_stream_fn(mesh, n, shard_n, k=k, chunk=chunk,
                                 engine=engine)
    with torch.no_grad():
        return run(queries, g_sh, s_sh)
