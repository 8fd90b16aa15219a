"""Streaming top-k engines over a device-resident gallery
(port of ``research_image_retrieval_tpu/ops/topk_stream.py``).

The serving path's replacement for a dense ``[Q, N]`` score matrix plus a
full sort: the gallery streams in chunks and only the running ``[Q, k]``
winners are carried.

* ``scan_streaming_topk`` — the exact engine: full fp32 scores (TF32 off),
  the semantics of the JAX engine run with ``exact_fp32_scores=True``,
  and the group-max pre-filtered exact selection.
* ``approx_streaming_topk`` — bf16 scores with fp32 accumulation, as the
  JAX engine.  Its selection is EXACT (``torch.topk``): the JAX engine's
  ``lax.approx_max_k`` has no torch counterpart (on the JAX CPU backend it
  is exact too).
* ``int8_streaming_topk`` — the quantized serving engine: a symmetric
  per-row int8 gallery (``quantize_gallery_int8``) scored as s8 x s8 ->
  s32 (``torch._int_mm``) and rescaled per pair, bit for bit the JAX
  arithmetic.

Chunking on CUDA.  Each chunk pays a fixed selection cost (three
``torch.topk`` at k = 100: group maxima, candidates, merge) that the
stream's bytes do not: on an NVIDIA H100 80GB HBM3 at 700 W the int8
engine at Q = 1 over 1.4M x 2048 took 7.94 ms in 11 chunks of 131072
rows, 4.37 ms in 6 and 1.87 ms in one (``chip_smoke.py`` phase 6,
PERF.md).  So the default chunk is the largest whose temporaries fit in
1 GiB: the ``[Q, chunk]`` s32 / fp32 score blocks (8 bytes per row and
query) and, for the float engines, the chunk's fp32 copy (4 D bytes per
row).  At Q <= 32 the int8 engine streams a 1.4M-row gallery in one
chunk and the float engines at D = 2048 in 12.  The CPU keeps a small
cache-friendly 4096.
"""

from __future__ import annotations

import torch

from research_image_retrieval_tpu_torch.utils.device import (
    fp32_precision,
    resolve_device,
)

__all__ = [
    "approx_streaming_topk",
    "int8_streaming_topk",
    "quantize_gallery_int8",
    "scan_streaming_topk",
    "streaming_topk",
]

_QUANT_BLOCK = 65536  # rows quantized at a time (bounds the fp32 temporaries)


def _default_chunk(n: int, device: torch.device, row_bytes: int) -> int:
    """Gallery rows per streamed chunk: on CUDA as many as keep the
    chunk's temporaries (``row_bytes`` per gallery row) within 1 GiB, in
    multiples of 1024 (see the module docstring); 4096 on the CPU."""
    if device.type != "cuda":
        return min(n, 4096)
    return min(n, max(1024, (2 ** 30 // row_bytes) // 1024 * 1024))


def _grouped_exact_select(scores: torch.Tensor, kk: int, group: int = 256):
    """Exact top-kk of each row via group-max pre-filtering.

    The top-kk elements lie inside the kk groups with the largest maxima
    (otherwise kk groups would each hold an element above one of them), so
    only those groups' members are sorted.
    """
    Q, C = scores.shape
    pad = (-C) % group
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=-torch.inf)
    ng = scores.shape[1] // group
    if ng <= kk:  # the pre-filter cannot prune anything
        return torch.topk(scores, kk, dim=1)
    g = scores.view(Q, ng, group)
    _, gi = torch.topk(g.amax(dim=2), kk, dim=1)                 # [Q, kk]
    cand = torch.gather(g, 1, gi[:, :, None].expand(Q, kk, group))
    s, ci = torch.topk(cand.reshape(Q, kk * group), kk, dim=1)
    grp = torch.gather(gi, 1, torch.div(ci, group, rounding_mode="floor"))
    return s, grp * group + ci % group


def _stream(n: int, Q: int, k: int, chunk: int, n_valid, device,
            score_fn, select_fn):
    """Shared driver: ``score_fn(base, end) -> [Q, end - base]`` fp32
    scores of one chunk; rows with id >= ``n_valid`` score -inf before
    ``select_fn(scores, kk)``; the running ``[Q, k]`` winners merge
    exactly.  Returns (scores [Q, k] fp32, ids [Q, k] int64)."""
    if n_valid is None:
        n_valid = n
    run_s = torch.full((Q, k), -torch.inf, dtype=torch.float32, device=device)
    run_i = torch.zeros((Q, k), dtype=torch.int64, device=device)
    for base in range(0, n, chunk):
        end = min(base + chunk, n)
        scores = score_fn(base, end)
        if end > n_valid:
            ids = torch.arange(base, end, device=device)
            scores = scores.masked_fill(ids[None, :] >= n_valid, -torch.inf)
        s, i = select_fn(scores, min(k, end - base))
        cand_s = torch.cat([run_s, s], dim=1)
        cand_i = torch.cat([run_i, i + base], dim=1)
        run_s, sel = torch.topk(cand_s, k, dim=1)
        run_i = torch.gather(cand_i, 1, sel)
    return run_s, torch.clamp(run_i, 0, n - 1)


def _selector(grouped: bool, group: int):
    if grouped:
        return lambda s, kk: _grouped_exact_select(s, kk, group=group)
    return lambda s, kk: torch.topk(s, kk, dim=1)


@fp32_precision()
def scan_streaming_topk(queries, gallery, k: int = 100,
                        chunk: int | None = 4096, n_valid: int | None = None,
                        grouped: bool = True, group: int = 256):
    """Exact top-k of ``queries @ gallery.T`` streamed over gallery chunks.

    Args:
      queries: [Q, D] tensor; gallery: [N, D] tensor (fp32 or bf16 store)
        on the same device; each chunk is scored in fp32.
      chunk: gallery rows per chunk; None picks the device's default.
      n_valid: rows with id >= n_valid score -inf (padding).
      grouped: group-max pre-filtered selection per chunk (exact), or a
        plain ``torch.topk`` per chunk.

    Returns:
      (scores [Q, k] fp32, ids [Q, k] int64), best first.
    """
    q = queries.to(torch.float32)
    n, d = gallery.shape
    if chunk is None:
        chunk = _default_chunk(n, q.device, 4 * d + 8 * q.shape[0])
    score = lambda b, e: q @ gallery[b:e].to(torch.float32).T
    return _stream(n, q.shape[0], k, chunk, n_valid, q.device, score,
                   _selector(grouped, group))


def approx_streaming_topk(queries, gallery, k: int = 100,
                          chunk: int | None = None):
    """Top-k of bf16 scores with fp32 accumulation, streamed over chunks.

    Queries and gallery are rounded to bf16 and multiplied in fp32: a
    product of two bf16 values is exact in fp32, so this is the JAX
    engine's ``bf16 x bf16 -> fp32`` contraction.  Selection is exact
    ``torch.topk`` per chunk: there is no torch ``approx_max_k``.
    """
    q = queries.to(torch.bfloat16).to(torch.float32)
    n, d = gallery.shape
    if chunk is None:
        chunk = _default_chunk(n, q.device, 4 * d + 8 * q.shape[0])
    score = lambda b, e: q @ gallery[b:e].to(torch.bfloat16).to(
        torch.float32).T
    return _stream(n, q.shape[0], k, chunk, None, q.device, score,
                   _selector(False, 0))


def quantize_gallery_int8(gallery):
    """Symmetric per-row int8 quantization of an L2-normalized gallery.

    Returns ``(q [N, D] int8, scales [N] fp32)`` on the input's device with
    ``q * scales[:, None] ~= gallery``: ``scale = max|g| / 127`` floored at
    1e-12, ``q = clip(round(g / scale), -127, 127)`` (round half to even),
    the JAX function's arithmetic.  Rows are quantized in blocks, so a
    gallery on the card needs only a block's fp32 temporaries.
    """
    g = torch.as_tensor(gallery)
    n, d = g.shape
    q = torch.empty((n, d), dtype=torch.int8, device=g.device)
    scale = torch.empty((n,), dtype=torch.float32, device=g.device)
    # a tensor divisor: CUDA turns division by a Python scalar into a
    # multiplication by its reciprocal, one ulp off IEEE division; made
    # by a fill on the device (a host copy would wait for the stream)
    d127 = torch.full((), 127.0, dtype=torch.float32, device=g.device)
    for b in range(0, n, _QUANT_BLOCK):
        blk = g[b:b + _QUANT_BLOCK].to(torch.float32)
        s = torch.clamp(blk.abs().amax(dim=1) / d127, min=1e-12)
        q[b:b + _QUANT_BLOCK] = torch.clamp(
            torch.round(blk / s[:, None]), -127, 127).to(torch.int8)
        scale[b:b + _QUANT_BLOCK] = s
    return q, scale


def _pad_to(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if x.shape == (rows, cols):
        return x
    out = torch.zeros((rows, cols), dtype=x.dtype, device=x.device)
    out[:x.shape[0], :x.shape[1]] = x
    return out


def int8_streaming_topk(queries, q_gallery, g_scales, k: int = 100,
                        chunk: int | None = None, n_valid: int | None = None,
                        group: int = 256, selection: str = "exact"):
    """Quantized streaming top-k over an int8 gallery.

    Queries are quantized per row with the gallery's scheme; each chunk is
    scored as s8 x s8 -> s32 (``torch._int_mm``) and rescaled as
    ``s32 * (q_scale[:, None] * g_scale[None, :])``, the two scales
    multiplied first as in the JAX engine, so scores agree bit for bit.

    ``torch._int_mm`` on CUDA needs more than 16 rows in A and K, N that
    are multiples of 8: query batches are zero-padded to at least 32 rows
    (and to a multiple of 8), D to a multiple of 8 on both sides, and a
    chunk whose row count is not a multiple of 8 to the next one; the
    padding scores 0 and is sliced or masked off.  The same padding runs
    on the CPU.

    Args:
      queries: [Q, D] float tensor on the gallery's device.
      q_gallery: [N, D] int8; g_scales: [N] fp32 (``quantize_gallery_int8``).
      n_valid: rows with id >= n_valid score -inf.
      selection: "exact" (group-max pre-filter: the true top-k of the
        quantized scores) or "approx" (a plain ``torch.topk`` per chunk,
        also exact: there is no torch ``approx_max_k``).

    Returns:
      (scores [Q, k] fp32, ids [Q, k] int64), best first.
    """
    if selection not in ("exact", "approx"):
        raise ValueError(f"selection must be 'exact' or 'approx', "
                         f"got {selection!r}")
    if q_gallery.dtype != torch.int8:
        raise TypeError(f"q_gallery must be int8, got {q_gallery.dtype}")
    n, d = q_gallery.shape
    dev = q_gallery.device
    q8, q_scale = quantize_gallery_int8(queries.to(torch.float32))
    Q = q8.shape[0]
    rows = max(32, -(-Q // 8) * 8)
    dp = -(-d // 8) * 8
    if chunk is None:
        chunk = _default_chunk(n, dev, 8 * rows)
    q8 = _pad_to(q8, rows, dp)
    g_scales = g_scales.to(torch.float32)

    def score(b, e):
        g = q_gallery[b:e]
        c = e - b
        g = _pad_to(g, -(-c // 8) * 8, dp)
        s32 = torch._int_mm(q8, g.T)[:Q, :c]
        return s32.to(torch.float32) * (q_scale[:, None]
                                        * g_scales[None, b:e])

    return _stream(n, Q, k, chunk, n_valid, dev, score,
                   _selector(selection == "exact", group))


def streaming_topk(queries, gallery, k: int = 100, chunk: int | None = None,
                   exact: bool = True, device="cuda"):
    """Serving entry point: streamed top-k on ``device``.

    ``exact=True`` is the fp32 exact engine, ``False`` the approx engine
    (bf16 scores).  Accepts numpy arrays or tensors; returns numpy
    ``(scores, ids)``.
    """
    dev = resolve_device(device)
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    g = torch.as_tensor(gallery, dtype=torch.float32, device=dev)
    with torch.no_grad():
        if exact:
            s, i = scan_streaming_topk(q, g, k=k, chunk=chunk)
        else:
            s, i = approx_streaming_topk(q, g, k=k, chunk=chunk)
    return s.cpu().numpy(), i.cpu().numpy()
