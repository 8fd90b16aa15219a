"""The port's search engines and ``SearchService`` on the card, against
the port's own CPU results.

Every test needs an NVIDIA GPU and skips without one.  This file imports
no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda_serve.py -q

Tolerances: the int8 engine's s8 x s8 -> s32 sums are exact on both
devices and the rescale is the same fp32 product, so its scores are
equal (0 ulp) and its ids equal wherever scores are distinct; the
quantizer is equal to the bit; the fp32 and bf16-score engines sum in
another order on cuBLAS, within 1e-5.
"""

import numpy as np
import pytest
import torch

from research_image_retrieval_tpu_torch.ops import topk_stream
from research_image_retrieval_tpu_torch.serve import SearchService

pytestmark = pytest.mark.cuda


@pytest.fixture()
def rng():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return np.random.default_rng(0)


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _ids_where_distinct(ids, want_ids, scores, tol=1e-6):
    gap = np.abs(np.diff(scores, axis=1))
    distinct = np.ones_like(scores, bool)
    distinct[:, 1:] &= gap > tol
    distinct[:, :-1] &= gap > tol
    np.testing.assert_array_equal(ids[distinct], want_ids[distinct])


def _int8(q, g, device, **kw):
    qg, gs = topk_stream.quantize_gallery_int8(
        torch.from_numpy(g).to(device))
    s, i = topk_stream.int8_streaming_topk(torch.from_numpy(q).to(device),
                                           qg, gs, **kw)
    return qg.cpu().numpy(), gs.cpu().numpy(), s.cpu().numpy(), \
        i.cpu().numpy()


@pytest.mark.parametrize("nq", [1, 2, 16, 17, 24, 32])
@pytest.mark.parametrize("n,d,chunk", [(5000, 2048, 1024), (1001, 64, 300),
                                       (700, 44, 256)])
def test_int8_engine_cuda_equals_cpu(rng, nq, n, d, chunk):
    """Query batches of 1-16 rows (padded for ``torch._int_mm``), a
    ragged last chunk and D not a multiple of 8."""
    q, g = _unit(rng, nq, d), _unit(rng, n, d)
    gq, gs_, s, i = _int8(q, g, "cuda", k=20, chunk=chunk)
    wq, ws_, ws, wi = _int8(q, g, "cpu", k=20, chunk=chunk)
    np.testing.assert_array_equal(gq, wq)
    np.testing.assert_array_equal(gs_, ws_)
    np.testing.assert_array_equal(s, ws)
    _ids_where_distinct(i, wi, s)


@pytest.mark.parametrize("engine", ["exact", "approx"])
def test_float_engines_cuda_match_cpu(rng, engine):
    q, g = _unit(rng, 8, 256), _unit(rng, 3000, 256)
    fn = (topk_stream.scan_streaming_topk if engine == "exact"
          else topk_stream.approx_streaming_topk)
    s, i = fn(torch.from_numpy(q).cuda(), torch.from_numpy(g).cuda(), k=30,
              chunk=1024)
    ws, wi = fn(torch.from_numpy(q), torch.from_numpy(g), k=30, chunk=1024)
    np.testing.assert_allclose(s.cpu().numpy(), ws.numpy(), atol=1e-5)
    _ids_where_distinct(i.cpu().numpy(), wi.numpy(), ws.numpy(), tol=1e-5)


@pytest.mark.parametrize("engine", ["int8", "exact", "approx"])
def test_service_on_cuda_tensors(rng, engine):
    """A gallery made on the card is served without a host copy (the bf16
    store is the caller's tensor) and answers as one direct engine call
    on the same device; requests from threads are answered."""
    import threading

    g = torch.from_numpy(_unit(rng, 4000, 128)).cuda().to(torch.bfloat16)
    q = g[:7].float()
    if engine == "int8":
        qg, gs = topk_stream.quantize_gallery_int8(g)
        ref = topk_stream.int8_streaming_topk(q, qg, gs, k=9)
    elif engine == "approx":
        ref = topk_stream.approx_streaming_topk(q, g, k=9)
    else:
        ref = topk_stream.scan_streaming_topk(q, g, k=9)
    with SearchService(g, engine=engine, k=9, max_batch=4) as svc:
        if engine != "int8":
            assert svc._gallery.data_ptr() == g.data_ptr()
        s, i = svc.search(q.cpu().numpy())
        out = {}
        threads = [threading.Thread(
            target=lambda r=r: out.__setitem__(r, svc.search(
                q[r].cpu().numpy(), k=1)[1][0, 0])) for r in range(7)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    # cuBLAS may pick another float kernel for the service's 4-row
    # buckets than for 7 rows: float scores within 1e-5, int8 equal
    np.testing.assert_allclose(s, ref[0].cpu().numpy(), rtol=0,
                               atol=0 if engine == "int8" else 1e-5)
    _ids_where_distinct(i, ref[1].cpu().numpy(), s, tol=1e-5)
    assert out == {r: int(ref[1][r, 0]) for r in range(7)}
