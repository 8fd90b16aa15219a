"""PyTorch port, the int8 and approx streaming top-k engines on the CPU,
against the JAX package's engines on the same numpy inputs.

Tolerances:
* ``quantize_gallery_int8``: int8 values and fp32 scales equal (0 ulp):
  the same fp32 division, half-to-even rounding and clip.
* int8 engine: ids equal where scores differ by more than 1e-6 (tie order
  is free in a top-k), scores within rtol 1e-6, the bar of
  ``tests/test_topk_int8.py`` (the s32 sums and the rescale are the same
  fp32 operations, so they agree to the bit in practice).
* approx engine: bf16-rounded operands multiplied in fp32 on both sides;
  ids equal where scores differ by more than 1e-6, scores within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_image_retrieval_tpu.ops import topk_stream as jtopk
from research_image_retrieval_tpu_torch.ops import topk_stream
from test_torch_model import few_torch_threads  # noqa: F401


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _ids_where_distinct(ids, want_ids, scores, tol=1e-6):
    gap = np.abs(np.diff(scores, axis=1))
    distinct = np.ones_like(scores, bool)
    distinct[:, 1:] &= gap > tol
    distinct[:, :-1] &= gap > tol
    np.testing.assert_array_equal(ids[distinct], want_ids[distinct])
    return distinct


def _port_int8(q, g, **kw):
    qg, gs = topk_stream.quantize_gallery_int8(torch.from_numpy(g))
    s, i = topk_stream.int8_streaming_topk(torch.from_numpy(q), qg, gs, **kw)
    return s.numpy(), i.numpy()


def _jax_int8(q, g, **kw):
    qg, gs = jtopk.quantize_gallery_int8(jnp.asarray(g))
    s, i = jtopk.int8_streaming_topk(jnp.asarray(q), qg, gs, **kw)
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize("n,d", [(257, 96), (300, 44), (65600, 8)])
def test_quantize_matches_jax_exactly(rng, n, d):
    """Equal int8 values and scales; a zero row floors its scale at 1e-12;
    65600 rows cross the port's 65536-row quantization block."""
    g = _unit(rng, n, d)
    g[3] = 0.0
    g[5] *= 1e-3  # a short row: scale well below the others'
    q, s = topk_stream.quantize_gallery_int8(torch.from_numpy(g))
    wq, ws = jtopk.quantize_gallery_int8(jnp.asarray(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    assert (q[3] == 0).all() and float(s[3]) == np.float32(1e-12)


def test_int8_integer_data_bit_exact(rng):
    """Integer rows with max 127 quantize to themselves (scale 1), so the
    s32 sums reach 40 * 127^2 and the scores equal the dense products."""
    g = rng.integers(-127, 128, size=(900, 40)).astype(np.float32)
    q = rng.integers(-127, 128, size=(5, 40)).astype(np.float32)
    g[:, 0] = q[:, 0] = 127.0
    s, i = _port_int8(q, g, k=20, chunk=256)
    ws, wi = _jax_int8(q, g, k=20, chunk=256)
    np.testing.assert_allclose(s, ws, rtol=1e-6)
    dense = q @ g.T
    np.testing.assert_array_equal(np.take_along_axis(dense, i, axis=1), s)
    _ids_where_distinct(i, wi, s)


@pytest.mark.parametrize("case", ["unit", "n_valid", "ragged_chunk",
                                  "approx_selection", "prefilter",
                                  "odd_dim"])
def test_int8_engine_matches_jax(rng, case):
    """Unit rows: ids and scores of the JAX int8 engine, with padding rows
    masked (``n_valid``), a chunk that does not divide N, the approx
    selector, the group pre-filter pruning (chunk / group > k), and D not
    a multiple of 8 (the port pads it for ``torch._int_mm``)."""
    d = 44 if case == "odd_dim" else 64
    q, g = _unit(rng, 6, d), _unit(rng, 1001, d)
    kw = dict(k=10, chunk=256)
    if case == "n_valid":
        g[900:] = q[0]  # would win query 0 if not masked
        kw["n_valid"] = 900
    elif case == "ragged_chunk":
        kw["chunk"] = 300
    elif case == "approx_selection":
        kw["selection"] = "approx"
    elif case == "prefilter":
        kw.update(chunk=512, group=16)
    s, i = _port_int8(q, g, **kw)
    ws, wi = _jax_int8(q, g, **kw)
    np.testing.assert_allclose(s, ws, rtol=1e-6)
    assert _ids_where_distinct(i, wi, s).mean() > 0.9
    if case == "n_valid":
        assert int(i.max()) < 900


@pytest.mark.parametrize("nq", [1, 5, 16, 17, 33])
def test_int8_query_rows_padded(rng, nq):
    """Batches of 1-16 queries are padded to 32 rows (``torch._int_mm``
    on CUDA needs more than 16) and batches not a multiple of 8 to the
    next multiple; the result is the unpadded one."""
    q, g = _unit(rng, nq, 32), _unit(rng, 200, 32)
    s, i = _port_int8(q, g, k=5, chunk=64)
    ws, wi = _jax_int8(q, g, k=5, chunk=64)
    assert s.shape == (nq, 5)
    np.testing.assert_allclose(s, ws, rtol=1e-6)
    _ids_where_distinct(i, wi, s)


def test_int8_self_retrieval_and_recall(rng):
    g = _unit(rng, 4096, 128)
    s, i = _port_int8(g[:32], g, k=10, chunk=1024)
    assert (i[:, 0] == np.arange(32)).all()
    q = _unit(rng, 9, 128)
    _, i8 = _port_int8(q, g, k=10, chunk=1024)
    _, ie = topk_stream.scan_streaming_topk(torch.from_numpy(q),
                                            torch.from_numpy(g), k=10,
                                            chunk=1024)
    recall = np.mean([len(set(a) & set(b)) / 10
                      for a, b in zip(i8, ie.numpy())])
    assert recall >= 0.9, recall


def test_int8_bad_selection_raises(rng):
    qg, gs = topk_stream.quantize_gallery_int8(
        torch.from_numpy(_unit(rng, 64, 32)))
    with pytest.raises(ValueError, match="selection"):
        topk_stream.int8_streaming_topk(
            torch.from_numpy(_unit(rng, 2, 32)), qg, gs, k=4,
            selection="nope")
    with pytest.raises(TypeError, match="int8"):
        topk_stream.int8_streaming_topk(
            torch.from_numpy(_unit(rng, 2, 32)), qg.float(), gs, k=4)


@pytest.mark.parametrize("chunk", [256, 1000])
def test_approx_engine_matches_jax(rng, chunk):
    """bf16 scores with fp32 accumulation; JAX's ``approx_max_k`` is exact
    on its CPU backend and the port's selection is exact everywhere."""
    q, g = _unit(rng, 5, 64), _unit(rng, 1000, 64)
    ws, wi = map(np.asarray, jtopk.approx_streaming_topk(
        jnp.asarray(q), jnp.asarray(g), k=20, chunk=chunk))
    s, i = topk_stream.approx_streaming_topk(torch.from_numpy(q),
                                             torch.from_numpy(g), k=20,
                                             chunk=chunk)
    np.testing.assert_allclose(s.numpy(), ws, rtol=1e-5, atol=1e-5)
    _ids_where_distinct(i.numpy(), wi, s.numpy())
    # the entry point's exact=False is this engine
    ss, si = topk_stream.streaming_topk(q, g, k=20, chunk=chunk, exact=False,
                                        device="cpu")
    np.testing.assert_array_equal(ss, s.numpy())
    np.testing.assert_array_equal(si, i.numpy())


def test_streaming_topk_entry_rejects_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        topk_stream.streaming_topk(np.zeros((1, 8), np.float32),
                                   np.zeros((4, 8), np.float32), k=2)
