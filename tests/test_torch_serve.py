"""PyTorch port, the serving layer on the CPU: ``SearchService``
micro-batching and the HTTP front end, mirroring ``tests/test_serve.py``
(its sharded cases are in ``tests/test_torch_parallel.py``).

Tolerances: the service returns what one direct engine call returns, ids
equal and scores within 1e-6; the int8 index written in the JAX
``rir-extract`` layout serves the JAX engine's ids.
"""

import base64
import json
import socket
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_image_retrieval_tpu.ops import topk_stream as jtopk
from research_image_retrieval_tpu_torch.models import get_model, seeded_init
from research_image_retrieval_tpu_torch.ops import topk_stream
from research_image_retrieval_tpu_torch.serve import (
    ImageExtractor,
    SearchService,
    make_http_server,
)
from research_image_retrieval_tpu_torch.serve.service import _next_pow2
from test_torch_model import few_torch_threads  # noqa: F401


def _unit_rows(rng, n, d):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def gallery():
    return _unit_rows(np.random.default_rng(0), 512, 32)


CPU = dict(device="cpu")


def test_next_pow2():
    assert [_next_pow2(n) for n in (1, 2, 3, 5, 32, 33)] == \
        [1, 2, 4, 8, 32, 64]


@pytest.mark.parametrize("engine", ["exact", "approx", "int8"])
@pytest.mark.parametrize("store_dtype", ["float32", "bfloat16"])
def test_service_self_retrieval(gallery, engine, store_dtype):
    with SearchService(gallery, engine=engine, k=5, max_batch=8,
                       store_dtype=store_dtype, **CPU) as svc:
        scores, idx = svc.search(gallery[17:21], k=3)
        assert scores.shape == (4, 3) and idx.shape == (4, 3)
        assert idx.dtype == np.int32 and scores.dtype == np.float32
        assert list(idx[:, 0]) == [17, 18, 19, 20]
        assert np.all(scores[:, 0] >= scores[:, 1] - 1e-6)


@pytest.mark.parametrize("engine", ["exact", "approx", "int8"])
def test_service_matches_engine_directly(gallery, engine):
    """The batching path returns exactly what one direct engine call
    does, however requests were split and padded (n=7 > max_batch=4)."""
    q, g = torch.from_numpy(gallery[:7]), torch.from_numpy(gallery)
    if engine == "int8":
        qg, gs = topk_stream.quantize_gallery_int8(g)
        ref_s, ref_i = topk_stream.int8_streaming_topk(q, qg, gs, k=9)
    elif engine == "approx":
        ref_s, ref_i = topk_stream.approx_streaming_topk(q, g, k=9)
    else:
        ref_s, ref_i = topk_stream.scan_streaming_topk(q, g, k=9)
    with SearchService(gallery, engine=engine, k=9, max_batch=4,
                       store_dtype="float32", **CPU) as svc:
        s, i = svc.search(gallery[:7])
        assert svc.stats()["engine_calls"] == 2
    np.testing.assert_array_equal(i, ref_i.numpy())
    np.testing.assert_allclose(s, ref_s.numpy(), rtol=0, atol=1e-6)


def test_service_gallery_tensor_not_copied(gallery):
    """A gallery passed as a tensor already on the device in the store
    dtype is served as it is (no host round trip, no copy)."""
    g = torch.from_numpy(gallery)
    with SearchService(g, engine="exact", k=3, store_dtype="float32",
                       **CPU) as svc:
        assert svc._gallery.data_ptr() == g.data_ptr()
        _, idx = svc.search(gallery[40])
        assert idx[0, 0] == 40


def test_service_concurrent_requests_coalesce(gallery):
    with SearchService(gallery, engine="exact", k=4, max_batch=16,
                       window_ms=50.0, store_dtype="float32", **CPU) as svc:
        svc.warmup()
        assert svc.stats()["compiled_buckets"] == [1, 2, 4, 8, 16]
        results, errs = {}, []

        def one(qi):
            try:
                _, idx = svc.search(gallery[qi], k=1)
                results[qi] = int(idx[0, 0])
            except Exception as e:  # surface failures in the main thread
                errs.append(e)

        threads = [threading.Thread(target=one, args=(qi,))
                   for qi in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errs
        assert results == {qi: qi for qi in range(12)}
        st = svc.stats()
        assert st["requests"] == 12 and st["queries"] == 12
        # with a 50 ms window most requests coalesce (timing: no count)
        assert 1 <= st["engine_calls"] <= 12
        assert st["coalesced_batches"] <= 12
        assert st["latency_ms"]["p50"] >= 0.0


def test_service_from_npz_jax_layout(tmp_path, gallery):
    """An index in the JAX ``rir-extract --quantize-int8`` layout (its
    quantizer, ``vecs_int8`` / ``scales`` / ``names``) serves the JAX int8
    engine's ids; the same file serves a float engine dequantized."""
    qg, scales = jtopk.quantize_gallery_int8(jnp.asarray(gallery))
    path = tmp_path / "idx.npz"
    names = np.asarray([f"img{i}" for i in range(len(gallery))])
    np.savez(path, vecs_int8=np.asarray(qg), scales=np.asarray(scales),
             names=names)
    ws, wi = map(np.asarray, jtopk.int8_streaming_topk(
        jnp.asarray(gallery[:6]), qg, scales, k=3))
    with SearchService.from_npz(str(path), k=3, max_batch=4, **CPU) as svc:
        assert svc.engine == "int8"
        s, idx = svc.search(gallery[:6])
        assert svc.match_names(idx)[5, 0] == "img5"
    np.testing.assert_array_equal(idx, wi)
    np.testing.assert_allclose(s, ws, rtol=1e-6)
    with SearchService.from_npz(str(path), engine="exact", k=3,
                                store_dtype="float32", **CPU) as svc:
        _, idx = svc.search(gallery[9])
        assert idx[0, 0] == 9
    plain = tmp_path / "float.npz"
    np.savez(plain, vecs=gallery, names=names)
    with SearchService.from_npz(str(plain), k=2, **CPU) as svc:
        assert svc.engine == "exact" and svc.search(gallery[3])[1][0, 0] == 3


def test_service_input_validation(gallery):
    with SearchService(gallery, k=5, store_dtype="float32", **CPU) as svc:
        with pytest.raises(ValueError):
            svc.search(np.zeros((2, 7), np.float32))  # wrong dim
        with pytest.raises(ValueError):
            svc.search(gallery[0], k=6)  # k above the server-wide max
        with pytest.raises(ValueError):
            svc.search(gallery[0], k=0)
    with pytest.raises(RuntimeError):
        svc.search(gallery[0])  # closed
    with pytest.raises(ValueError, match="engine"):
        SearchService(gallery, engine="nope", **CPU)
    with pytest.raises(ValueError, match="selection"):
        SearchService(gallery, engine="int8", selection="nope", **CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            SearchService(gallery)  # device defaults to the card


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _post(url, payload, raw=None):
    req = urllib.request.Request(
        url, data=raw if raw is not None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve(svc, extractor=None):
    server = make_http_server(svc, port=_free_port(), extractor=extractor)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, t, f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server, t, svc):
    server.shutdown()
    server.server_close()
    t.join(timeout=10)
    svc.close()
    assert not t.is_alive()


def test_http_endpoints(gallery):
    names = np.asarray([f"g{i}" for i in range(len(gallery))])
    svc = SearchService(gallery, names=names, engine="int8", k=10,
                        max_batch=8, **CPU)
    server, t, url = _serve(svc)
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["engine"] == "int8"
        assert health["gallery_size"] == 512
        assert health["image_search"] is False

        code, out = _post(url + "/search",
                          {"vectors": gallery[3:5].tolist(), "k": 2})
        assert code == 200
        assert [m["matches"][0]["index"] for m in out["results"]] == [3, 4]
        assert out["results"][0]["matches"][0]["name"] == "g3"
        assert out["results"][0]["matches"][0]["score"] == pytest.approx(
            1.0, abs=1e-2)

        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["requests"] >= 1 and stats["queries"] >= 2

        # error surfaces: bad dim / k / body -> 400, bad path -> 404
        assert _post(url + "/search", {"vectors": [[0.0, 1.0]]})[0] == 400
        assert _post(url + "/search", {"vectors": gallery[:1].tolist(),
                                       "k": "x"})[0] == 400
        assert _post(url + "/search", {"k": 1})[0] == 400
        assert _post(url + "/search", None, raw=b"{not json")[0] == 400
        assert _post(url + "/nope", {"x": 1})[0] == 404
        code, out = _post(url + "/search/image", {"image_b64": "aGk="})
        assert code == 400 and "without --model" in out["error"]
        try:
            urllib.request.urlopen(url + "/missing", timeout=30)
            raise AssertionError("GET /missing answered 200")
        except urllib.error.HTTPError as e:
            assert e.code == 404
    finally:
        _stop(server, t, svc)


def test_http_image_search(tmp_path):
    """Images -> ImageExtractor (gem_r50 at 64 px, seeded weights from a
    ``.pt`` checkpoint) -> gallery -> HTTP image query retrieves itself
    through a JPEG round trip; the extractor is deterministic."""
    import cv2

    model = get_model("gem_r50", num_classes=8)
    seeded_init(model, seed=5)
    ckpt = tmp_path / "gem.pt"
    torch.save(model.state_dict(), ckpt)
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 255, (48 + 8 * i, 56, 3), np.uint8)
            for i in range(3)]
    extractor = ImageExtractor("gem_r50", checkpoint=str(ckpt), imsize=64,
                               batch_size=2, **CPU)
    vecs = extractor(imgs)
    assert vecs.shape == (3, 2048)
    np.testing.assert_allclose(np.linalg.norm(vecs, axis=1), 1.0, atol=1e-4)
    np.testing.assert_array_equal(extractor(imgs[1:2]), vecs[1:2])

    svc = SearchService(vecs, engine="exact", k=3, store_dtype="float32",
                        **CPU)
    server, t, url = _serve(svc, extractor)
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["image_search"] is True
        ok, buf = cv2.imencode(
            ".jpg", cv2.cvtColor(imgs[1], cv2.COLOR_RGB2BGR),
            [cv2.IMWRITE_JPEG_QUALITY, 98])
        assert ok
        code, out = _post(url + "/search/image", {
            "images_b64": [base64.b64encode(buf.tobytes()).decode()],
            "k": 1})
        assert code == 200
        assert out["results"][0]["matches"][0]["index"] == 1
    finally:
        _stop(server, t, svc)


def test_cli_serve_parser():
    from research_image_retrieval_tpu_torch.cli.serve import build_parser

    args = build_parser().parse_args(
        ["--gallery", "g.npz", "--engine", "int8", "--port", "1234",
         "--max-batch", "5"])
    assert args.engine == "int8" and args.port == 1234
    assert args.max_batch == 5  # rounded to 8 inside the service
    assert args.device == "cuda" and args.store_dtype == "bfloat16"
    args = build_parser().parse_args(["--gallery", "g.npz", "--device",
                                      "cpu", "--selection", "approx"])
    assert args.device == "cpu" and args.selection == "approx"
    assert args.sharded is False
    args = build_parser().parse_args(["--gallery", "g.npz", "--sharded"])
    assert args.sharded is True
