"""Stdlib HTTP front end for :class:`SearchService`
(port of ``research_image_retrieval_tpu/serve/http.py``).

Endpoints (JSON in/out, no dependencies beyond the standard library):

* ``GET  /healthz`` — liveness + index summary.
* ``GET  /stats``   — request counters, latency percentiles, and the
  summed queue waits and engine time (``queue_wait_ms_total``,
  ``engine_ms_total``).
* ``POST /search``  — ``{"vectors": [[...], ...], "k": 10}`` ->
  ``{"results": [{"matches": [{"index", "name", "score"}, ...]}]}``.
* ``POST /search/image`` — ``{"images_b64": ["<jpeg/png base64>", ...],
  "k": 10}``; available when the server was started with a model
  (``cli.serve --model ... [--checkpoint ...]``).  Images are decoded
  (the native prescaled JPEG decoder where it builds), thumbnailed to the
  model's imsize, extracted, and searched in one round trip; the decode
  runs under the span ``serve.decode`` (``utils.profiling.span``).

``ThreadingHTTPServer`` handles each request on its own thread; the
service's micro-batching worker coalesces concurrent /search bodies into
single engine calls.
"""

from __future__ import annotations

import base64
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

# the bytes twin of ``data.eval_loader.load_image``: same decoder order
from research_image_retrieval_tpu_torch.data.native_decode import (
    decode_image as decode_image_bytes,
)
from research_image_retrieval_tpu_torch.utils.profiling import span

__all__ = ["decode_image_bytes", "make_http_server"]


def _results_json(service, scores, indices):
    names = service.match_names(indices)
    return {
        "results": [
            {
                "matches": [
                    {"index": int(indices[q, j]),
                     "name": str(names[q, j]),
                     "score": float(scores[q, j])}
                    for j in range(indices.shape[1])
                ]
            }
            for q in range(indices.shape[0])
        ]
    }


class _Handler(BaseHTTPRequestHandler):
    server_version = "rir-serve/1.0"
    protocol_version = "HTTP/1.1"

    # ------------------------------------------------------------- plumbing
    def _reply(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self) -> dict:
        # Keep-alive safety: replying before the request body is consumed
        # leaves body bytes in the socket and desyncs the next pipelined
        # request, so any path that cannot (or does not) drain the body
        # must drop the connection.
        if self.headers.get("Transfer-Encoding", "").lower() == "chunked":
            self.close_connection = True
            raise ValueError("chunked transfer-encoding is not supported; "
                             "send Content-Length")
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self.close_connection = True
            raise ValueError("bad Content-Length header")
        if length <= 0:
            self.close_connection = True
            raise ValueError("empty request body")
        body = self.rfile.read(length)
        if len(body) < length:  # client hung up mid-body
            self.close_connection = True
            raise ValueError("truncated request body")
        return json.loads(body)

    def log_message(self, fmt, *args):  # quiet by default
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    # ------------------------------------------------------------ endpoints
    def do_GET(self):
        service = self.server.service
        if self.path == "/healthz":
            self._reply(200, {
                "status": "ok",
                "engine": service.engine,
                "gallery_size": service.n_gallery,
                "dim": service.dim,
                "k": service.k,
                "image_search": self.server.extractor is not None,
            })
        elif self.path == "/stats":
            self._reply(200, service.stats())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        service = self.server.service
        try:
            body = self._read_json()
        except (ValueError, json.JSONDecodeError) as e:
            return self._reply(400, {"error": f"bad JSON body: {e}"})
        try:
            k = body.get("k")
            if k is not None:
                try:
                    k = int(k)
                except (TypeError, ValueError):
                    return self._reply(
                        400, {"error": f"k must be an integer, got {k!r}"})
            if self.path == "/search":
                if "vectors" not in body:
                    return self._reply(
                        400, {"error": "need vectors: [[...], ...] "
                                       "(a list of descriptor rows)"})
                try:
                    vecs = np.asarray(body["vectors"], np.float32)
                except (TypeError, ValueError):
                    return self._reply(
                        400, {"error": "vectors must be a rectangular "
                                       "numeric array [[...], ...]"})
                scores, idx = service.search(vecs, k=k)
                return self._reply(200, _results_json(service, scores, idx))
            if self.path == "/search/image":
                extractor = self.server.extractor
                if extractor is None:
                    return self._reply(
                        400, {"error": "server started without --model; "
                                       "image search is disabled"})
                b64s = body.get("images_b64")
                if b64s is None and "image_b64" in body:
                    b64s = [body["image_b64"]]
                if not b64s:
                    return self._reply(
                        400, {"error": "need images_b64 (list) or image_b64"})
                with span("serve.decode"):
                    images = [
                        decode_image_bytes(base64.b64decode(s),
                                           max_side=extractor.imsize)
                        for s in b64s
                    ]
                vecs = extractor(images)
                scores, idx = service.search(vecs, k=k)
                return self._reply(200, _results_json(service, scores, idx))
            return self._reply(404, {"error": f"unknown path {self.path}"})
        except (KeyError, ValueError) as e:
            return self._reply(400, {"error": str(e)})
        except Exception as e:  # the server keeps running: report a 500
            return self._reply(500, {"error": f"{type(e).__name__}: {e}"})


def make_http_server(service, host: str = "127.0.0.1", port: int = 8080,
                     extractor=None, verbose: bool = False):
    """Build (not start) a ``ThreadingHTTPServer`` bound to the service.
    Call ``.serve_forever()`` to run, ``.shutdown()`` to stop."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.service = service
    server.extractor = extractor
    server.verbose = verbose
    return server
