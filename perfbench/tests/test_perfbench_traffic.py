"""Open-loop scheduling, due-time latency and percentiles over all
requests."""

import json
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from perfbench.drivers import serve_image
from perfbench.drivers.serve_image import LOADGEN, schedule
from perfbench.trace import percentile, union_s


def test_percentile_is_nearest_rank_over_all_values():
    v = list(range(1, 101))
    assert percentile(v, 95) == 95
    assert percentile(v, 50) == 50
    assert percentile([3.0], 95) == 3.0
    # a failure counts as missing: it sits above every latency
    assert percentile([1.0] * 94 + [float("inf")] * 6, 95) == float("inf")
    assert percentile([1.0] * 95 + [float("inf")] * 5, 95) == 1.0


def test_union_of_intervals():
    assert union_s([(0, 10), (5, 20), (30, 40)]) == pytest.approx(30e-6)


def test_schedule_is_open_loop_and_the_same_work_for_every_seed():
    a = schedule(120, 2.4, 50.0, 64, seed=1)
    b = schedule(120, 2.4, 50.0, 64, seed=2)
    due_a = [d for d, _ in a]
    assert len(a) == 120 and due_a == sorted(due_a)
    assert due_a[0] == 0.0 and due_a[-1] < 50.0
    # the same gaps in another order
    gaps = lambda s: sorted(np.diff([d for d, _ in s] + [50.0]))
    assert np.allclose(gaps(a), gaps(b))
    assert [d for d, _ in a] != [d for d, _ in b]
    # every pool image as often as any other, up to one
    counts = np.bincount([j for _, j in a], minlength=64)
    assert counts.max() - counts.min() <= 1


def test_pool_sizes_do_not_depend_on_the_seed():
    mix = {"phones": 4, "phone": [1200, 1600], "crops": 4, "crop_min": 300,
           "crop_max": 1024}
    sizes = serve_image.pool_sizes(mix)
    assert sizes[:2] == [(1200, 1600), (1600, 1200)]
    assert all(300 <= s <= 1024 for hw in sizes[4:] for s in hw)


class _Slow(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    lock = threading.Lock()

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        with self.lock:           # one request at a time: a queue builds
            time.sleep(0.2)
        body = json.dumps({"ok": True}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_loadgen_times_each_request_from_its_due_time():
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Slow)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        sched = [[0.0, 0], [0.01, 0], [0.02, 0], [0.03, 0]]
        proc = subprocess.Popen([sys.executable, str(LOADGEN)],
                                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                text=True)
        proc.stdin.write(json.dumps({
            "port": server.server_address[1], "path": "/x",
            "bodies": ["{}"], "schedule": sched, "workers": 8,
            "timeout_s": 30}) + "\n")
        proc.stdin.flush()
        assert proc.stdout.readline().strip() == "ready"
        proc.stdin.write("go\n")
        proc.stdin.flush()
        out = json.loads(proc.stdout.readline())
        proc.stdin.close()
        assert proc.wait(timeout=30) == 0
    finally:
        server.shutdown()
        server.server_close()
    # sent on schedule whatever the server did (open loop), and the
    # served one after another: the last waited for the three before it
    assert all(r[5] == 200 for r in out)
    assert max(r[3] - r[2] for r in out) < 0.1
    lat = sorted(r[4] - r[2] for r in out)
    assert lat[0] == pytest.approx(0.2, abs=0.1)
    assert lat[-1] >= 0.7
