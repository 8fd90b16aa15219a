"""Open-loop HTTP load generator, run as a child process (standard library
only: it touches neither the device nor the program).

Protocol: one JSON line on standard input ``{"port", "path", "bodies":
[str], "schedule": [[due_s, body_index], ...], "workers", "timeout_s"}``;
the child answers ``ready`` on standard output, waits for a ``go`` line,
then sends each body at its due time (relative to ``go``) whether or not
earlier requests have finished, on a pool of worker threads with one
keep-alive connection each.  When every request has finished (or timed
out) it prints one JSON line: per request ``[index, body, due, sent,
done, status, reply]`` with times in seconds from ``go`` and the reply's
parsed JSON (``null`` for a failure).

    python3 perfbench/drivers/loadgen.py < request.json
"""

from __future__ import annotations

import http.client
import json
import queue
import sys
import threading
import time


def _worker(port: int, path: str, bodies, jobs: queue.Queue, out: list,
            t0: float, timeout: float):
    conn = None
    while True:
        job = jobs.get()
        if job is None:
            break
        i, j, due = job
        sent = time.perf_counter() - t0
        status, reply = 0, None
        for attempt in range(2):  # a dropped keep-alive connection: once more
            try:
                if conn is None:
                    conn = http.client.HTTPConnection("127.0.0.1", port,
                                                      timeout=timeout)
                conn.request("POST", path, body=bodies[j],
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                status = resp.status
                reply = json.loads(data) if status == 200 else None
                break
            except (OSError, http.client.HTTPException, ValueError):
                if conn is not None:
                    conn.close()
                conn = None
                status, reply = -1, None
        out[i] = [i, j, due, sent, time.perf_counter() - t0, status, reply]
    if conn is not None:
        conn.close()


def main() -> int:
    req = json.loads(sys.stdin.readline())
    bodies = [b.encode() for b in req["bodies"]]
    schedule = req["schedule"]
    out: list = [None] * len(schedule)
    jobs: queue.Queue = queue.Queue()
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        return 1
    t0 = time.perf_counter()
    threads = [threading.Thread(target=_worker, args=(
        req["port"], req["path"], bodies, jobs, out, t0, req["timeout_s"]))
        for _ in range(int(req["workers"]))]
    for t in threads:
        t.start()
    for i, (due, j) in enumerate(schedule):
        wait = t0 + due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        jobs.put((i, j, due))
    for _ in threads:
        jobs.put(None)
    for t in threads:
        t.join()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
