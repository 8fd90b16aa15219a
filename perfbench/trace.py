"""The traced stretch of a window, and what the per-layer readers read.

With ``--trace 1`` a driver profiles one steady stretch of its window
with ``torch.profiler`` (CPU and CUDA activity): the device is
synchronized, the profiler started, the window goes on, and after the
stretch the device is synchronized again and the profiler stopped.
``Stretch.summary`` reduces the trace to:

* ``busy_s``: the union of the intervals in which any device operation
  (kernel, copy, memset) ran, and ``window_s``, the stretch's length on
  the host clock, so ``1 - busy_s / window_s`` is the device's idle share;
* ``spans``: for each ``record_function`` label that starts with
  ``perfbench.``, its count, its host time and the device time of the
  kernels that ran inside the device intervals the profiler marks for
  its spans (the kernels they launched, on a device that runs one
  stream of kernels at a time; copies are left out);
* ``device_ops``: device time by operation name, largest first;
* ``idle_gaps``: the device's idle time inside the stretch, by the
  innermost host operation or span running when each gap began.
"""

from __future__ import annotations

import time

__all__ = ["Stretch", "idle_share_pct", "percentile", "union_s"]


def union_s(intervals) -> float:
    """Length of the union of ``(start, end)`` microsecond intervals, in s
    (the union of kernel intervals, as ``chip_smoke.py``'s ``_union_ms``)."""
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (``q`` in 0-100) of all ``values``: the
    smallest value with at least ``q`` percent of them at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    rank = max(1, -(-len(v) * q // 100))
    return float(v[int(rank) - 1])


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Stretch:
    """One profiled stretch (see the module docstring).  ``start`` and
    ``stop`` may be called from any thread of the run; the profiler
    records host operations of every thread."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0 = self.t1 = None

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prepare(self) -> None:
        """Profile a moment of set-up and drop it: the profiler's first
        session initializes its device tracing (seconds, on the first
        kernel it sees), which must not fall into the window."""
        import torch

        self.start()
        torch.ones(1, device=self.device).add_(1)
        self._sync()
        self.prof.stop()
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def run_for(self, seconds: float) -> None:
        """Start, let the window go on for ``seconds``, stop (for a
        thread of its own)."""
        self.start()
        time.sleep(seconds)
        self.stop()

    def summary(self, top: int = 10) -> dict:
        from torch.autograd import DeviceType

        events = self.prof.events()
        dev, host = [], []
        for e in events:
            r = (e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CPU:
                host.append((r[0], r[1], e.name, e))
            else:
                dev.append((r[0], r[1], e.name))
        # the device-side annotations that mirror record_function spans
        # are not operations: each marks the device interval of the
        # kernels launched inside its span
        notes = [d for d in dev if d[2].startswith("perfbench.")]
        ops = [d for d in dev if not d[2].startswith("perfbench.")]
        by_name: dict = {}
        for a, b, name in ops:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        spans: dict = {}
        for a, b, name, e in host:
            if name.startswith("perfbench."):
                s = spans.setdefault(name, {"count": 0, "device_s": 0.0,
                                            "host_s": 0.0})
                s["count"] += 1
                s["host_s"] += (b - a) / 1e6
        kernels = sorted((a, b) for a, b, name in ops if not _is_copy(name))
        for name, sec in _kernel_time_inside(notes, kernels).items():
            spans.setdefault(name, {"count": 0, "device_s": 0.0,
                                    "host_s": 0.0})["device_s"] = sec
        window_s = self.t1 - self.t0
        busy = _merged([(a, b) for a, b, _ in ops])
        gaps: dict = {}
        for label, gap in _label_gaps(host, busy):
            gaps[label] = gaps.get(label, 0.0) + gap
        return {
            "window_s": window_s,
            "busy_s": union_s([(a, b) for a, b, _ in ops]),
            "spans": spans,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:top],
            "n_device_ops": len(ops),
        }


def _is_copy(name: str) -> bool:
    return "Memcpy" in name or "Memset" in name


def _kernel_time_inside(notes, kernels) -> dict:
    """Per annotation name, the summed duration of the kernels (``(start,
    end)`` sorted) that ran inside each of its device intervals."""
    import bisect

    starts = [k[0] for k in kernels]
    out: dict = {}
    for a, b, name in notes:
        i = bisect.bisect_left(starts, a)
        t = 0.0
        while i < len(kernels) and kernels[i][0] < b:
            t += min(kernels[i][1], b) - kernels[i][0]
            i += 1
        out[name] = out.get(name, 0.0) + t / 1e6
    return out


def _label_gaps(host, busy):
    """``(label, seconds)`` of each idle gap between the merged device
    intervals ``busy``, labelled by the shortest host operation or span
    running when it began (one sweep over both, by start time)."""
    import heapq

    hosts = sorted(host, key=lambda h: h[0])
    active, j, out = [], 0, []
    for (_, t), (nxt, _) in zip(busy, busy[1:]):
        while j < len(hosts) and hosts[j][0] <= t:
            a, b, name, _ = hosts[j]
            heapq.heappush(active, (b - a, b, name))
            j += 1
        while active and active[0][1] < t:
            heapq.heappop(active)
        label = f"host: {active[0][2]}" if active else "host: none recorded"
        out.append((label, (nxt - t) / 1e6))
    return out


def idle_share_pct(obs: dict):
    """The device's idle share over the traced stretch, in %, or None
    without a trace."""
    t = obs.get("trace")
    if not t or t["window_s"] <= 0 or t["n_device_ops"] == 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
