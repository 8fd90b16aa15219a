"""Profiling and debug utilities
(port of ``research_image_retrieval_tpu/utils/profiling.py``).

* ``trace`` -- ``torch.profiler`` around a block, written as a Chrome
  trace (view in Perfetto or ``chrome://tracing``); it carries the
  program's spans.
* ``span`` / ``spans`` -- the program's spans: named host intervals at
  its layer boundaries, with counts, recorded while a profiler records.
* ``nan_check`` -- wraps a function and raises when an output is not
  finite.
* ``deterministic_mode`` -- deterministic cuDNN and PyTorch algorithms
  for bit-reproducible runs on the card (the JAX function sets XLA's
  deterministic-ops flag).

Spans cost one flag check while no profiler records, and record, in
every thread, while any ``torch.profiler`` session does (``trace``, or
a benchmark's own session): each is then a record in a bounded store
that ``spans()`` copies and, in the threads the session observes (the
one that started it), a host-scope event of the profiler, stamped on
the clock of its device events.  That event is never a user
annotation, so the profiler mirrors nothing of it onto the device's
timeline.  The sites are listed in the README (port section).

A run on CUDA repeats bit for bit, a resumed ``cli.train`` run included,
only inside ``deterministic_mode()``.  It needs the environment variable
``CUBLAS_WORKSPACE_CONFIG`` (``:4096:8`` or ``:16:8``) set before the
process makes its first cuBLAS handle, that is before its first matrix
product on the card: cuBLAS reads it once, and
``torch.use_deterministic_algorithms`` then raises on every product.
Set it in the shell (``CUBLAS_WORKSPACE_CONFIG=:4096:8 python -m ...``)
or at the top of the program; ``deterministic_mode`` raises when it is
missing and the card is in use, and never sets it itself.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
import types

import torch

__all__ = ["SPAN_CAP", "deterministic_mode", "nan_check", "record", "span",
           "spans", "trace"]

_CUBLAS_CONFIGS = (":4096:8", ":16:8")

SPAN_CAP = 100_000  # records the store keeps, the newest

try:  # the host-scope record function torch's compiler names kernels with
    from torch._C._profiler import _RecordFunctionFast as _HostScope
except ImportError:
    _HostScope = None
# ``_is_profiler_enabled``: torch's process-wide flag for fast checks, True
# while any profiler session records (the C check is per thread: False in
# threads the session does not observe); never without the host scope
_state = torch.autograd.profiler
if _HostScope is None or not hasattr(_state, "_is_profiler_enabled"):
    _state = types.SimpleNamespace(_is_profiler_enabled=False)


class _SpanStore:
    """The newest ``cap`` span records, oldest first, and each thread's
    open spans (for the parent of the next)."""

    def __init__(self, cap: int):
        self.records = collections.deque(maxlen=cap)
        self.lock = threading.Lock()
        self.n = 0
        self.local = threading.local()

    def add(self, rec: dict) -> None:
        with self.lock:
            rec["index"] = self.n
            self.n += 1
            self.records.append(rec)

    def open_spans(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_store = _SpanStore(SPAN_CAP)


class _Off:
    """What every span site gets while no profiler records: nothing."""

    __slots__ = ()

    def __bool__(self):
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


class _Span:
    """A recording span: a host-scope profiler event and a store record
    (``index``, ``name``, ``start_ns`` / ``end_ns`` on
    ``time.perf_counter_ns``, ``parent`` (the index of the span it nests
    in on its thread, or None), ``id``, ``counts``)."""

    __slots__ = ("rec", "scope")

    def __init__(self, name: str, id, counts: dict):
        self.rec = {"index": None, "name": name, "start_ns": None,
                    "end_ns": None, "parent": None, "id": id,
                    "counts": counts}
        self.scope = _HostScope(name)

    def __bool__(self):
        return True

    def __enter__(self):
        rec, stack = self.rec, _store.open_spans()
        if stack:
            rec["parent"] = stack[-1]["index"]
            if rec["id"] is None:
                rec["id"] = stack[-1]["id"]
        stack.append(rec)
        _store.add(rec)
        self.scope.__enter__()
        rec["start_ns"] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec["end_ns"] = time.perf_counter_ns()
        self.scope.__exit__(*exc)
        stack = _store.open_spans()
        if stack and stack[-1] is self.rec:
            stack.pop()
        elif self.rec in stack:
            stack.remove(self.rec)
        return False

    def count(self, **counts) -> None:
        """Add counts known only inside the span."""
        self.rec["counts"].update(counts)


def span(name: str, id=None, **counts):
    """A context manager naming the block ``name`` in the profiler's
    trace and in ``spans()``, with ``counts`` (ints) and ``id`` (the
    batch or request it belongs to; default: its parent's).  While no
    profiler records it is one shared object that does nothing (falsy,
    so a site can skip counting: ``if s: s.count(rows=n)``)."""
    if not _state._is_profiler_enabled:
        return _OFF
    return _Span(name, id, counts)


def record(name: str, start_ns: int, end_ns: int, id=None,
           **counts) -> None:
    """Store a span measured after the fact on ``time.perf_counter_ns``
    (one that starts on one thread and ends on another, as a request's
    wait in a queue), while a profiler records.  It has no profiler
    event: only ``spans()`` holds it."""
    if not _state._is_profiler_enabled:
        return
    _store.add({"index": None, "name": name, "start_ns": start_ns,
                "end_ns": end_ns, "parent": None, "id": id,
                "counts": counts})


def spans() -> list[dict]:
    """Copies of the stored span records, oldest first (the newest
    ``SPAN_CAP``); a span still open has ``end_ns`` None."""
    with _store.lock:
        recs = list(_store.records)
    return [{**r, "counts": dict(r["counts"])} for r in recs]


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace"):
    """Profile the block (host, and the card when there is one) and write
    ``<log_dir>/<name>.json``, a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))


def nan_check(fn, enabled: bool = True):
    """``fn`` wrapped to raise ``FloatingPointError`` when a floating
    output (tensors in nested lists, tuples and dicts) holds a NaN or an
    infinity; ``fn`` itself when not ``enabled``.  Intermediates are not
    checked (the JAX version checks them through ``checkify``)."""
    if not enabled:
        return fn

    def check(x, path):
        if isinstance(x, torch.Tensor):
            if x.is_floating_point() and not bool(torch.isfinite(x).all()):
                raise FloatingPointError(
                    f"non-finite value in output {path or '<result>'} of "
                    f"{getattr(fn, '__name__', fn)}")
        elif isinstance(x, dict):
            for k, v in x.items():
                check(v, f"{path}[{k!r}]")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                check(v, f"{path}[{i}]")

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        check(out, "")
        return out

    return wrapped


@contextlib.contextmanager
def deterministic_mode():
    """Deterministic algorithms for the block: ``cudnn.deterministic =
    True``, ``cudnn.benchmark = False`` and
    ``torch.use_deterministic_algorithms(True)`` (an operation with no
    deterministic form then raises); all three are restored on exit.

    Raises ``RuntimeError`` when a card is in use and
    ``CUBLAS_WORKSPACE_CONFIG`` is not ``:4096:8`` or ``:16:8``: it must
    be set before the process's first cuBLAS handle (see the module's
    docstring), so it is never set here after the fact.
    """
    if torch.cuda.is_available() and \
            os.environ.get("CUBLAS_WORKSPACE_CONFIG") not in _CUBLAS_CONFIGS:
        raise RuntimeError(
            "deterministic_mode on CUDA needs CUBLAS_WORKSPACE_CONFIG=:4096:8 "
            "(or :16:8) in the environment before the process's first "
            "cuBLAS call; set it in the shell or at the top of the program")
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved[0], saved[1]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])
