"""Profiling and debug utilities
(port of ``research_image_retrieval_tpu/utils/profiling.py``).

* ``trace`` -- ``torch.profiler`` around a block, written as a Chrome
  trace (view in Perfetto or ``chrome://tracing``).
* ``step_timer`` -- a block's time, with CUDA events on the card, after
  synchronizing on the outputs passed to ``sync``.
* ``nan_check`` -- wraps a function and raises when an output is not
  finite.
* ``deterministic_mode`` -- deterministic cuDNN and PyTorch algorithms
  for bit-reproducible runs on the card (the JAX function sets XLA's
  deterministic-ops flag).

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

import contextlib
import os
import time

import torch

__all__ = ["deterministic_mode", "nan_check", "step_timer", "trace"]

_CUBLAS_CONFIGS = (":4096:8", ":16:8")


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


class step_timer:
    """Times a block, including the device work that produced the outputs
    passed to ``sync``.

    Usage::

        with step_timer() as t:
            out = step(...)
            t.sync(out)
        print(t.ms)

    With a card the time is CUDA events recorded on the current stream at
    the block's start and after ``sync``; without one, the host clock.
    """

    def __enter__(self):
        self.ms = None
        self._cuda = torch.cuda.is_available()
        if self._cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def sync(self, result):
        """Wait for every tensor in ``result`` (nested lists, tuples and
        dicts) to be computed; returns ``result``."""
        def walk(x):
            if isinstance(x, torch.Tensor):
                if x.is_cuda:
                    torch.cuda.current_stream(x.device).synchronize()
            elif isinstance(x, dict):
                for v in x.values():
                    walk(v)
            elif isinstance(x, (list, tuple)):
                for v in x:
                    walk(v)

        if self._cuda:
            self._end.record()
        walk(result)
        return result

    def __exit__(self, *exc):
        if self._cuda:
            if not self._end.query():
                self._end.synchronize()
            self.ms = self._start.elapsed_time(self._end)
        else:
            self.ms = (time.perf_counter() - self._t0) * 1000.0
        return False


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
