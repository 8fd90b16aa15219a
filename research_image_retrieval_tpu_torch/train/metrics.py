"""Metrics and logging: meters, throttled iteration logger, JSONL writer
(a copy of ``research_image_retrieval_tpu/train/metrics.py``, with the
same JSONL keys, so that the port imports nothing of the JAX package).

NaN values clamp to 1e4; the logger prints ETA, meter averages and
iteration time every ``print_freq`` steps.  ``DeferredUpdate`` reads a
step's device scalars one step late, so the host prepares the next batch
while the card runs the step.  ``TensorBoardWriter`` raises when the
``tensorboard`` package is missing.
"""

from __future__ import annotations

import datetime
import json
import math
import time
from collections import defaultdict
from typing import Iterable

__all__ = ["AverageMeter", "MetricLogger", "DeferredUpdate", "JsonlWriter",
           "TensorBoardWriter"]


class AverageMeter:
    """Running average with the reference's non-finite guard."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        if not math.isfinite(val):
            val = 10000.0
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count

    def __str__(self):
        return f"{self.avg:.4f}"


class MetricLogger:
    """Named meters + a throttled progress generator."""

    def __init__(self, delimiter: str = "  "):
        self.meters: dict[str, AverageMeter] = defaultdict(AverageMeter)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {meter}" for name, meter in self.meters.items()
        )

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        start = time.time()
        end = start
        iter_time = AverageMeter()
        try:
            total = len(iterable)  # type: ignore[arg-type]
        except TypeError:
            total = None
        for i, obj in enumerate(iterable):
            yield obj
            iter_time.update(time.time() - end)
            if print_freq and (i % print_freq == 0 or (total and i == total - 1)):
                if total:
                    eta = str(
                        datetime.timedelta(
                            seconds=int(iter_time.avg * (total - i))
                        )
                    )
                    print(
                        self.delimiter.join(
                            [header, f"[{i}/{total}]", f"eta: {eta}",
                             str(self), f"iter time: {iter_time} s"]
                        )
                    )
                else:
                    print(self.delimiter.join([header, f"[{i}]", str(self)]))
            end = time.time()
        elapsed = time.time() - start
        if total:
            print(
                f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))} "
                f"({elapsed / max(total, 1):.4f} s / it)"
            )


class DeferredUpdate:
    """One-step-delayed meter updates so the train loop never blocks on
    the step it just dispatched.

    ``MetricLogger.update`` reads device scalars (``float(v)``), which
    waits for the step's kernels to finish; calling it right after the
    step was queued serializes host input decode with device compute.
    Holding each step's metrics un-read until the NEXT iteration lets the
    decode of batch N+1 overlap device step N.  ``flush()`` at loop exit
    delivers the final step's metrics; meter averages lag by at most one
    step mid-epoch and are exact after the flush.
    """

    def __init__(self, logger: "MetricLogger"):
        self.logger = logger
        self._pending = None

    def update(self, **metrics):
        prev, self._pending = self._pending, metrics
        if prev is not None:
            self.logger.update(**prev)

    def flush(self):
        if self._pending is not None:
            self.logger.update(**self._pending)
            self._pending = None


class JsonlWriter:
    """Append-only structured metric log (one JSON object per line)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a", buffering=1)

    def write(self, step: int, **metrics):
        rec = {"step": int(step)}
        for k, v in metrics.items():
            rec[k] = float(v) if isinstance(v, (int, float)) or hasattr(v, "item") else v
        self._fh.write(json.dumps(rec) + "\n")

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TensorBoardWriter:
    """TensorBoard event files beside the JSONL log, through
    ``torch.utils.tensorboard``.  Raises when the ``tensorboard`` package
    is missing: a run that asked for the channel does not go on without
    it."""

    def __init__(self, logdir: str):
        self.logdir = logdir
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise RuntimeError(
                "tensorboard=True needs the tensorboard package, which is "
                "not installed; scalars still go to metrics.jsonl with "
                "tensorboard=False") from e
        self._writer = SummaryWriter(logdir)

    def write(self, step: int, **metrics):
        for k, v in metrics.items():
            try:
                self._writer.add_scalar(k, float(v), int(step))
            except (TypeError, ValueError):
                pass  # non-scalar payloads are JSONL-only

    def flush(self):
        self._writer.flush()

    def close(self):
        self._writer.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
