"""Checkpoints with the JAX package's retention policy
(port of ``research_image_retrieval_tpu/train/checkpoint.py``).

Files are ``epoch_{epoch:05d}.pt`` and ``best.pt``, written with
``torch.save`` (to a temporary name, then renamed, so a reader never sees
a partly written file).  A trainer's checkpoint holds the model's state
dict under ``"model"``, plus the optimizer state, the step, the data
iterator's state, the step generator's state and the optimizer phase; the
evaluation driver reads its ``"model"`` entry.  Orbax is not used.
"""

from __future__ import annotations

import os
import shutil
from typing import Callable, Mapping

import torch
import torch.nn as nn

__all__ = ["CheckpointManager", "partial_load"]


def partial_load(model: nn.Module, source: Mapping,
                 rename: Mapping[str, str] | Callable[[str], str] | None = None,
                 verbose: bool = False) -> dict:
    """Shape-filtered partial load of a foreign state dict into ``model``.

    Every source entry whose (renamed) key exists in the model's state
    dict with the same shape replaces the model's value; everything else
    keeps the model's (a classifier of another class count, a
    torchvision ``fc``).  ``rename`` rewrites source keys first: a
    ``{prefix: replacement}`` mapping (``{"": "backbone."}`` puts a bare
    or torchvision-layout ResNet under the model's backbone) or a
    callable.  Returns ``{"loaded", "shape_mismatch", "unmatched_source",
    "kept_target"}`` lists of keys.
    """
    def apply(k: str) -> str:
        if callable(rename):
            return rename(k)
        for old, new in (rename or {}).items():
            if k.startswith(old):
                return new + k[len(old):]
        return k

    target = model.state_dict()
    report = {"loaded": [], "shape_mismatch": [], "unmatched_source": [],
              "kept_target": []}
    merged = dict(target)
    for k, v in source.items():
        k = apply(k)
        if k not in target:
            report["unmatched_source"].append(k)
            continue
        v = torch.as_tensor(v)
        if tuple(v.shape) != tuple(target[k].shape):
            report["shape_mismatch"].append(k)
            continue
        merged[k] = v
        report["loaded"].append(k)
    report["kept_target"] = sorted(set(target) - set(report["loaded"]))
    model.load_state_dict(merged)
    if verbose:
        for name, keys in report.items():
            for k in keys:
                print(f"partial_load[{name}]: {k}")
    return report


class CheckpointManager:
    """Epoch-keyed checkpoints with rolling retention and best tracking.

    ``keep_every``: epochs divisible by it are kept for good;
    ``keep_last``: how many of the latest epochs survive the rolling
    delete.
    """

    def __init__(self, directory: str, keep_every: int = 5,
                 keep_last: int = 1):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_every = keep_every
        self.keep_last = keep_last
        self._best_metric: float | None = None

    def _path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch:05d}.pt")

    def _write(self, path: str, payload):
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def save(self, epoch: int, payload, metric: float | None = None,
             lower_is_better: bool = True):
        """Save ``payload`` for ``epoch``; also as ``best.pt`` when
        ``metric`` improves."""
        path = self._path(epoch)
        self._write(path, payload)
        if metric is not None and (
                self._best_metric is None
                or (metric < self._best_metric if lower_is_better
                    else metric > self._best_metric)):
            self._best_metric = metric
            shutil.copyfile(path, os.path.join(self.directory, "best.pt"))
        self._rolling_delete(epoch)

    def _rolling_delete(self, current: int):
        for e in self._list_epochs():
            if e == current or e % self.keep_every == 0:
                continue
            if e < current - (self.keep_last - 1):
                os.remove(self._path(e))

    def _list_epochs(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            stem, ext = os.path.splitext(name)
            if stem.startswith("epoch_") and ext == ".pt":
                try:
                    out.append(int(stem.split("_")[1]))
                except (IndexError, ValueError):
                    pass
        return sorted(out)

    def latest_epoch(self) -> int | None:
        es = self._list_epochs()
        return es[-1] if es else None

    def restore(self, epoch: int | None = None, best: bool = False,
                map_location="cpu") -> tuple[dict, int]:
        """``(payload, epoch)`` of ``epoch`` (default: the latest), or of
        ``best.pt`` (epoch -1)."""
        if best:
            path, epoch = os.path.join(self.directory, "best.pt"), -1
        else:
            if epoch is None:
                epoch = self.latest_epoch()
                if epoch is None:
                    raise FileNotFoundError(
                        f"no checkpoints in {self.directory}")
            path = self._path(epoch)
        return torch.load(path, map_location=map_location,
                          weights_only=True), epoch
