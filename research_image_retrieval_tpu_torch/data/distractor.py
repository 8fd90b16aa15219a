"""Label-free image pool for gallery building, with partitioning
(port of ``research_image_retrieval_tpu/data/distractor.py``).

``DistractorDataset`` serves the images of any random-access source
(``GLDv2FileDataset``, ``RecordDataset``, ``SyntheticRetrievalDataset``:
items ``(image, label)`` or bare images) through an optional index pool
and an optional ``[start, end)`` window of it, so each worker extracts
its own shard of a large gallery; ``partition_for_host`` gives the
windows.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from research_image_retrieval_tpu_torch.data.transforms import imthumbnail

__all__ = ["DistractorDataset", "partition_for_host"]


def partition_for_host(n: int, host: int, n_hosts: int) -> tuple[int, int]:
    """[start, end) slice of an n-item pool for one of n_hosts workers
    (ceil(n / n_hosts) each, the last one shorter or empty)."""
    per = -(-n // n_hosts)
    start = min(host * per, n)
    return start, min(start + per, n)


class DistractorDataset:
    """Unlabeled image pool.

    Args:
      source: random-access dataset returning ``(image, label)`` or a bare
        image at each index.
      pool: optional index subset of ``source``.
      partition: optional ``(start, end)`` window into the pool.
      imsize: optional max-side thumbnail (``imthumbnail``).
      transform: optional callable applied to the image last.
    """

    def __init__(self, source, pool: Sequence[int] | None = None,
                 partition: tuple[int, int] | None = None,
                 imsize: int | None = None, transform=None):
        self.source = source
        pool = list(range(len(source))) if pool is None else list(pool)
        if partition is not None:
            start, end = partition
            pool = pool[start:end]
        self.pool = pool
        self.imsize = imsize
        self.transform = transform

    def __len__(self) -> int:
        return len(self.pool)

    def __getitem__(self, i: int) -> np.ndarray:
        item = self.source[self.pool[i]]
        img = item[0] if isinstance(item, tuple) else item
        if self.imsize is not None:
            img = imthumbnail(np.asarray(img), self.imsize)
        if self.transform is not None:
            img = self.transform(img)
        return np.asarray(img)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
