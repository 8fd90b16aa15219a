"""Input pipeline: sharded, resumable, multi-worker batched iteration
(port of ``research_image_retrieval_tpu/data/pipeline.py``; the same batch
order for the same seed).

* sharding by (shard_index, shard_count): each process reads its slice of
  the epoch permutation (default: one shard);
* or by rows (``row_shard=(index, count)``, the multi-GPU trainer's
  mode): the iterator walks the single-device run's global batches and
  yields only rows ``[index * b / count, (index + 1) * b / count)`` of
  each, decoding nothing else, so the ranks of a data axis together see
  exactly the single-device run's batches;
* deterministic epoch shuffling from ``np.random.default_rng((seed,
  epoch))``;
* thread-pool decode/augment workers;
* explicit iterator state (epoch, step) for a mid-epoch resume.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

__all__ = ["ShardedBatchIterator"]


class ShardedBatchIterator:
    """Batched iterator over a random-access dataset.

    Args:
      dataset: supports __len__ and __getitem__ -> (image, label).
      batch_size: per-process batch size.
      seed: epoch shuffling seed.
      shard_index / shard_count: this process's shard (default: the
        only one).
      num_workers: decode worker threads (0 = synchronous).
      row_shard: ``(index, count)``: yield only this block of rows of
        each global batch of ``batch_size`` (which ``count`` must
        divide).
      drop_last: drop the trailing partial batch (every step sees the same
        shapes).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        seed: int = 0,
        shuffle: bool = True,
        shard_index: int = 0,
        shard_count: int = 1,
        num_workers: int = 8,
        drop_last: bool = True,
        row_shard: tuple[int, int] | None = None,
    ):
        if row_shard is not None:
            index, count = row_shard
            if batch_size % count or not 0 <= index < count:
                raise ValueError(f"row_shard {row_shard}: the global batch "
                                 f"{batch_size} splits into {count} equal "
                                 "blocks, one per data rank")
            if (shard_count or 1) > 1 or not drop_last:
                raise ValueError("row_shard needs drop_last=True (equal "
                                 "blocks) and no shard_count")
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.shard_index = shard_index or 0
        self.shard_count = max(shard_count or 1, 1)
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.row_shard = row_shard
        self.epoch = 0
        self.step = 0  # batch index within the current epoch

    # -- resumable state ----------------------------------------------------
    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "step": self.step, "seed": self.seed}

    def load_state_dict(self, state: dict):
        self.epoch = int(state["epoch"])
        self.step = int(state["step"])
        self.seed = int(state["seed"])

    # -- iteration ----------------------------------------------------------
    def _epoch_indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        order = (
            np.random.default_rng((self.seed, epoch)).permutation(n)
            if self.shuffle
            else np.arange(n)
        )
        # pad to a shard_count multiple (wrap-around, DistributedSampler
        # style) so every shard sees the same number of steps
        pad = (-n) % self.shard_count
        if pad:
            order = np.concatenate([order, order[:pad]])
        return order[self.shard_index :: self.shard_count]

    def steps_per_epoch(self) -> int:
        n = len(self._epoch_indices(0))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _pool(self) -> ThreadPoolExecutor:
        # one long-lived pool; spawning 8 threads per batch would put
        # thread setup/teardown on the input hot path
        if getattr(self, "_executor", None) is None:
            import weakref

            self._executor = ThreadPoolExecutor(self.num_workers)
            # join the workers when the iterator is garbage-collected so
            # long-lived processes don't accumulate idle threads
            weakref.finalize(
                self, ThreadPoolExecutor.shutdown, self._executor, wait=False
            )
        return self._executor

    def close(self):
        """Shut down the decode worker pool (idempotent)."""
        ex = getattr(self, "_executor", None)
        if ex is not None:
            ex.shutdown(wait=False)
            self._executor = None

    def _fetch(self, idx_batch: np.ndarray):
        if self.num_workers > 0:
            items = list(self._pool().map(self.dataset.__getitem__, idx_batch))
        else:
            items = [self.dataset[i] for i in idx_batch]
        images = np.stack([im for im, _ in items])
        labels = np.asarray([lb for _, lb in items], np.int64)
        return images, labels

    def epoch_batches(self) -> Iterator[tuple]:
        """Iterate the remainder of the current epoch, then advance it."""
        # fresh augmentations each epoch (DistributedSampler.set_epoch style)
        transform = getattr(self.dataset, "transform", None)
        if transform is not None and hasattr(transform, "set_epoch"):
            transform.set_epoch(self.epoch)
        idxs = self._epoch_indices(self.epoch)
        nsteps = self.steps_per_epoch()
        prefetch = getattr(self.dataset, "prefetch", None)
        while self.step < nsteps:
            lo = self.step * self.batch_size
            batch_idx = self._rows(idxs[lo : lo + self.batch_size])
            if prefetch is not None and self.step + 1 < nsteps:
                # overlap the NEXT batch's page-ins with this decode
                # (RecordDataset -> native MADV_WILLNEED, data/records.py)
                nxt = self._rows(
                    idxs[lo + self.batch_size : lo + 2 * self.batch_size])
                try:
                    prefetch(nxt)
                except Exception:
                    prefetch = None  # never let an advisory path kill input
            # advance state BEFORE yielding so state_dict() captured between
            # batches resumes at the next batch, not this one
            self.step += 1
            yield self._fetch(batch_idx)
        self.epoch += 1
        self.step = 0

    def _rows(self, batch_idx: np.ndarray) -> np.ndarray:
        """This rank's rows of a global batch (all without ``row_shard``)."""
        if self.row_shard is None:
            return batch_idx
        index, count = self.row_shard
        per = self.batch_size // count
        return batch_idx[index * per : (index + 1) * per]

    def __iter__(self):
        while True:
            yield from self.epoch_batches()
