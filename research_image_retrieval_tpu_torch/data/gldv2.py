"""GLDv2(-clean) dataset builders (port of
``research_image_retrieval_tpu/data/gldv2.py``).

* clean-CSV parsing: ``train_clean.csv`` maps landmark_id -> space-joined
  image ids; images live in 3-level hash dirs ``{i[0]}/{i[1]}/{i[2]}/{i}.jpg``.
  Parsed with the standard ``csv`` module (the JAX function uses pandas).
* contiguous relabeling with a persisted mapping (relabeling.pkl).
* deterministic stratified per-class train/val split with a seeded
  MT19937 shuffle.
* random-access datasets yielding (decoded RGB image, label): over the
  hash directories, or over an LMDB of pickled (jpeg_bytes, label), which
  needs the ``lmdb`` package and raises without it (pack the LMDB into a
  ``.rirrec`` file with ``cli.pack`` where it is installed).
"""

from __future__ import annotations

import os
import pickle
from typing import Sequence

import numpy as np

__all__ = [
    "parse_clean_csv",
    "relabel_contiguous",
    "stratified_split",
    "GLDv2FileDataset",
    "GLDv2LmdbDataset",
    "build_gldv2_train_val",
]


def _hash_path(image_id: str) -> str:
    return os.path.join(image_id[0], image_id[1], image_id[2], image_id + ".jpg")


def parse_clean_csv(csv_path: str):
    """Parse train_clean.csv -> (image_ids [N], landmark_ids [N]).

    Each row: landmark_id, "img1 img2 ...".
    """
    import csv

    ids, labels = [], []
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            for img in str(row["images"]).split():
                ids.append(img)
                labels.append(int(row["landmark_id"]))
    return np.asarray(ids), np.asarray(labels, dtype=np.int64)


def relabel_contiguous(labels: np.ndarray, save_path: str | None = None):
    """Map arbitrary landmark ids to contiguous [0, C); optionally persist
    the mapping as a pickle)."""
    uniq = np.unique(labels)
    mapping = {int(old): new for new, old in enumerate(uniq)}
    new_labels = np.asarray([mapping[int(l)] for l in labels], dtype=np.int64)
    if save_path:
        with open(save_path, "wb") as f:
            pickle.dump(mapping, f, protocol=4)
    return new_labels, mapping


def stratified_split(
    labels: np.ndarray, val_per_class: int = 1, seed: int = 11
):
    """Deterministic per-class split.

    For each class, indices are shuffled with a seeded MT19937 generator
    and the first ``val_per_class`` go to validation.

    Returns:
      (train_idx, val_idx) index arrays.
    """
    rng = np.random.RandomState(seed)  # MT19937
    train_idx, val_idx = [], []
    for cls in np.unique(labels):
        members = np.flatnonzero(labels == cls)
        order = rng.permutation(len(members))
        members = members[order]
        val_idx.extend(members[:val_per_class])
        train_idx.extend(members[val_per_class:])
    return np.asarray(sorted(train_idx)), np.asarray(sorted(val_idx))


def _decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> RGB uint8 HWC (native decoder, else OpenCV / PIL)."""
    from research_image_retrieval_tpu_torch.data.native_decode import (
        decode_jpeg,
    )


    return decode_jpeg(data)


class GLDv2FileDataset:
    """Random-access GLDv2 over the 3-level hash directory layout."""

    def __init__(self, root: str, image_ids: Sequence[str], labels: np.ndarray,
                 transform=None):
        self.root = root
        self.image_ids = list(image_ids)
        self.labels = np.asarray(labels)
        self.transform = transform

    def __len__(self):
        return len(self.image_ids)

    def __getitem__(self, i: int):
        path = os.path.join(self.root, _hash_path(self.image_ids[i]))
        with open(path, "rb") as f:
            img = _decode_jpeg(f.read())
        if self.transform is not None:
            img = self.transform(img, index=i)
        return img, int(self.labels[i])


class GLDv2LmdbDataset:
    """LMDB-backed flavor: key list under ``__keys__`` (or scanned),
    values are pickled (jpeg_bytes, label).  Requires the ``lmdb``
    package (not a dependency of the port): where it is missing, pack the
    LMDB into a ``.rirrec`` file with ``cli.pack`` where it is installed
    and train from that.
    """

    def __init__(self, lmdb_path: str, indices=None, transform=None):
        try:
            import lmdb
        except ImportError as e:
            raise ImportError(
                "GLDv2LmdbDataset requires the 'lmdb' package, which is not "
                "installed; pack the LMDB into a .rirrec file (cli.pack "
                "--lmdb, where lmdb is installed) and train from that, or "
                "use GLDv2FileDataset for the directory layout.") from e

        self.env = lmdb.open(
            lmdb_path, readonly=True, lock=False, readahead=False, meminit=False
        )
        with self.env.begin(write=False) as txn:
            keys = txn.get(b"__keys__")
            if keys is not None:
                self.keys = pickle.loads(keys)
            else:
                self.keys = [k for k, _ in txn.cursor() if k != b"__keys__"]
        if indices is not None:
            self.keys = [self.keys[i] for i in indices]
        self.transform = transform

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, i: int):
        with self.env.begin(write=False) as txn:
            data = txn.get(self.keys[i])
        jpeg_bytes, label = pickle.loads(data)
        img = _decode_jpeg(jpeg_bytes)
        if self.transform is not None:
            img = self.transform(img, index=i)
        return img, int(label)


def build_gldv2_train_val(
    root: str,
    csv_path: str,
    val_per_class: int = 1,
    seed: int = 11,
    train_transform=None,
    val_transform=None,
    cache_dir: str | None = None,
    verify_files: bool = False,
):
    """End-to-end builder: CSV -> relabel -> split -> datasets.

    ``verify_files=True`` drops CSV entries whose jpg is missing on disk.

    Returns:
      (train_ds, val_ds, num_classes)
    """
    ids, raw_labels = parse_clean_csv(csv_path)
    if verify_files:
        present = np.asarray(
            [os.path.exists(os.path.join(root, _hash_path(i))) for i in ids]
        )
        ids, raw_labels = ids[present], raw_labels[present]
    save = os.path.join(cache_dir, "relabeling.pkl") if cache_dir else None
    labels, mapping = relabel_contiguous(raw_labels, save_path=save)
    train_idx, val_idx = stratified_split(labels, val_per_class, seed)
    train = GLDv2FileDataset(
        root, ids[train_idx], labels[train_idx], transform=train_transform
    )
    val = GLDv2FileDataset(
        root, ids[val_idx], labels[val_idx], transform=val_transform
    )
    return train, val, len(mapping)
