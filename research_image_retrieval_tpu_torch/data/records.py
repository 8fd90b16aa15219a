"""Packed-record dataset (port of
``research_image_retrieval_tpu/data/records.py``; the same ``.rirrec``
format, so files written by either package read in the other).

A ``.rirrec`` file is a header, the concatenated JPEG payloads and a
fixed-width index table (offset, length, label).  It is read by the
memory-mapped C++ core ``native/rir_records.cc`` (built with g++ into
``build/native/`` at first use, loaded with ctypes): a record is a numpy
view into the mmap, and ``prefetch`` overlaps the next batch's page-ins
with this batch's decode.  The pure-Python reader (struct + file seeks)
reads the same format without the toolchain.  Which reader a
``RecordReader`` uses is a choice of file access, not of device; it is
printed once per process.  ``write_records`` is pure Python;
``convert_lmdb_to_records`` migrates an LMDB of pickled
``(jpeg_bytes, label)`` values.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Iterable, Iterator

import numpy as np

from research_image_retrieval_tpu_torch.data.native_decode import NativeLib

__all__ = [
    "write_records",
    "RecordReader",
    "RecordDataset",
    "convert_lmdb_to_records",
    "records_native_available",
]

_MAGIC = b"RIRREC01"
_ENTRY = struct.Struct("<QQq")  # offset, length, label


def _declare(lib: ctypes.CDLL) -> None:
    lib.rir_records_open.restype = ctypes.c_void_p
    lib.rir_records_open.argtypes = [ctypes.c_char_p]
    lib.rir_records_count.restype = ctypes.c_int64
    lib.rir_records_count.argtypes = [ctypes.c_void_p]
    lib.rir_records_get.restype = ctypes.c_int
    lib.rir_records_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.rir_records_labels.restype = ctypes.c_int
    lib.rir_records_labels.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    lib.rir_records_prefetch.restype = ctypes.c_int
    lib.rir_records_prefetch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    lib.rir_records_close.restype = None
    lib.rir_records_close.argtypes = [ctypes.c_void_p]


_native = NativeLib("rir_records.cc", "librir_records.so", _declare)
_load = _native.load
_announced: set = set()


def _announce(kind: str) -> None:
    if kind not in _announced:
        _announced.add(kind)
        print(f">> record reader: {kind}")


def records_native_available() -> bool:
    return _load() is not None


def write_records(path: str, items: Iterable[tuple[bytes, int]]) -> int:
    """Write ``(blob_bytes, label)`` items into one packed record file.

    Returns the record count.  Pure Python — the writer is an offline /
    data-prep tool; only the read path needs to be fast.
    """
    entries = []
    with open(path, "wb") as f:
        f.write(_MAGIC + b"\0" * 16)  # count + index offset patched at end
        for blob, label in items:
            entries.append((f.tell(), len(blob), int(label)))
            f.write(blob)
        index_off = f.tell()
        for off, ln, lb in entries:
            f.write(_ENTRY.pack(off, ln, lb))
        f.seek(8)
        f.write(struct.pack("<QQ", len(entries), index_off))
    return len(entries)


class _PyReader:
    """Pure-Python fallback: same format, file seeks instead of mmap."""

    def __init__(self, path: str):
        self._f = open(path, "rb")
        header = self._f.read(24)
        if header[:8] != _MAGIC:
            raise ValueError(f"{path}: not a RIRREC01 file")
        self.count, index_off = struct.unpack("<QQ", header[8:24])
        self._f.seek(index_off)
        raw = self._f.read(self.count * _ENTRY.size)
        self._index = [
            _ENTRY.unpack_from(raw, i * _ENTRY.size) for i in range(self.count)
        ]

    def get(self, i: int) -> tuple[np.ndarray, int]:
        off, ln, lb = self._index[i]
        self._f.seek(off)
        return np.frombuffer(self._f.read(ln), np.uint8), lb

    def labels(self) -> np.ndarray:
        return np.asarray([e[2] for e in self._index], np.int64)

    def prefetch(self, idxs) -> None:  # no-op without mmap
        pass

    def close(self):
        self._f.close()


class RecordReader:
    """Random-access reader over a ``.rirrec`` file: the native mmap core
    (``native=None``: when it builds; ``True``: required) or the Python
    reader (``native=False``).  ``get(i)`` returns ``(uint8 blob view,
    label)``, zero-copy on the native path (a view into the mmap, valid
    while the reader is open)."""

    def __init__(self, path: str, native: bool | None = None):
        self.path = path
        lib = _load() if native in (None, True) else None
        if native is True and lib is None:
            raise RuntimeError("native record reader unavailable (g++?)")
        self._lib = lib
        self._py = None
        self._handle = None
        if lib is not None:
            self._handle = lib.rir_records_open(path.encode())
            if not self._handle:
                raise ValueError(f"{path}: cannot open as RIRREC01")
            self.count = int(lib.rir_records_count(self._handle))
            _announce("native mmap core (native/rir_records.cc)")
        else:
            self._py = _PyReader(path)
            self.count = self._py.count
            _announce("pure Python (file seeks; the native core did not "
                      "build or was not asked for)")

    def __len__(self) -> int:
        return self.count

    def get(self, i: int) -> tuple[np.ndarray, int]:
        if self._py is not None:
            return self._py.get(i)
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        ln = ctypes.c_uint64()
        lb = ctypes.c_int64()
        rc = self._lib.rir_records_get(
            self._handle, int(i), ctypes.byref(ptr), ctypes.byref(ln),
            ctypes.byref(lb),
        )
        if rc != 0:
            raise IndexError(i)
        buf = np.ctypeslib.as_array(ptr, shape=(ln.value,))
        return buf, int(lb.value)

    def labels(self) -> np.ndarray:
        if self._py is not None:
            return self._py.labels()
        out = np.empty(self.count, np.int64)
        self._lib.rir_records_labels(
            self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self.count,
        )
        return out

    def prefetch(self, idxs) -> None:
        """Advise the kernel to page in these records (overlap IO with the
        current batch's decode)."""
        if self._py is not None:
            return
        arr = np.ascontiguousarray(np.asarray(idxs, np.int64))
        self._lib.rir_records_prefetch(
            self._handle, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(arr),
        )

    def close(self):
        if self._py is not None:
            self._py.close()
            self._py = None
        elif self._handle:
            self._lib.rir_records_close(self._handle)
            self._handle = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass


class RecordDataset:
    """Dataset over a record file: ``__getitem__ -> (image, label)``.

    The contract ``ShardedBatchIterator`` consumes: JPEG payloads decode
    through ``native_decode.decode_jpeg`` (the native libjpeg core, else
    OpenCV / PIL); ``transform`` applies per item.  ``indices`` restricts
    to a subset (train/val splits).
    """

    def __init__(self, path: str, indices=None, transform=None,
                 max_side: int = 0):
        self.reader = RecordReader(path)
        self.indices = (
            np.asarray(indices, np.int64)
            if indices is not None
            else np.arange(len(self.reader), dtype=np.int64)
        )
        self.transform = transform
        self.max_side = max_side

    def __len__(self) -> int:
        return len(self.indices)

    def labels(self) -> np.ndarray:
        return self.reader.labels()[self.indices]

    def _decode(self, blob: np.ndarray) -> np.ndarray:
        from research_image_retrieval_tpu_torch.data.native_decode import (
            decode_jpeg,
        )

        # decode_jpeg's c_char_p signature needs bytes; this copy is tiny
        # next to the decode itself
        return decode_jpeg(blob.tobytes(), max_side=self.max_side)

    def __getitem__(self, i: int):
        blob, label = self.reader.get(int(self.indices[i]))
        img = self._decode(blob)
        if self.transform is not None:
            try:  # framework transforms take a per-item index for seeding
                img = self.transform(img, index=i)
            except TypeError:
                img = self.transform(img)
        return img, label

    def prefetch(self, batch_indices) -> None:
        self.reader.prefetch(self.indices[np.asarray(batch_indices)])


def convert_lmdb_to_records(lmdb_path: str, out_path: str,
                            open_env=None) -> int:
    """Migrate an LMDB of pickled ``(jpeg_bytes, label)`` values (keys
    listed under ``__keys__``, else scanned) into a packed record file.

    ``open_env``: injectable ``lmdb.open``-compatible factory (a path ->
    an env with ``begin(write=False)`` whose txn supports ``get`` and
    ``cursor``).  Defaults to the real ``lmdb`` package; tests drive the
    full migration logic — __keys__ discovery, cursor fallback, pickle
    decode, record packing — through a fake env without it.
    """
    import pickle

    if open_env is None:
        import lmdb  # hard dep only for migration

        open_env = lambda p: lmdb.open(
            p, readonly=True, lock=False, readahead=True
        )
    env = open_env(lmdb_path)

    def items() -> Iterator[tuple[bytes, int]]:
        with env.begin(write=False) as txn:
            keys = txn.get(b"__keys__")
            key_list = (
                pickle.loads(keys) if keys is not None
                else [k for k, _ in txn.cursor() if k != b"__keys__"]
            )
            for k in key_list:
                blob, label = pickle.loads(txn.get(k))
                yield blob, int(label)

    return write_records(out_path, items())
