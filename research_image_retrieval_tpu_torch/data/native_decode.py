"""JPEG decoding: the native libjpeg decoder bound with ctypes, and the
host decoders behind it (port of ``decode_jpeg`` / ``native_available``
of ``research_image_retrieval_tpu/data/native_decode.py`` and of the build
logic of its ``_native_build.py``).

The shared C++ source ``native/rir_decoder.cc`` is compiled with g++ on
first use into ``build/native/`` at the repository root (gitignored) and
loaded with ctypes; a missing toolchain or libjpeg is probed once per
process.  With ``max_side > 0`` libjpeg decodes at the smallest 1/2^k
scale whose max side is still >= ``max_side``.

The native library reads the colour space from libjpeg's guess; a
3-component JPEG whose Adobe APP14 marker says "no transform" (Adobe RGB)
is not given to it here: such files go to OpenCV or PIL.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["NativeLib", "decode_image", "decode_jpeg", "host_decode",
           "is_adobe_rgb", "native_available"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class NativeLib:
    """A shared C++ core under ``native/``, built with g++ into
    ``build/native/`` at first use and loaded with ctypes: rebuilt when
    the source is newer, written under a temporary name and renamed into
    place (no process loads a partly written file), ``None`` after a
    failure (probed once per process).  ``declare`` sets the argtypes
    and restype of every symbol."""

    def __init__(self, src: str, lib: str, declare, flags=()):
        self.src = os.path.join(_ROOT, "native", src)
        self.path = os.path.join(_ROOT, "build", "native", lib)
        self._declare = declare
        self._flags = list(flags)
        self._lock = threading.Lock()
        self._lib = None
        self._failed = False

    def _build(self) -> bool:
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        tmp = f"{self.path}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-fPIC", "-shared", "-o", tmp, self.src,
               *self._flags]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired):
            return False
        os.replace(tmp, self.path)
        return True

    def load(self):
        with self._lock:
            if self._lib is not None or self._failed:
                return self._lib
            stale = not os.path.exists(self.path) or (
                os.path.getmtime(self.src) > os.path.getmtime(self.path))
            if stale and not self._build():
                self._failed = True
                return None
            try:
                lib = ctypes.CDLL(self.path)
            except OSError:
                self._failed = True
                return None
            self._declare(lib)
            self._lib = lib
            return lib


def _declare(lib) -> None:
    lib.rir_decode_jpeg.restype = ctypes.c_int
    lib.rir_decode_jpeg.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.rir_jpeg_dims.restype = ctypes.c_int
    lib.rir_jpeg_dims.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]


_native = NativeLib("rir_decoder.cc", "librir_decoder.so", _declare,
                    flags=("-ljpeg", "-lpthread"))


def native_available() -> bool:
    return _native.load() is not None


def is_adobe_rgb(data: bytes) -> bool:
    """True for a 3-component JPEG with an Adobe APP14 marker whose
    transform flag is 0 (RGB samples, not YCbCr).  Reads the markers up
    to the first scan."""
    i, transform, ncomp = 2, None, None
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            return False  # not a marker where one must be: not ours to judge
        m = data[i + 1]
        if m == 0xFF:  # fill byte
            i += 1
            continue
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            i += 2
            continue
        if m in (0xDA, 0xD9):  # start of scan / end of image
            break
        seg = data[i + 4:i + 2 + int.from_bytes(data[i + 2:i + 4], "big")]
        if m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            transform = seg[11]
        elif 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC) \
                and len(seg) >= 6:
            ncomp = seg[5]
        i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
    return ncomp == 3 and transform == 0


def host_decode(data: bytes):
    """RGB uint8 [H, W, 3] through OpenCV, else PIL; ``None`` when neither
    is installed.  A file they cannot decode raises."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        if img is not None:
            return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    try:
        from PIL import Image
    except ImportError:
        if cv2 is not None:
            raise ValueError("OpenCV cannot decode this image and PIL is "
                             "not installed") from None
        return None
    import io

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _no_decoder() -> RuntimeError:
    return RuntimeError(
        "no image decoder: OpenCV (cv2) and PIL are not installed and the "
        "native libjpeg decoder (native/rir_decoder.cc, built with g++ "
        "-ljpeg) is unavailable or cannot read this file")


def _native_decode(lib, data: bytes, max_side: int):
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.rir_jpeg_dims(data, len(data), max_side, ctypes.byref(h),
                         ctypes.byref(w)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.rir_decode_jpeg(data, len(data),
                             out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
                             ctypes.byref(h), ctypes.byref(w), max_side)
    return out if rc == 0 else None


def decode_jpeg(data: bytes, max_side: int = 0) -> np.ndarray:
    """Decode JPEG bytes to RGB uint8 [H, W, 3] with the native decoder
    (``max_side > 0``: DCT prescale, the caller owns the exact final
    resize); Adobe-RGB files and files the library refuses go to OpenCV /
    PIL, and with neither installed this raises."""
    lib = None if is_adobe_rgb(data) else _native.load()
    out = None if lib is None else _native_decode(lib, data, max_side)
    if out is None:
        out = host_decode(data)
    if out is None:
        raise _no_decoder()
    return out


def decode_image(data: bytes, max_side: int = 0) -> np.ndarray:
    """Image bytes (JPEG / PNG / ...) -> RGB uint8, in the JAX package's
    decoder order: the native decoder for a JPEG when ``max_side > 0``,
    then OpenCV, then PIL; with neither of those installed, the native
    decoder at full scale for a JPEG; else an error naming all three."""
    jpeg = data[:2] == b"\xff\xd8"
    if jpeg and max_side > 0 and native_available():
        return decode_jpeg(data, max_side=max_side)
    out = host_decode(data)
    if out is None and jpeg:
        return decode_jpeg(data)  # raises when the library cannot either
    if out is None:
        raise _no_decoder()
    return out
