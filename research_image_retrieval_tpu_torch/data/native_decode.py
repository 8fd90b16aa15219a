"""JPEG decoding: two native C++ cores bound with ctypes, and the host
decoders behind them (port of ``research_image_retrieval_tpu/data/
native_decode.py`` and of the build logic of its ``_native_build.py``).

* ``native/rir_decoder.cc``, the libjpeg decoder to RGB (``decode_jpeg``,
  ``decode_jpeg_batch``), built with ``g++ -ljpeg``.  With ``max_side >
  0`` libjpeg decodes at the smallest 1/2^k scale whose max side is still
  >= ``max_side``.  Where libjpeg's headers are missing it does not
  build, and OpenCV or PIL decode instead.
* ``research_image_retrieval_tpu_torch/csrc/jpeg_coeffs.cc``, the host
  half of the split decode (``decode_jpeg_coeffs``): the port's own
  entropy (Huffman) decoder, baseline and progressive, which needs no
  libjpeg.  It yields a file's quantized DCT coefficients, bit-equal to
  libjpeg's ``jpeg_read_coefficients``; ``ops/jpeg_decode.py`` finishes
  the decode on the device.

Each is compiled with g++ on first use into ``build/native/`` at the
repository root (gitignored) and loaded with ctypes; a failed build is
probed once per process.

The libjpeg decoder reads the colour space from libjpeg's guess; a
3-component JPEG whose Adobe APP14 marker says "no transform" (Adobe RGB)
is not given to it here: such files go to OpenCV or PIL, and the
coefficient decoder refuses them.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["JpegCoeffs", "NativeDecoder", "NativeLib", "coeffs_available",
           "decode_image", "decode_jpeg", "decode_jpeg_batch",
           "decode_jpeg_coeffs", "host_decode", "is_adobe_rgb",
           "native_available"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class NativeLib:
    """A shared C++ core, ``src`` under ``src_dir`` of the repository
    (``native/``, or the port's ``csrc/``), built with g++ into
    ``build/native/`` at first use and loaded with ctypes: rebuilt when
    the source is newer, written under a temporary name and renamed into
    place (no process loads a partly written file), ``None`` after a
    failure (probed once per process).  ``declare`` sets the argtypes
    and restype of every symbol."""

    def __init__(self, src: str, lib: str, declare, flags=(),
                 src_dir: str = "native"):
        self.src = os.path.join(_ROOT, src_dir, src)
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
    pi = ctypes.POINTER(ctypes.c_int)
    lib.rir_decode_batch.restype = None
    lib.rir_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
        ctypes.POINTER(ctypes.c_void_p), pi, pi, pi, pi, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]


_native = NativeLib("rir_decoder.cc", "librir_decoder.so", _declare,
                    flags=("-ljpeg", "-lpthread"))


def _declare_coeffs(lib) -> None:
    pi = ctypes.POINTER(ctypes.c_int)
    lib.rir_coeff_dims.restype = ctypes.c_int
    lib.rir_coeff_dims.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   pi, pi, pi, pi, pi, pi, pi]
    lib.rir_coeffs.restype = ctypes.c_int
    lib.rir_coeffs.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, pi, pi, pi, pi, pi, pi, pi]


_coeffs = NativeLib("jpeg_coeffs.cc", "libjpeg_coeffs.so", _declare_coeffs,
                    flags=("-std=c++17",),
                    src_dir=os.path.join("research_image_retrieval_tpu_torch",
                                         "csrc"))


def native_available() -> bool:
    """Whether the libjpeg decoder (``native/rir_decoder.cc``) builds and
    loads; ``coeffs_available`` probes the coefficient decoder."""
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


def decode_jpeg_batch(datas: list[bytes], max_side: int = 0,
                      num_threads: int = 8) -> list[np.ndarray]:
    """``decode_jpeg`` of every item, the libjpeg decodes in ``num_threads``
    native threads outside the GIL; an item the library refuses (or every
    item, without the library) goes to OpenCV / PIL."""
    lib = _native.load()
    todo = [i for i, d in enumerate(datas) if lib is not None
            and not is_adobe_rgb(d)]
    out: list = [None] * len(datas)
    bufs = {}
    for i in todo:
        h, w = ctypes.c_int(), ctypes.c_int()
        if lib.rir_jpeg_dims(datas[i], len(datas[i]), max_side,
                             ctypes.byref(h), ctypes.byref(w)) == 0:
            bufs[i] = np.empty((h.value, w.value, 3), np.uint8)
    if bufs:
        idx = sorted(bufs)
        n = len(idx)
        ints = lambda: (ctypes.c_int * n)()  # noqa: E731
        hs, ws, status = ints(), ints(), ints()
        lib.rir_decode_batch(
            (ctypes.c_char_p * n)(*[datas[i] for i in idx]),
            (ctypes.c_size_t * n)(*[len(datas[i]) for i in idx]),
            (ctypes.c_void_p * n)(*[bufs[i].ctypes.data for i in idx]),
            (ctypes.c_int * n)(*[bufs[i].nbytes for i in idx]),
            hs, ws, status, n, max_side, num_threads)
        for j, i in enumerate(idx):
            if status[j] == 0:
                out[i] = bufs[i][:hs[j], :ws[j]]
    for i, d in enumerate(datas):
        if out[i] is None:
            out[i] = host_decode(d)
            if out[i] is None:
                raise _no_decoder()
    return out


class NativeDecoder:
    """A transform-compatible decoder: bytes -> RGB uint8 through
    ``decode_jpeg`` with its prescale to ``max_side``."""

    def __init__(self, max_side: int = 0):
        self.max_side = max_side

    def __call__(self, data: bytes) -> np.ndarray:
        return decode_jpeg(data, self.max_side)


def coeffs_available() -> bool:
    """Whether the coefficient decoder (``csrc/jpeg_coeffs.cc``, no
    libjpeg) builds and loads."""
    return _coeffs.load() is not None


class JpegCoeffs:
    """An entropy-decoded JPEG: the top-left ``k x k`` quantized DCT
    coefficients of each 8x8 block, the dequantization tables and the
    pixel dims; ``ops.jpeg_decode.dct_decode_rgb`` finishes the decode on
    the device.  The loader sets ``out_block`` (pixels per block after
    the device decode: below 8 it is the DCT-domain prescale by
    ``8 / out_block``) and ``target_hw`` (the thumbnail's dims)."""

    __slots__ = ("coef_y", "coef_c", "quant_y", "quant_c", "h", "w",
                 "subsamp", "k", "out_block", "target_hw")

    def __init__(self, coef_y, coef_c, quant_y, quant_c, h, w, subsamp, k):
        self.coef_y = coef_y      # [by, bx, k, k] int16
        self.coef_c = coef_c      # [2, cby, cbx, k, k] int16
        self.quant_y = quant_y    # [k, k] float32
        self.quant_c = quant_c    # [k, k] float32
        self.h = h                # pixel dims (the canvas is by*8 x bx*8)
        self.w = w
        self.subsamp = subsamp    # 1 = 4:4:4, 2 = 4:2:0 (grey: either)
        self.k = k
        self.out_block = 8
        self.target_hw = None

    @property
    def decoded_hw(self) -> tuple:
        """Valid pixel extents after the device decode at ``out_block``:
        libjpeg's ``ceil(h * out_block / 8)`` (the JAX package rounds)."""
        n = self.out_block
        return (max(1, -(-self.h * n // 8)), max(1, -(-self.w * n // 8)))

    @property
    def nbytes(self) -> int:
        return self.coef_y.nbytes + self.coef_c.nbytes


def decode_jpeg_coeffs(data: bytes, k: int = 4) -> "JpegCoeffs | None":
    """The host half of the split decode: ``data``'s quantized DCT
    coefficients (top-left ``k x k`` of each block), or ``None`` for a
    file the coefficient decoder refuses, which the caller decodes to RGB
    instead: a layout other than grey, 4:4:4 and 4:2:0, arithmetic
    coding, a lossless or hierarchical frame, a precision other than 8
    bits, Cb and Cr on different quantization tables, Adobe RGB, and data
    that ends before EOI or does not decode.  Grey files get zero chroma
    on the 4:2:0 grid when their luma grid is even, else on the 4:4:4
    grid.  Raises when the decoder cannot be built (no g++)."""
    if is_adobe_rgb(data):
        return None
    lib = _coeffs.load()
    if lib is None:
        raise RuntimeError(
            "the JPEG coefficient decoder (research_image_retrieval_tpu_torch"
            "/csrc/jpeg_coeffs.cc) did not build with g++ into build/native/")
    i = ctypes.c_int
    h, w, by, bx, cby, cbx, ss = i(), i(), i(), i(), i(), i(), i()
    ref = ctypes.byref
    if lib.rir_coeff_dims(data, len(data), ref(h), ref(w), ref(by), ref(bx),
                          ref(cby), ref(cbx), ref(ss)) != 0:
        return None
    coef_y = np.empty((by.value, bx.value, k, k), np.int16)
    coef_c = np.zeros((2, max(cby.value, 1), max(cbx.value, 1), k, k),
                      np.int16)
    quant_y = np.empty((k, k), np.float32)
    quant_c = np.ones((k, k), np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    if lib.rir_coeffs(data, len(data), k, ptr(coef_y), coef_y.nbytes,
                      ptr(coef_c), coef_c.nbytes, ptr(quant_y), ptr(quant_c),
                      ref(h), ref(w), ref(by), ref(bx), ref(cby), ref(cbx),
                      ref(ss)) != 0:
        return None
    subsamp = ss.value
    if subsamp == 0:  # grey: neutral chroma on a grid the device can read
        Y, X = by.value, bx.value
        subsamp = 2 if Y % 2 == 0 and X % 2 == 0 else 1
        f = 2 if subsamp == 2 else 1
        coef_c = np.zeros((2, Y // f, X // f, k, k), np.int16)
    return JpegCoeffs(coef_y, coef_c, quant_y, quant_c, h.value, w.value,
                      subsamp, k)
