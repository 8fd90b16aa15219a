"""Device selection and the fp32 numerics contract of the port.

Every entry point of the port takes an explicit ``device`` that defaults
to ``"cuda"``; asking for CUDA on a machine without a card raises instead
of falling back to the CPU.  The CPU is used only when the caller names
it (the tests do).
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["fp32_precision", "resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    there is no card (never a silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU")
    return dev


class _Fp32Scope:
    """Process-wide count of open ``fp32_precision`` blocks.  The TF32
    flags are global, so with blocks open on several threads (the search
    worker and an HTTP handler extracting an image) the first block to
    open saves the caller's flags and the last to close restores them;
    a block never sees TF32 turned back on under it."""

    lock = threading.Lock()
    depth = 0
    saved = None


@contextlib.contextmanager
def fp32_precision():
    """Full fp32 (TF32 off) for the cuDNN convolutions and cuBLAS matmuls
    run inside the block; the caller's settings are restored when the
    last open block (on any thread) exits.

    cuDNN runs fp32 convolutions in TF32 by default (about three decimal
    digits), which breaks the 1e-4 descriptor parity with the JAX
    reference (whose device resize is ``Precision.HIGHEST``).  Each module
    that calls cuDNN or cuBLAS wraps its own calls in this (also usable
    as a decorator), so a direct ``model.extract`` is fp32 too and no
    process-wide flag is left changed.
    """
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    with _Fp32Scope.lock:
        if _Fp32Scope.depth == 0:
            _Fp32Scope.saved = cudnn.allow_tf32, matmul.allow_tf32
            cudnn.allow_tf32 = matmul.allow_tf32 = False
        _Fp32Scope.depth += 1
    try:
        yield
    finally:
        with _Fp32Scope.lock:
            _Fp32Scope.depth -= 1
            if _Fp32Scope.depth == 0:
                cudnn.allow_tf32, matmul.allow_tf32 = _Fp32Scope.saved
