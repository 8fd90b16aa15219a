"""The arithmetic of the references' products: fp32, or TF32 for the
control (see the package docstring).

On CUDA the control runs on the TF32 tensor cores themselves (cuDNN's
and cuBLAS's TF32 switches on for the block, forward and backward); on
the CPU, which has no TF32, every operand is rounded to TF32 as the
tensor cores round it, and the products are taken in fp32."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

__all__ = ["conv2d", "linear", "matmul", "round_tf32", "scope"]


def round_tf32(v: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest, ties away from
    zero, as the tensor cores' conversion rounds."""
    bits = v.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _RoundBoth(torch.autograd.Function):
    """Round the value forward and its gradient backward: the operand of
    a product, and the incoming gradient a backward product reads."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def _operands(precision: str, *xs):
    if precision not in ("fp32", "tf32"):
        raise ValueError(f"precision {precision!r}: fp32 or tf32")
    if precision == "fp32" or xs[0].device.type != "cpu":
        return xs
    return tuple(_RoundBoth.apply(x) for x in xs)


def _out(precision: str, y):
    if precision == "fp32" or y.device.type != "cpu":
        return y
    return _RoundBoth.apply(y)


@contextlib.contextmanager
def scope(precision: str):
    """cuDNN's and cuBLAS's TF32 switches for the block: on for the
    control (``"tf32"``), off for ``"fp32"``; restored after."""
    cudnn, mm = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, mm.allow_tf32
    cudnn.allow_tf32 = mm.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        cudnn.allow_tf32, mm.allow_tf32 = saved


def conv2d(x, w, precision: str, stride: int = 1, padding: int = 0):
    x, w = _operands(precision, x, w)
    return _out(precision, F.conv2d(x, w, stride=stride, padding=padding))


def matmul(a, b, precision: str):
    a, b = _operands(precision, a, b)
    return _out(precision, a @ b)


def linear(x, w, b, precision: str):
    return matmul(x, w.t(), precision) + b
