"""The device half of the split JPEG decode: dequantization, inverse DCT,
chroma upsampling and YCbCr -> RGB (port of
``research_image_retrieval_tpu/ops/jpeg_decode.py``).

The host half (``data.native_decode.decode_jpeg_coeffs``) only
entropy-decodes and ships the top-left ``k x k`` quantized coefficients
of each 8x8 block as int16: ``(k*k/64) * 1.5 * 2`` bytes per pixel
against 3 for RGB uint8, 4x fewer at k = 4.  The rest runs here, in plain
PyTorch on the tensors' device, in fp32 with TF32 off
(``utils.device.fp32_precision``).

JPEG's 2D DCT-II with its C_u/2 normalization is the orthonormal 2D DCT,
so a block F decodes as ``D^T F D`` with D the orthonormal 8-point DCT
matrix.  ``out_block`` n < 8 takes an n-point inverse DCT of the
top-left n x n coefficients scaled by ``sqrt(n/8)`` per dimension: the
block downscaled by 8/n (the DCT-domain prescale that stands in for
libjpeg's ``scale_denom``).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["dct_decode_rgb", "decode_dct_planes", "idct_block_basis"]


@lru_cache(maxsize=None)
def _basis_np(k: int, n: int) -> np.ndarray:
    """[k, n] basis B with pixels = B^T @ coeffs @ B per block; rows
    u >= n are zero (coefficients an n-pixel block cannot hold)."""
    B = np.zeros((k, n), np.float32)
    for u in range(min(k, n)):
        cu = math.sqrt(0.5) if u == 0 else 1.0
        for x in range(n):
            B[u, x] = (math.sqrt(2.0 / n) * cu
                       * math.cos((2 * x + 1) * u * math.pi / (2 * n)))
    return (B * math.sqrt(n / 8.0)).astype(np.float32)


def idct_block_basis(k: int, n: int = 8, device="cpu") -> torch.Tensor:
    return torch.from_numpy(_basis_np(k, n)).to(device)


@fp32_precision()
def decode_dct_planes(coefs: torch.Tensor, quant: torch.Tensor,
                      out_block: int = 8) -> torch.Tensor:
    """``[B, by, bx, k, k]`` quantized coefficients and ``[B, k, k]``
    dequantization tables -> ``[B, by*n, bx*n]`` fp32 plane (n =
    ``out_block``), level-shifted to 0..255, not clipped."""
    B, by, bx, k, _ = coefs.shape
    n = out_block
    deq = coefs.to(torch.float32) * quant[:, None, None].to(torch.float32)
    basis = idct_block_basis(k, n, coefs.device)
    px = torch.einsum("nyxuv,uh,vw->nyhxw", deq, basis, basis)
    return px.reshape(B, by * n, bx * n) + 128.0


def _upsample2_fancy(c: torch.Tensor) -> torch.Tensor:
    """2x separable triangular upsample of ``[B, H, W]`` (libjpeg's h2v2
    "fancy" filter: ``out[2i] = 3/4 c[i] + 1/4 c[i-1]``, ``out[2i+1] =
    3/4 c[i] + 1/4 c[i+1]``, edges replicated)."""

    def up(dim: int, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[dim]
        prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
        nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)],
                        dim)
        inter = torch.stack([0.75 * x + 0.25 * prev, 0.75 * x + 0.25 * nxt],
                            dim=dim + 1)
        shape = list(x.shape)
        shape[dim] *= 2
        return inter.reshape(shape)

    return up(2, up(1, c))


def dct_decode_rgb(coef_y: torch.Tensor, coef_c: torch.Tensor,
                   quant_y: torch.Tensor, quant_c: torch.Tensor,
                   subsamp: int, out_block: int = 8) -> torch.Tensor:
    """The whole device decode to RGB.

    Args:
      coef_y: [B, by, bx, k, k] int16 luma coefficients.
      coef_c: [B, 2, cby, cbx, k, k] int16 Cb and Cr coefficients (cby x
        cbx = by x bx at 4:4:4, by/2 x bx/2 at 4:2:0).
      quant_y / quant_c: [B, k, k] fp32 dequantization tables.
      subsamp: 1 = 4:4:4, 2 = 4:2:0.
      out_block: output pixels per 8x8 block (see ``decode_dct_planes``).

    Returns:
      [B, by*out_block, bx*out_block, 3] fp32 RGB in 0..255 (clipped).
    """
    y = decode_dct_planes(coef_y, quant_y, out_block)
    cb = decode_dct_planes(coef_c[:, 0], quant_c, out_block)
    cr = decode_dct_planes(coef_c[:, 1], quant_c, out_block)
    if subsamp == 2:
        cb = _upsample2_fancy(cb)
        cr = _upsample2_fancy(cr)
    # JFIF YCbCr -> RGB (BT.601, full range)
    cb = cb - 128.0
    cr = cr - 128.0
    r = y + 1.40200 * cr
    g = y - 0.34414 * cb - 0.71414 * cr
    b = y + 1.77200 * cb
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)
