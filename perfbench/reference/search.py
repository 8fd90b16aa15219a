"""Plain quantized top-k search over a gallery the benchmark made.

Symmetric per-row quantization (``scale = max|x| / L``, floored at
1e-12; ``q = clip(round_half_even(x / scale), -L, L)``, ``L = 127`` for
int8 and ``7`` for int4, the control), the exact integer dot products
(in float64, exact for these sizes), then ``dot * (scale_q * scale_g)``
in fp32.  The gallery is quantized again here from its fp32 rows.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["LEVELS", "quantize", "scores"]

LEVELS = {"int8": 127.0, "int4": 7.0}


def quantize(x: torch.Tensor, kind: str = "int8"):
    """``(q as float64, scale fp32)`` of ``[n, D]`` fp32 rows."""
    level = torch.full((), LEVELS[kind], dtype=torch.float32,
                       device=x.device)
    x = x.to(torch.float32)
    scale = torch.clamp(x.abs().amax(dim=1) / level, min=1e-12)
    q = torch.clamp(torch.round(x / scale[:, None]), -level, level)
    return q.to(torch.float64), scale


def scores(queries: np.ndarray, blocks, kind: str = "int8"):
    """``[Q, N]`` fp32 scores of ``queries`` against the gallery rows that
    ``blocks`` yields as ``(start, [rows, D] fp32)``, on the blocks'
    device."""
    out = []
    qq = qs = None
    for _, blk in blocks:
        if qq is None:
            qq, qs = quantize(torch.as_tensor(queries, device=blk.device),
                              kind)
        gq, gs = quantize(blk, kind)
        dots = (qq @ gq.T).to(torch.float32)
        out.append(dots * (qs[:, None] * gs[None, :]))
    return torch.cat(out, dim=1)
