"""Operation and byte counts of a ViT global descriptor.

Counted from the published architecture (Dosovitskiy et al., ICLR 2021)
at each image's own token count, never from the port's module tree or
its padded buckets.  A multiply-add is two operations; only the patch
convolution and the matrix products are counted (LayerNorm, GELU, the
softmax and GeM are left out, as ``work.py`` leaves BN and ReLU out).
"""

from __future__ import annotations

__all__ = ["attention_call_work", "vit_ops"]


def vit_ops(cfg: dict, h: int, w: int) -> float:
    """Operations of one ``h`` x ``w`` image (multiples of the patch):
    the patch convolution, per layer ``2 N (4 d^2 + 2 d mlp)`` for the
    projections and the MLP and ``4 N^2 d`` for the two attention
    products (N the patches plus the CLS token), and the whitening."""
    d, P, mlp = cfg["dim"], cfg["patch"], cfg["mlp"]
    patches = (h // P) * (w // P)
    n = patches + 1
    layer = 2 * n * (4 * d * d + 2 * d * mlp) + 4 * n * n * d
    return float(2 * patches * d * 3 * P * P + cfg["depth"] * layer
                 + 2 * 2 * d * cfg["outputdim"])


def attention_call_work(tokens, dim: int,
                        dtype_bytes: int = 4) -> tuple[float, float]:
    """(operations, bytes) of one multi-head self-attention call over
    images of ``tokens`` valid tokens each: the four ``dim x dim``
    projections and the two products over each image's own tokens; the
    bytes a fused kernel could not avoid: each image's tokens read and
    written once, the four weight matrices and the four biases."""
    ops = sum(8 * n * dim * dim + 4 * n * n * dim for n in tokens)
    nbytes = dtype_bytes * (2 * sum(tokens) * dim + 4 * dim * dim + 4 * dim)
    return float(ops), float(nbytes)
