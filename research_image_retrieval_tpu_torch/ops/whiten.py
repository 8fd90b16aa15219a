"""PCA whitening with shrinkage
(port of ``research_image_retrieval_tpu/ops/whiten.py``).

Learning runs on the host (numpy, fp64 eigendecomposition, once per index
build; a copy of the JAX package's learner); application is a subtract
and an fp32 matmul on the descriptors' device, optionally truncated for
dimensionality reduction: ``y = (x - m) @ P[:k].T``.
"""

from __future__ import annotations

import numpy as np
import torch

from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["apply_whitening", "pca_whiten_learn"]


def pca_whiten_learn(X: np.ndarray, s: float = 1.0):
    """Learn PCA whitening with shrinkage ``s`` from descriptors ``X`` [N, D].

    Returns:
      m: [D] mean descriptor.
      P: [D, D] projection with rows sorted by decreasing eigenvalue;
         row i is scaled by ``eigval_i ** (-s/2)``.

    ``s=1`` is full whitening; ``s<1`` shrinks the spectrum flattening.
    """
    X = np.asarray(X, dtype=np.float64)
    n = X.shape[0]
    m = X.mean(axis=0)
    Xc = X - m
    cov = Xc.T @ Xc
    cov = (cov + cov.T) / (2.0 * n)
    eigval, eigvec = np.linalg.eigh(cov)  # ascending, real-symmetric
    order = np.argsort(eigval)[::-1]
    eigval = np.clip(eigval[order], 1e-14, None)
    eigvec = eigvec[:, order]
    P = (eigvec * eigval ** (-0.5 * s)).T  # rows = lambda^{-s/2} * v^T
    return m.astype(np.float32), P.astype(np.float32)


@fp32_precision()
def apply_whitening(x: torch.Tensor, m, P, out_dim: int | None = None):
    """``(x - m) @ P[:out_dim].T`` in fp32 on ``x``'s device.

    x: [..., D] tensor; m: [D]; P: [D, D] (numpy or tensors).
    """
    m = torch.as_tensor(m, dtype=torch.float32, device=x.device)
    P = torch.as_tensor(P, dtype=torch.float32, device=x.device)
    Pk = P if out_dim is None else P[:out_dim]
    return (x.to(torch.float32) - m) @ Pk.T
