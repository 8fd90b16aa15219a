"""Query expansion: alpha-weighted QE
(port of ``alpha_query_expansion`` of
``research_image_retrieval_tpu/index/qe.py``; the learned
``IterativeQueryExpansion`` is not ported yet).
"""

from __future__ import annotations

import torch

from research_image_retrieval_tpu_torch.ops.norm import l2_normalize
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["alpha_query_expansion"]


@fp32_precision()
def alpha_query_expansion(queries: torch.Tensor, gallery: torch.Tensor,
                          k: int = 10, alpha: float = 3.0) -> torch.Tensor:
    """alphaQE (Radenovic et al.): each query plus its top-k gallery
    neighbours weighted by ``max(score, 0) ** alpha``, re-L2-normalized;
    ``alpha=0`` is average QE.

    Args:
      queries: [Q, D] L2-normalized tensor.
      gallery: [N, D] L2-normalized tensor on the same device.

    Returns:
      [Q, D] expanded, L2-normalized fp32 queries.
    """
    q = queries.to(torch.float32)
    g = gallery.to(torch.float32)
    scores, idx = torch.topk(q @ g.T, min(k, g.shape[0]), dim=1)
    w = torch.clamp(scores, min=0.0) ** alpha                   # [Q, k]
    agg = q + torch.einsum("qk,qkd->qd", w, g[idx])
    return l2_normalize(agg, dim=-1)
