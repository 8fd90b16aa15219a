"""Query expansion: alpha-weighted QE and the learned iterative expansion
(port of ``research_image_retrieval_tpu/index/qe.py``).

* ``alpha_query_expansion``: the expanded query is the score^alpha
  weighted sum of its top-k neighbours plus the query, re-L2-normalized.
* ``IterativeQueryExpansion``: an MLP maps [query, mean(top-k)] to an
  expanded query; scores blend as ``gamma * initial + (1 - gamma) *
  expanded``, repeated ``max_iterations`` times.  ``iqe_from_flax`` loads
  the JAX module's flax params into it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from research_image_retrieval_tpu_torch.ops.norm import l2_normalize
from research_image_retrieval_tpu_torch.utils.device import fp32_precision

__all__ = ["IterativeQueryExpansion", "alpha_query_expansion",
           "iqe_from_flax"]


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


class IterativeQueryExpansion(nn.Module):
    """Learned iterative QE (reference: manus/1_SPARSE/sparse_model.py:
    334-426), the JAX module's function on torch tensors.

    ``expansion_fc1`` / ``expansion_fc2`` are ``nn.Linear`` (2D -> D,
    D -> D) and compute what flax's ``Dense`` computes on converted params
    (``iqe_from_flax``).  Their init is torch's, not flax's draws: a
    random-init expansion ranks differently from the JAX one.
    """

    def __init__(self, embed_dim: int, top_k: int = 5,
                 max_iterations: int = 2, gamma: float = 0.6):
        super().__init__()
        self.embed_dim, self.top_k = embed_dim, top_k
        self.max_iterations, self.gamma = max_iterations, gamma
        self.expansion_fc1 = nn.Linear(2 * embed_dim, embed_dim)
        self.expansion_fc2 = nn.Linear(embed_dim, embed_dim)

    @fp32_precision()
    def forward(self, query_features: torch.Tensor,
                database_features: torch.Tensor) -> dict:
        """[Q, D] queries and [N, D] database vectors -> dict of
        ``expanded_query`` [Q, D] and ``initial_scores``,
        ``expanded_scores``, ``final_scores`` [Q, N]."""
        db = database_features.to(torch.float32)
        db_norm = l2_normalize(db, dim=-1)
        k = min(self.top_k, db.shape[0])
        q = query_features.to(torch.float32)
        initial = exp_scores = final = None
        for _ in range(self.max_iterations):
            scores = l2_normalize(q, dim=-1) @ db_norm.T
            _, idx = torch.topk(scores, k, dim=1)
            avg_top = db[idx].mean(dim=1)                      # [Q, D]
            combined = torch.cat([q, avg_top], dim=1)
            q = self.expansion_fc2(torch.relu(self.expansion_fc1(combined)))
            exp_scores = l2_normalize(q, dim=-1) @ db_norm.T
            final = self.gamma * scores + (1.0 - self.gamma) * exp_scores
            if initial is None:
                initial = scores
        return {"expanded_query": q, "initial_scores": initial,
                "expanded_scores": exp_scores, "final_scores": final}


def iqe_from_flax(params: dict) -> dict:
    """State dict of ``IterativeQueryExpansion`` from the JAX module's
    flax params (numpy arrays; ``{"params": ...}`` or the params tree
    itself): each Dense ``kernel [in, out]`` becomes ``weight [out, in]``."""
    params = params.get("params", params)
    sd = {}
    for name in ("expansion_fc1", "expansion_fc2"):
        sd[f"{name}.weight"] = torch.from_numpy(np.array(
            np.asarray(params[name]["kernel"]).T, np.float32))
        sd[f"{name}.bias"] = torch.from_numpy(np.array(
            params[name]["bias"], np.float32))
    return sd
