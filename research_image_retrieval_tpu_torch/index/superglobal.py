"""SuperGlobal-style reranking with global features only
(port of ``research_image_retrieval_tpu/index/superglobal.py``, numpy
there, torch ops on the caller's device here).

Within each query's top-M shortlist every candidate is refined by
GeM-aggregating it with its K nearest neighbours inside the shortlist,
the query by averaging it with its top few candidates, and the shortlist
is re-scored with the refined vectors, blended with the first-stage
scores (Shao et al., ICCV 2023).
"""

from __future__ import annotations

import numpy as np
import torch

from research_image_retrieval_tpu_torch.utils.device import (
    fp32_precision,
    resolve_device,
)

__all__ = ["gem_aggregate", "superglobal_rerank"]


def gem_aggregate(vecs: torch.Tensor, p: float = 100.0,
                  dim: int = 0) -> torch.Tensor:
    """Signed-power GeM of descriptor sets along ``dim``: ``sign(m) *
    |m|^(1/p)`` of ``m = mean(sign(v) * |v|^p)``, in float64 as the JAX
    function; returns float32.  p = 1 is the mean; large p approaches the
    signed entry of largest magnitude."""
    v = vecs.to(torch.float64)
    m = torch.mean(torch.sign(v) * torch.abs(v) ** p, dim=dim)
    return (torch.sign(m) * torch.abs(m) ** (1.0 / p)).to(torch.float32)


@fp32_precision()
def superglobal_rerank(qvecs, gvecs, scores, indices, knn: int = 10,
                       qe_top: int = 3, p: float = 100.0, beta: float = 0.5,
                       device="cuda"):
    """Rerank top-M shortlists with refined global descriptors.

    Args:
      qvecs: [Q, D] L2-normalized queries; gvecs: [N, D] L2-normalized
        gallery (numpy arrays or tensors).
      scores: [Q, M] first-stage scores, descending; indices: [Q, M]
        gallery ids of the shortlist.
      knn: neighbours (within the shortlist) for candidate refinement.
      qe_top: top candidates averaged into the refined query.
      p: GeM power of the candidate refinement.
      beta: weight of the first-stage score in the blend.
      device: where the shortlists are refined (all queries at once).

    Returns:
      (new_scores [Q, M], new_indices [Q, M]) as numpy, descending, ties
      in shortlist order.
    """
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    q, g, s = t(qvecs), t(gvecs), t(scores)
    idx = torch.as_tensor(np.asarray(indices), device=dev).long()
    Q, M = s.shape
    cand = g[idx]                                              # [Q, M, D]
    # query-side expansion: mean of the query and its best candidates
    q_ref = torch.cat([q[:, None], cand[:, :qe_top]], dim=1).mean(dim=1)
    q_ref = q_ref / (torch.linalg.vector_norm(q_ref, dim=1,
                                              keepdim=True) + 1e-12)
    # database-side expansion inside the shortlist
    k = min(knn, M - 1)
    if k > 0:
        sim = cand @ cand.transpose(1, 2)                      # [Q, M, M]
        sim.diagonal(dim1=1, dim2=2).fill_(-float("inf"))
        nbr = torch.topk(sim, k, dim=2).indices                # [Q, M, k]
        rows = torch.arange(Q, device=dev)[:, None, None]
        group = torch.cat([cand[:, :, None], cand[rows, nbr]], dim=2)
        cand_ref = gem_aggregate(group, p=p, dim=2)
    else:
        cand_ref = cand
    cand_ref = cand_ref / (torch.linalg.vector_norm(cand_ref, dim=2,
                                                    keepdim=True) + 1e-12)
    refined = (cand_ref @ q_ref[:, :, None])[..., 0]           # [Q, M]
    combined = beta * s + (1.0 - beta) * refined
    order = torch.argsort(-combined, dim=1, stable=True)
    return (torch.gather(combined, 1, order).cpu().numpy(),
            torch.gather(idx, 1, order).cpu().numpy().astype(
                np.asarray(indices).dtype))
