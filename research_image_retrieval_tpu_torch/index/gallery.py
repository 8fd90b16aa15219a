"""Indexed-gallery search with query-adaptive fusion
(port of ``research_image_retrieval_tpu/index/gallery.py``).

``add`` extracts each image's descriptor set (an ``AdaptiveHybridModel``'s
SC-GeM, Regional-GeM and Scale-GeM) into sets that stay on the model's
device; ``search`` fuses the gallery sets with QAFF, guided by the
query's SC-GeM, scores the equal-weight query against them (fp32 cosine,
TF32 off) and takes the top k.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from research_image_retrieval_tpu_torch.ops.norm import l2_normalize
from research_image_retrieval_tpu_torch.utils.device import (
    fp32_precision,
    resolve_device,
)

__all__ = ["HybridGallery"]


class HybridGallery:
    """Gallery of multi-descriptor sets with QAFF search.

    Args:
      model: an ``AdaptiveHybridModel`` (or any model whose
        ``descriptors(x)`` returns a tuple of per-type embeddings); it is
        moved to ``device`` and put in eval mode.
      qaff: a ``QAFF`` module (moved and put in eval mode the same way).
      batch_size: extraction batch of ``add``.
      device: ``"cuda"`` (default; raises without a card) or ``"cpu"``.
    """

    def __init__(self, model, qaff, batch_size: int = 32, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.qaff = qaff.to(self.device).eval()
        self.batch_size = batch_size
        self._sets: list[torch.Tensor] | None = None
        self.labels: np.ndarray | None = None
        self.paths: list[str] | None = None

    @torch.no_grad()
    def _extract(self, images) -> tuple:
        x = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        return self.model.descriptors(x)

    def add(self, images, labels=None, paths: Sequence[str] | None = None):
        """Extract and append the descriptor sets of ``images`` ([N, H, W,
        3] normalized float images)."""
        images = np.asarray(images)
        chunks = [self._extract(images[i:i + self.batch_size])
                  for i in range(0, len(images), self.batch_size)]
        new = [torch.cat([c[t] for c in chunks]) for t in range(len(chunks[0]))]
        if self._sets is None:
            self._sets = new
            self.labels = np.asarray(labels) if labels is not None else None
            self.paths = list(paths) if paths is not None else None
        else:
            self._sets = [torch.cat([old, n]) for old, n in zip(self._sets,
                                                                  new)]
            if labels is not None:
                self.labels = np.concatenate([self.labels, np.asarray(labels)])
            if paths is not None:
                self.paths = (self.paths or []) + list(paths)

    def __len__(self):
        return 0 if self._sets is None else self._sets[0].shape[0]

    @torch.no_grad()
    @fp32_precision()
    def search(self, query_image, top_k: int = 10):
        """Single-stage QAFF search of one query image ([H, W, 3] or
        [1, H, W, 3]).

        Returns:
          (scores [Q, k], indices [Q, k], paths list-of-lists or None)
        """
        if self._sets is None:
            raise ValueError("Gallery is empty. Call add() first.")
        q = np.asarray(query_image)
        if q.ndim == 3:
            q = q[None]
        query_sets = self._extract(q)
        k = min(top_k, len(self))
        guide = query_sets[0]  # SC-GeM guides the fusion
        n = self._sets[0].shape[0]
        fused_gallery = self.qaff(guide.expand(n, guide.shape[-1]),
                                  list(self._sets))
        query_fused = sum(query_sets) / len(query_sets)  # equal weights
        sims = l2_normalize(query_fused) @ l2_normalize(fused_gallery).t()
        scores, idx = torch.topk(sims, k, dim=1)
        idx_np = idx.cpu().numpy()
        out_paths = ([[self.paths[j] for j in row] for row in idx_np]
                     if self.paths is not None else None)
        return scores.cpu().numpy(), idx_np, out_paths
