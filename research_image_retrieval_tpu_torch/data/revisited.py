"""Revisited Oxford/Paris test-set configuration loader
(a copy of ``research_image_retrieval_tpu/data/revisited.py``).

Loads ``gnd_{dataset}.pkl`` (imlist / qimlist / gnd: per-query
easy/hard/junk + query bbx) and builds image paths.  The pickle is the
dataset's own file; load only files from a source you trust.
"""

from __future__ import annotations

import os
import pickle

__all__ = ["DATASETS", "RevisitedDataset"]

DATASETS = ("oxford5k", "paris6k", "roxford5k", "rparis6k")


class RevisitedDataset:
    """Test-set config for the (Revisited) Oxford/Paris protocol.

    Args:
      dataset: one of oxford5k / paris6k / roxford5k / rparis6k.
      dir_main: root directory containing ``{dataset}/gnd_{dataset}.pkl``
        and the jpg images under ``{dataset}/jpg/``.

    Attributes:
      imlist / qimlist: gallery and query image names.
      gnd: per-query ground truth dicts (easy/hard/junk [+ bbx]).
      n / nq: gallery / query sizes.
    """

    ext = ".jpg"
    qext = ".jpg"

    def __init__(self, dataset: str, dir_main: str):
        dataset = dataset.lower()
        if dataset not in DATASETS:
            raise ValueError(f"Unknown dataset: {dataset}")
        self.dataset = dataset
        self.dir_data = os.path.join(dir_main, dataset)
        self.dir_images = os.path.join(self.dir_data, "jpg")
        with open(os.path.join(self.dir_data, f"gnd_{dataset}.pkl"),
                  "rb") as f:
            cfg = pickle.load(f)
        self.imlist = cfg["imlist"]
        self.qimlist = cfg["qimlist"]
        self.gnd = cfg["gnd"]
        self.n = len(self.imlist)
        self.nq = len(self.qimlist)

    def im_fname(self, i: int) -> str:
        return os.path.join(self.dir_images, self.imlist[i] + self.ext)

    def qim_fname(self, i: int) -> str:
        return os.path.join(self.dir_images, self.qimlist[i] + self.qext)

    @property
    def im_fnames(self):
        return [self.im_fname(i) for i in range(self.n)]

    @property
    def qim_fnames(self):
        return [self.qim_fname(i) for i in range(self.nq)]

    def query_bbx(self, i: int):
        """Query crop box (x1, y1, x2, y2) or None."""
        g = self.gnd[i]
        return tuple(g["bbx"]) if "bbx" in g else None
