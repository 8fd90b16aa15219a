"""Evaluation settings (port of ``EvalConfig`` of
``research_image_retrieval_tpu/utils/config.py``, with the fields that the
ported driver and ``cli.evaluate`` read; the same names and defaults)."""

from __future__ import annotations

import dataclasses

__all__ = ["EvalConfig"]


@dataclasses.dataclass
class EvalConfig:
    """Extraction + Revisited evaluation settings."""

    model: str = "gem_r50"
    model_overrides: dict = dataclasses.field(default_factory=dict)
    datasets: tuple = ("roxford5k", "rparis6k")
    data_root: str = ""
    imsize: int = 1024
    multiscale: tuple = (1.0,)  # or (1.0, 2**-0.5, 0.5)
    # resolution-bucket quantum of the masked extraction
    bucket: int = 128
    # raw uint8 to the device, normalization and every scale's resize
    # there (one H2D transfer per image); False resizes on the host
    device_scales: bool = True
    # a .pt state dict (the port's model or a torchvision ResNet) or an
    # .npz of flax variables flattened with "/" keys
    checkpoint: str | None = None
    kappas: tuple = (1, 5, 10)
    alpha_qe: bool = False
    qe_k: int = 10
    qe_alpha: float = 3.0
    # PCA whitening learned on the gallery descriptors; 0 keeps the dim
    pca_whiten: bool = False
    pca_dim: int = 0
    pca_shrinkage: float = 1.0
