"""Training and evaluation settings (port of
``research_image_retrieval_tpu/utils/config.py``): ``TrainConfig`` with
the JAX fields and defaults plus ``device``, the presets of the families
the port has (``gem_r50``, ``gem_r101``, ``token_r101``, ``spca_r101``,
``dolg_r101``, ``solar_r101``, ``delg_r50``, ``how_vlad_r50``,
``how_asmk_r50``, ``sosnet_r50``, ``spoc_r50``, ``senet_g2_r50``,
``ultron_s``, ``adaptive_hybrid_r50``, ``sparse_r50``, ``hamlet_r50``:
all of the JAX package's), and ``EvalConfig`` with the fields that the
ported evaluation driver and ``cli.evaluate`` read.
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["EvalConfig", "PRESETS", "TrainConfig", "get_preset"]


@dataclasses.dataclass
class TrainConfig:
    """Training hyperparameters: the JAX ``TrainConfig``'s fields and
    defaults, plus ``device``."""

    model: str = "gem_r50"
    model_overrides: dict = dataclasses.field(default_factory=dict)

    # data
    data_root: str = ""
    csv_path: str = ""
    imsize: int = 512
    batch_size: int = 128
    num_workers: int = 8
    seed: int = 11
    val_per_class: int = 1
    # ship RAW uint8 batches and normalize (x/255 - mean)/std on the
    # device in the train/eval steps (4x fewer H2D bytes); augmentation
    # then runs in uint8 space.  False normalizes on the host.
    raw_input: bool = True
    # synthetic-fallback dataset shape (used when no data_root is set)
    synthetic_classes: int = 16
    synthetic_samples: int = 16  # train samples per class
    synthetic_val_samples: int = 4  # val samples per class
    # yield the synthetic fixture as RAW uint8, so the driver's on-device
    # normalization carries it; off by default (float [0, 1] images)
    synthetic_uint8: bool = False

    # optimization
    optimizer: str = "sgd"  # or "adamw", "adamw_then_sgd" (ULTRON)
    base_lr: float = 0.01
    final_lr: float = 1e-6
    warmup_lr: float = 1e-6
    warmup_epochs: int = 1
    num_epochs: int = 100
    momentum: float = 0.9
    weight_decay: float = 1e-4
    clip_max_norm: float = 1.0
    update_every: int = 1  # gradient accumulation
    switch_epoch: int = 5  # optimizer hand-off epoch for adamw_then_sgd

    # parallelism: one device; data_parallel / model_parallel > 1 raise
    data_parallel: int | None = None
    model_parallel: int = 1

    # backbone compute dtype of models with a ``dtype`` field: "" (fp32,
    # the default on CUDA as on every JAX platform but the TPU), "float32"
    # or "bfloat16"; an explicit model_overrides["dtype"] wins
    compute_dtype: str = ""

    # offline LLM-distillation teacher of the distillation models (sparse,
    # hamlet): a [num_classes, text_dim] table built once on the host
    # (data/teacher.py), gathered by label in the train step
    teacher: bool = False
    teacher_texts: str = ""  # one text per line, line i = class i; "" = synthetic template
    teacher_model: str = "distilbert-base-uncased"
    teacher_max_length: int = 64
    teacher_allow_random: bool = False

    # checkpointing / logging
    directory: str = "checkpoints"
    save_freq: int = 1
    keep_every: int = 5
    val_epoch: int = 1
    print_freq: int = 200
    resume: str | None = None
    # TensorBoard event files alongside JSONL; needs the tensorboard
    # package (raises without it)
    tensorboard: bool = False
    # redraw <directory>/curves.png every N epochs (train/plots.py); where
    # matplotlib is missing the driver says so once and stops plotting
    plot_freq: int = 1

    # "cuda" (raises without a card) or "cpu"
    device: str = "cuda"


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
    # the split JPEG decode with k x k coefficients per block (0: off):
    # the host entropy-decodes, the device finishes the decode; needs
    # device_scales
    dct_decode: int = 0
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
    # learned iterative query expansion (index/qe.py); the MLP's weights
    # come from iqe_checkpoint (.pt or flattened-flax .npz), else its
    # random init (a warning says so)
    iqe: bool = False
    iqe_k: int = 5
    iqe_iterations: int = 2
    iqe_gamma: float = 0.6
    iqe_checkpoint: str | None = None
    # SuperGlobal-style global-feature reranking (index/superglobal.py)
    superglobal: bool = False
    sg_m: int = 100  # shortlist size to refine
    # CVNet correlation-verification reranking of the top rerank_k
    # (models/cvnet.py + index/rerank.make_cvnet_batch_scorer): feature
    # maps of rerank_imsize square images from a rerank_backbone encoder;
    # weights from rerank_checkpoint (.pt or flattened-flax .npz), else
    # seeded random ones (a warning says so)
    cvnet_rerank: bool = False
    rerank_backbone: str = "resnet50"
    rerank_checkpoint: str | None = None
    # DELG local-feature geometric (affine-RANSAC) reranking of the top
    # rerank_k (index/rerank.py): needs a model with extract_local (the
    # delg family); locals from rerank_imsize square images, the
    # lr_top_attn highest-attention cells each; the inlier share is
    # blended with the first-stage score (rerank_blend: its weight)
    local_rerank: bool = False
    lr_top_attn: int = 128
    rerank_k: int = 20
    rerank_blend: float = 0.5
    rerank_imsize: int = 224


# Per-model experiment presets (the JAX package's, for the models the
# port has).
PRESETS: dict[str, dict[str, Any]] = {
    "gem_r50": dict(
        model="gem_r50", optimizer="sgd", base_lr=0.01, num_epochs=100,
        model_overrides=dict(s=32.0, m=0.15),
    ),
    "gem_r101": dict(model="gem_r101", optimizer="sgd", base_lr=0.01),
    "token_r101": dict(
        model="token_r101", optimizer="sgd", base_lr=0.01,
    ),
    "spca_r101": dict(
        # reference spca_training_example.sh + config/meta.yml defaults
        model="spca_r101", optimizer="sgd", base_lr=0.01,
        model_overrides=dict(K=16, local_dim=128, multi=1, combine="cro",
                             outputdim=2048, s=45.0, m=0.2),
    ),
    "dolg_r101": dict(
        model="dolg_r101", optimizer="sgd", base_lr=0.01,
        model_overrides=dict(s=30.0, m=0.15),
    ),
    "solar_r101": dict(model="solar_r101", optimizer="sgd", base_lr=0.01),
    "delg_r50": dict(model="delg_r50", optimizer="adamw", base_lr=1e-3),
    "how_vlad_r50": dict(model="how_vlad_r50", optimizer="adamw", base_lr=1e-3),
    "how_asmk_r50": dict(model="how_asmk_r50", optimizer="adamw", base_lr=1e-3),
    "sosnet_r50": dict(model="sosnet_r50", optimizer="adamw", base_lr=1e-3),
    "spoc_r50": dict(model="spoc_r50", optimizer="sgd", base_lr=0.01),
    "senet_g2_r50": dict(model="senet_g2_r50", optimizer="sgd", base_lr=0.01),
    "ultron_s": dict(
        # ULTRON paper schedule: AdamW(1e-3) x5 -> SGD(1e-2 cosine) x35
        model="ultron_s", optimizer="adamw_then_sgd", base_lr=1e-3,
        num_epochs=40, switch_epoch=5, batch_size=128, imsize=512,
        clip_max_norm=1.0, weight_decay=0.05,
    ),
    "adaptive_hybrid_r50": dict(
        model="adaptive_hybrid_r50", optimizer="adamw", base_lr=1e-3,
        num_epochs=8,
    ),
    "sparse_r50": dict(model="sparse_r50", optimizer="adamw", base_lr=1e-3),
    "hamlet_r50": dict(model="hamlet_r50", optimizer="adamw", base_lr=1e-3),
}


def get_preset(name: str, **overrides) -> TrainConfig:
    """Build a TrainConfig from a preset name plus overrides."""
    if name not in PRESETS:
        raise KeyError(f"Unknown preset '{name}'. Available: {sorted(PRESETS)}")
    cfg = dict(PRESETS[name])
    model_overrides = {**cfg.pop("model_overrides", {}),
                       **overrides.pop("model_overrides", {})}
    return TrainConfig(model_overrides=model_overrides, **{**cfg, **overrides})
