"""Training CLI (port of ``research_image_retrieval_tpu/cli/train.py``:
the same flags, plus ``--device``).

    python -m research_image_retrieval_tpu_torch.cli.train --preset gem_r50 \
        --data-root /data/train.rirrec [--device cpu]

``--data-root`` names a ``.rirrec`` record file (``cli.pack``) or, with
``--csv-path``, a GLDv2 image tree; without it the run trains on the
deterministic synthetic classes.  ``--dtype bfloat16`` computes the
backbone in bf16 (parameters, losses and optimizer stay fp32); fp32 is
the default.  Multi-GPU: one process per GPU,

    torchrun --nproc_per_node=N -m research_image_retrieval_tpu_torch.cli.train \
        --data-parallel N [--model-parallel M] ...

trains over an ``N x M`` layout of ``N * M`` processes (NCCL; ``--device
cpu`` runs gloo) with the single-device run's global batch and semantics
(``train/driver.py``).  A layout that is not the world size, or > 1
without a launcher, raises with how to launch it.  ``--teacher`` (sparse_r50, hamlet_r50)
builds the text teacher's class table once on the host and distills
from it; it needs the ``transformers`` package, and
``--teacher-allow-random`` without cached pretrained files.

``--resume`` continues a run exactly on the CPU.  On CUDA it is bit-exact
only when the whole run, first part and resumed part, executes inside
``utils.profiling.deterministic_mode()`` with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` set before the process starts;
cuDNN's default algorithms are not deterministic.
"""

from __future__ import annotations

import argparse
import dataclasses

from research_image_retrieval_tpu_torch.utils.config import (
    PRESETS,
    TrainConfig,
    get_preset,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="retrieval training (PyTorch)")
    p.add_argument("--preset", default="gem_r50", choices=sorted(PRESETS),
                   help="model preset")
    p.add_argument("--list-presets", action="store_true")
    p.add_argument("--data-root", default="",
                   help="a .rirrec record file, or the GLDv2 image root "
                        "(with --csv-path)")
    p.add_argument("--csv-path", default="", help="train_clean.csv path")
    p.add_argument("--imsize", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--num-epochs", type=int, default=None)
    p.add_argument("--base-lr", type=float, default=None)
    p.add_argument("--final-lr", type=float, default=None)
    p.add_argument("--warmup-epochs", type=int, default=None)
    p.add_argument("--weight-decay", type=float, default=None)
    p.add_argument("--update-every", type=int, default=None,
                   help="gradient accumulation steps")
    p.add_argument("--clip-max-norm", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--directory", default=None, help="checkpoint directory")
    p.add_argument("--resume", default=None,
                   help="'latest' or an epoch_NNNNN.pt path; bit-exact on "
                        "CUDA only inside utils.profiling."
                        "deterministic_mode() (see the module docstring)")
    p.add_argument("--save-freq", type=int, default=None)
    p.add_argument("--num-workers", type=int, default=None)
    p.add_argument("--data-parallel", type=int, default=None,
                   help="ranks on the data axis (default: the world size "
                        "over --model-parallel); > 1 needs torchrun "
                        "--nproc_per_node=data x model")
    p.add_argument("--model-parallel", type=int, default=None,
                   help="ranks that split the ArcFace classifier on its "
                        "feature dimension (default 1: kept whole)")
    p.add_argument("--dtype", dest="compute_dtype", default=None,
                   choices=("float32", "bfloat16"),
                   help="backbone compute dtype (default float32); the "
                        "parameters, losses and optimizer stay float32")
    p.add_argument("--host-norm", dest="raw_input", action="store_false",
                   default=None,
                   help="normalize inputs on the host (float32 batches) "
                        "instead of shipping uint8 and normalizing on the "
                        "device")
    p.add_argument("--teacher", action="store_true", default=None,
                   help="distill from an offline text teacher's class "
                        "table (models with text_features: sparse, "
                        "hamlet)")
    p.add_argument("--teacher-texts", default=None)
    p.add_argument("--teacher-model", default=None)
    p.add_argument("--teacher-allow-random", dest="teacher_allow_random",
                   action="store_true", default=None)
    p.add_argument("--max-steps-per-epoch", type=int, default=None,
                   help="debug: cap steps per epoch")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def config_from_args(args) -> TrainConfig:
    overrides = {}
    for field in dataclasses.fields(TrainConfig):
        key = field.name.replace("_", "-")
        val = getattr(args, field.name, None)
        if val is not None and key not in ("model", "model-overrides"):
            overrides[field.name] = val
    overrides.pop("model", None)
    overrides.pop("model_overrides", None)
    return get_preset(args.preset, **overrides)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.list_presets:
        for name in sorted(PRESETS):
            print(name)
        return 0
    cfg = config_from_args(args)
    print(">> config:", cfg)
    from research_image_retrieval_tpu_torch.train.driver import train

    train(cfg, max_steps_per_epoch=args.max_steps_per_epoch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
