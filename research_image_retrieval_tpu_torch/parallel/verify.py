"""Multi-GPU training correctness as a checkable claim (port of
``research_image_retrieval_tpu/parallel/verify.py``).

The claim is JAX's: a train step over a ``data x model`` layout of ranks
equals the single-device step on the same global batch (gradients
averaged over the global batch, BN statistics of the global batch, the
classifier's sharded dot products summed), up to reduction order.
``sharded_step_equivalence`` runs both on every rank of the layout (the
layout's step on this rank's rows, the single-device step on the whole
global batch) and reports the largest deviations.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from research_image_retrieval_tpu_torch.parallel.mesh import data_sharding
from research_image_retrieval_tpu_torch.utils.device import resolve_device

__all__ = ["sharded_step_equivalence"]


def _max_abs_diff(a: dict, b: dict) -> float:
    worst = 0.0
    for k in a:
        d = (a[k].to(torch.float64) - b[k].to(torch.float64)).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
    return worst


def sharded_step_equivalence(
    mesh,
    model_name: str = "gem_r50",
    backbone_name: str = "resnet18",
    steps: int = 2,
    batch_size: int = 8,
    imsize: int = 32,
    num_classes: int = 64,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    model_overrides: dict | None = None,
) -> dict:
    """Run ``steps`` train steps over ``mesh`` and on one device, from the
    same init and the same global batches (made from ``seed`` with
    numpy), on ``device`` (CUDA by default: raises without a card; pass
    "cpu" for the CPU); ``model_overrides`` go to ``get_model``.  Returns the largest absolute deviations on this
    rank::

        {"loss": .., "grad_norm": .., "params": .., "batch_stats": ..,
         "loss_value": .., "grad_norm_value": ..}

    (the layout's sharded parameters gathered whole first).  A layout
    that left BN per rank would deviate at the batch-statistic level
    (~1e-2), not at round-off."""
    from research_image_retrieval_tpu_torch.models import get_model
    from research_image_retrieval_tpu_torch.train import (
        TrainState,
        create_train_state,
        make_sgd_optimizer,
        make_train_step,
        shard_train_state,
        warmup_cosine_schedule,
    )

    device = resolve_device(device)
    sched = warmup_cosine_schedule(1, 1e-3, 4, 0.1, 1e-2, iter_per_epoch=10)
    tx = make_sgd_optimizer(sched, momentum=0.9, weight_decay=1e-4,
                            clip_max_norm=1.0)
    model = get_model(model_name, backbone_name=backbone_name,
                      outputdim=num_classes, num_classes=num_classes,
                      **(model_overrides or {}))
    state_s = create_train_state(model, seed, tx, device=device)
    model.to(dtype)  # drawn in float32 (float64 draws are slower)
    twin = copy.deepcopy(model)  # the same init, drawn once
    rng = torch.Generator()
    rng.set_state(state_s.rng.get_state())
    state_m = shard_train_state(TrainState(0, twin, tx.init(twin), rng), mesh)

    rng = np.random.default_rng(seed)
    batches = [(rng.standard_normal((batch_size, imsize, imsize, 3)),
                rng.integers(0, num_classes, batch_size))
               for _ in range(steps)]
    rows = data_sharding(mesh, batch_size)
    step_m = make_train_step(mesh=mesh)
    step_s = make_train_step()
    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    for images, labels in batches:
        x = tt(images).to(dtype)
        state_m, metrics_m = step_m(state_m, x[rows], tt(labels)[rows])
        state_s, metrics_s = step_s(state_s, x, tt(labels))

    whole_m = state_m.state_dict()["model"]
    whole_s = state_s.state_dict()["model"]
    params = {n for n, _ in state_s.model.named_parameters()}
    stats = [k for k in whole_s if "running" in k]
    return {
        "loss": abs(float(metrics_m["loss"]) - float(metrics_s["loss"])),
        "grad_norm": abs(float(metrics_m["grad_norm"])
                         - float(metrics_s["grad_norm"])),
        "params": _max_abs_diff({k: whole_m[k] for k in params},
                                {k: whole_s[k] for k in params}),
        "batch_stats": _max_abs_diff({k: whole_m[k] for k in stats},
                                     {k: whole_s[k] for k in stats}),
        "loss_value": float(metrics_s["loss"]),
        "grad_norm_value": float(metrics_s["grad_norm"]),
    }
