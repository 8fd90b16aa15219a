"""One rank of ``tests/test_torch_dist_multiprocess.py``'s two-process
run (gloo on the CPU; the port only, no JAX).

    python tests/torch_dist_child.py IN.pt OUT_DIR

with ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` set.
``IN.pt`` holds the initial port state dict (float64), the global
batches and the schedule.  Rank 0 writes ``OUT_DIR/steps.pt``: the
state and metrics after the batches on the ``(2, 1)`` and ``(1, 2)``
layouts, and after the ``(2, 1)`` steps with BN left per rank (the
negative control).  Then both ranks train through ``driver.train`` on
both layouts (``OUT_DIR/driver_<layout>``), resume the ``(2, 1)`` run
from its first epoch, and continue ``IN.pt``'s one-process checkpoint
on the ``(1, 2)`` layout; rank 0 writes ``OUT_DIR/driver.json``.
"""

from __future__ import annotations

import json
import os
import sys
import types

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from research_image_retrieval_tpu_torch.models import backbone  # noqa: E402
from research_image_retrieval_tpu_torch.models import get_model  # noqa: E402
from research_image_retrieval_tpu_torch.parallel import (  # noqa: E402
    data_sharding,
    get_rank,
    init_distributed_mode,
    make_mesh,
)
from research_image_retrieval_tpu_torch.train import (  # noqa: E402
    TrainState,
    make_sgd_optimizer,
    make_train_step,
    shard_train_state,
    warmup_cosine_schedule,
)
from research_image_retrieval_tpu_torch.train import driver  # noqa: E402
from research_image_retrieval_tpu_torch.utils.config import (  # noqa: E402
    get_preset,
)


def _steps(spec: dict, layout, local_bn: bool = False) -> dict:
    model = get_model("gem_r50", **spec["model"]).double()
    model.load_state_dict(spec["init"])
    tx = make_sgd_optimizer(warmup_cosine_schedule(*spec["sched"]),
                            weight_decay=1e-4, clip_max_norm=1.0)
    mesh = make_mesh(*layout)
    state = shard_train_state(
        TrainState(0, model, tx.init(model), torch.Generator()), mesh)
    step = make_train_step(None, mesh=mesh)
    saved = backbone.collectives
    if local_bn:  # the backbone's BN sees no layout; nothing else changes
        backbone.collectives = types.SimpleNamespace(data_axis=lambda: None)
    try:
        metrics = []
        for x, y in spec["batches"]:
            rows = data_sharding(mesh, x.shape[0])
            state, m = step(state, x[rows], y[rows])
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        backbone.collectives = saved
    return {"state": state.state_dict()["model"], "metrics": metrics}


def _driver_cfg(spec: dict, directory: str, **kw):
    return get_preset("gem_r50", **{**spec["driver_cfg"],
                                    "directory": directory, **kw})


def main() -> int:
    torch.set_num_threads(1)
    spec_path, out = sys.argv[1], sys.argv[2]
    spec = torch.load(spec_path, weights_only=False)
    init_distributed_mode(device="cpu", quiet_non_main=True)
    rank = get_rank()

    steps = {f"{d}x{m}": _steps(spec, (d, m)) for d, m in ((2, 1), (1, 2))}
    steps["2x1 local BN"] = _steps(spec, (2, 1), local_bn=True)
    if rank == 0:
        torch.save(steps, os.path.join(out, "steps.pt"))

    runs = {}
    for d, m in ((2, 1), (1, 2)):
        key = f"{d}x{m}"
        cfg = _driver_cfg(spec, os.path.join(out, f"driver_{key}"),
                          data_parallel=d, model_parallel=m)
        state, hist = driver.train(cfg, max_steps_per_epoch=2)
        runs[key] = {"history": hist, "step": state.step}
    # --resume at the same world size: epoch 1 from the (2, 1) run's
    # first checkpoint, against its straight run
    cfg = _driver_cfg(spec, os.path.join(out, "driver_2x1"),
                      data_parallel=2, model_parallel=1,
                      resume=os.path.join(out, "driver_2x1",
                                          "epoch_00001.pt"))
    _, hist = driver.train(cfg, max_steps_per_epoch=2)
    runs["2x1 resumed"] = {"history": hist}
    # a one-process checkpoint continued on (1, 2)
    cfg = _driver_cfg(spec, os.path.join(out, "driver_1x2_from_one"),
                      data_parallel=1, model_parallel=2,
                      resume=spec["one_process_ckpt"])
    state, hist = driver.train(cfg, max_steps_per_epoch=2)
    runs["1x2 from one process"] = {
        "history": hist,
        "classifier_shard": list(state.model.classifier_w.shape)}
    if rank == 0:
        with open(os.path.join(out, "driver.json"), "w") as f:
            json.dump(runs, f)
    print(f"RANK{rank}_CHILD_OK", flush=True, force=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
