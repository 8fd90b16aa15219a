"""One rank of ``tests/test_torch_dist_coupled.py``'s two-process run
(gloo on the CPU; the port only, no JAX).

    python tests/torch_coupled_child.py IN.pt OUT_DIR

with ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` set.
``IN.pt`` holds, per model, its overrides, the initial port state dict
(float64), the global batch and the teacher table (or None), and the
schedule.  Each model takes one step on the ``(2, 1)`` layout from its
rows of the global batch, and IRIS once more with the gather off (the
negative control); rank 0 writes ``OUT_DIR/steps.pt``: each run's state
and metrics after the step.
"""

from __future__ import annotations

import os
import sys
import types

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from research_image_retrieval_tpu_torch.models import get_model  # noqa: E402
from research_image_retrieval_tpu_torch.models import iris  # noqa: E402
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


def step(case: dict, sched, mesh) -> dict:
    """One float64 SGD step of ``case``'s model over ``mesh`` (None: one
    process on the whole global batch)."""
    model = get_model(case["name"], **case["overrides"]).double()
    model.load_state_dict(case["init"])
    tx = make_sgd_optimizer(warmup_cosine_schedule(*sched),
                            weight_decay=1e-4, clip_max_norm=1.0)
    state = TrainState(0, model, tx.init(model), torch.Generator())
    x, y = case["x"], case["y"]
    if mesh is not None:
        state = shard_train_state(state, mesh)
        rows = data_sharding(mesh, x.shape[0])
        x, y = x[rows], y[rows]
    state, m = make_train_step(None, teacher_table=case["table"],
                               mesh=mesh)(state, x, y)
    return {"state": state.state_dict()["model"],
            "metrics": {k: float(v) for k, v in m.items()}}


def main() -> int:
    torch.set_num_threads(1)
    spec_path, out = sys.argv[1], sys.argv[2]
    spec = torch.load(spec_path, weights_only=False)
    init_distributed_mode(device="cpu", quiet_non_main=True)
    rank = get_rank()
    mesh = make_mesh(2, 1)
    steps = {key: step(case, spec["sched"], mesh)
             for key, case in spec["cases"].items()}
    # the negative control: IRIS with its contrastive term over each
    # rank's own rows (the gather off; BN stays global)
    saved = iris.collectives
    iris.collectives = types.SimpleNamespace(
        data_gather_grad=lambda t: t, data_gather=lambda t: t)
    try:
        steps["iris without the gather"] = step(spec["cases"]["iris"],
                                                spec["sched"], mesh)
    finally:
        iris.collectives = saved
    if rank == 0:
        torch.save(steps, os.path.join(out, "steps.pt"))
    print(f"RANK{rank}_CHILD_OK", flush=True, force=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
