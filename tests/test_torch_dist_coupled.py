"""PyTorch port, the models whose training couples the batch's samples,
at world size 2 on the CPU: SPECTRUM (batch attention in CASTLE and
NEXUS), IRIS (its loss's contrastive term), AdaptiveHybrid (its
supervised InfoNCE) and SPARSE with a teacher table (the distillation
cross entropy over the batch's pairs).  Under a layout each of those
operations runs on the global batch gathered with a gradient
(``utils.collectives.data_gather_grad``), as JAX's GSPMD step sees it.

One two-process gloo launch (``tests/torch_coupled_child.py``) steps all
four once on the ``(2, 1)`` layout, in float64, at resnet18 (IRIS at 96
px so that its layer4 map has rows for its bins, the others at 64 px),
global batch 4, labels that pair rank 0's images with rank 1's.  Each is
held against:

* the port's one-process step on the global batch: the loss and
  grad_norm to 1e-12 relative, each parameter and BN statistic to 1e-12
  of its leaf's largest magnitude (read: <= 2e-16), and each parameter's
  change to 1e-10 of the step's largest change (read: <= 1.02e-12, at
  AdaptiveHybrid's ``layer2.0.bn1.weight``: the global BN sums' order);
* JAX ``make_train_step`` on a ``(2, 1)`` mesh of its virtual CPU devices
  (float64 under ``jax.enable_x64``): the bars of
  ``tests/test_torch_prototypes_train.py`` (the loss and grad_norm to
  1e-6 relative, each leaf's change to 1e-4 of its largest change, the
  BN statistics to 1e-6 of each leaf's largest magnitude).

A negative control: the same layout step of IRIS with the gather switched
off (each rank's contrastive term over its own two images, BN still
global) misses the one-process loss by far, so the gather is what the
bars hold.  At world size 1 the layout step is the plain step bit for
bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_image_retrieval_tpu import models as jmodels
from research_image_retrieval_tpu.parallel import make_mesh as jax_make_mesh
from research_image_retrieval_tpu.parallel import (
    shard_train_state_rules as jax_rules,
)
from research_image_retrieval_tpu.train import loop as jloop
from research_image_retrieval_tpu.train import optimizer as jopt
from research_image_retrieval_tpu.train.schedule import (
    warmup_cosine_schedule as jax_schedule,
)
from research_image_retrieval_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
from research_image_retrieval_tpu_torch.parallel import make_mesh
from test_torch_dist_multiprocess import finish, start
from test_torch_model import few_torch_threads  # noqa: F401
from test_torch_train import _as_port, _change_devs, _leaf_devs, _rel
from test_torch_zoo_token_how import SCHED, _as_port_state
from torch_coupled_child import step
import test_torch_prototypes as protos
import test_torch_zoo_more as zoo_more

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORM = (IMAGENET_MEAN, IMAGENET_STD)
# key: (model, the helper module of its small configuration, image side,
# with a teacher table, port / JAX overrides)
CASES = {
    "spectrum": ("spectrum_r50", protos, 64, False, {}),
    "iris": ("iris_r50", protos, 96, False, {"dropout": 0.0}),
    "adaptive_hybrid": ("adaptive_hybrid_r50", zoo_more, 64, False, {}),
    "sparse-teacher": ("sparse_r50", protos, 64, True, {}),
}
LABELS = np.array([3, 5, 3, 5])  # rank 0 holds [3, 5], rank 1 the pairs


def _case(key: str) -> dict:
    name, helper, px, teacher, kw = CASES[key]
    _, variables = helper.jax_model(name)
    rng = np.random.default_rng(8)
    x = rng.integers(0, 256, (4, px, px, 3), dtype=np.uint8)
    xf = (x / 255.0 - np.asarray(NORM[0])) / np.asarray(NORM[1])
    table = None
    if teacher:
        dim = helper.overrides(name)["text_dim"]
        table = np.random.default_rng(4).standard_normal((8, dim))
    port = helper.port_model(name, variables, **kw)
    return dict(name=name, overrides=helper.overrides(name, **kw),
                init={k: t.double() for k, t in port.state_dict().items()},
                x=torch.from_numpy(xf), y=torch.from_numpy(LABELS),
                table=None if table is None else torch.from_numpy(table),
                variables=variables, helper=helper, kw=kw)


def _jax_mesh_step(case: dict) -> dict:
    """One float64 step of JAX ``make_train_step`` on a (2, 1) mesh."""
    with jax.enable_x64(True):
        jm = jmodels.get_model(case["name"], **case["helper"].overrides(
            case["name"], dtype=jnp.float64, **case["kw"]))
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                   case["variables"])
        jtx = jopt.make_sgd_optimizer(jax_schedule(*SCHED),
                                      weight_decay=1e-4, clip_max_norm=1.0)
        state = jloop.TrainState(
            step=jnp.zeros((), jnp.int32),
            params=jax.tree_util.tree_map(jnp.asarray, v["params"]),
            batch_stats=jax.tree_util.tree_map(
                jnp.asarray, v.get("batch_stats", {})),
            opt_state=jax.jit(jtx.init)(v["params"]),
            rng=jax.random.PRNGKey(1), model_state={})
        mesh = jax_make_mesh(2, 1, devices=jax.devices()[:2])
        state = jax.tree.map(jax.device_put, state,
                             jax.tree_util.tree_map_with_path(
                                 jax_rules(mesh), state))
        table = None if case["table"] is None else case["table"].numpy()
        ref, met = jloop.make_train_step(jm, jtx, mesh=mesh, donate=False,
                                         teacher_table=table)(
            state, jnp.asarray(case["x"].numpy()), jnp.asarray(LABELS))
        ref = jax.tree_util.tree_map(np.asarray, jax.device_get(ref))
    init = _as_port(case["variables"]["params"],
                    case["variables"].get("batch_stats", {}))
    return dict(state=_as_port_state(ref, v, init), init=init,
                metrics={k: float(met[k]) for k in ("loss", "grad_norm")})


@pytest.fixture(scope="module")
def coupled(tmp_path_factory):
    """The two ranks' layout steps (started first, they run beside the
    rest) with the IRIS control, JAX's mesh steps, the port's one-process
    steps and the initial states."""
    out = tmp_path_factory.mktemp("coupled")
    cases = {key: _case(key) for key in CASES}
    spec = {"sched": SCHED, "cases": {
        key: {k: c[k] for k in ("name", "overrides", "init", "x", "y",
                                "table")} for key, c in cases.items()}}
    torch.save(spec, out / "in.pt")
    procs = start([os.path.join("tests", "torch_coupled_child.py"),
                   str(out / "in.pt"), str(out)])
    try:
        jax_steps = {key: _jax_mesh_step(c) for key, c in cases.items()}
        one = {key: step(spec["cases"][key], SCHED, None) for key in cases}
    finally:
        outs = finish(procs)
    assert all(f"RANK{r}_CHILD_OK" in o for r, o in enumerate(outs))
    return dict(got=torch.load(out / "steps.pt"), one=one, jax=jax_steps,
                init={key: c["init"] for key, c in cases.items()})


def _port(state: dict) -> dict:
    return {k: t.double().numpy() for k, t in state.items()}


@pytest.mark.parametrize("key", list(CASES))
def test_layout_step_equals_one_process(coupled, key):
    """The (2, 1) step against the one-process step on the global batch
    (see the module docstring for the bars)."""
    got, want = coupled["got"][key], coupled["one"][key]
    for k in ("loss", "grad_norm"):
        assert _rel(got["metrics"][k], want["metrics"][k]) <= 1e-12, k
    init = _port(coupled["init"][key])
    g, w = _port(got["state"]), _port(want["state"])
    devs = _leaf_devs(g, w)
    worst = max(devs, key=devs.get)
    assert devs[worst] <= 1e-12, (worst, devs[worst])
    params = [k for k in w if "running" not in k
              and not k.endswith("num_batches_tracked")]
    largest = max(float(np.abs(w[k] - init[k]).max()) for k in params)
    moved = {k: float(np.abs(g[k] - w[k]).max()) / largest for k in params}
    worst = max(moved, key=moved.get)
    assert moved[worst] <= 1e-10, (worst, moved[worst])


@pytest.mark.parametrize("key", list(CASES))
def test_layout_step_matches_jax_mesh(coupled, key):
    """The (2, 1) step against JAX's on a (2, 1) mesh (the bars of the
    prototypes' one-device step test)."""
    got, want = coupled["got"][key], coupled["jax"][key]
    for k in ("loss", "grad_norm"):
        assert _rel(got["metrics"][k], want["metrics"][k]) <= 1e-6, k
    port = _port(got["state"])
    devs = _change_devs(port, want["state"], want["init"])
    worst = max(devs, key=devs.get)
    assert devs[worst] <= 1e-4, (worst, devs[worst])
    stats = {k: d for k, d in _leaf_devs(port, want["state"]).items()
             if "running" in k}
    if stats:
        assert max(stats.values()) <= 1e-6, max(stats, key=stats.get)


def test_control_without_gather_misses(coupled):
    """IRIS's layout step with the gather off (each rank's contrastive
    term over its own two images, which share no label; BN still global)
    misses the one-process loss by far more than the bar."""
    got = coupled["got"]["iris without the gather"]["metrics"]["loss"]
    want = coupled["one"]["iris"]["metrics"]["loss"]
    assert _rel(got, want) > 1e-3


def test_world_of_one_layout_step_is_bit_equal():
    """At world size 1 the layout step of each model equals the plain
    step bit for bit (the gather and its backward are exact)."""
    import socket

    from research_image_retrieval_tpu_torch.parallel import (
        init_distributed_mode,
    )

    with socket.socket() as s:
        s.bind(("", 0))
        port = s.getsockname()[1]
    init_distributed_mode(f"localhost:{port}", device="cpu", force=True,
                          quiet_non_main=False)
    try:
        mesh = make_mesh(1, 1)
        for key in ("spectrum", "sparse-teacher"):
            case = _case(key)
            plain = step(case, SCHED, None)
            lay = step(case, SCHED, mesh)
            assert plain["metrics"] == lay["metrics"], key
            for k, t in plain["state"].items():
                assert torch.equal(t, lay["state"][k]), (key, k)
    finally:
        torch.distributed.destroy_process_group()
