"""PyTorch port, multi-process training, search and extraction on the CPU:
two processes over gloo, started through ``init_distributed_mode``'s
environment path (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
``MASTER_PORT``, a port from ``bind(("", 0))``), each with one torch
thread and a timeout.

* ``parallel.dryrun_worker`` (the port's own dry run): on ``(2, 1)`` and
  ``(1, 2)`` the train step in float64 equals the port's single-device
  step on the same global batch (loss and grad_norm to 1e-10 relative,
  every parameter and BN statistic to 1e-9: ``device_check.BARS`` or
  tighter); the cross-process sharded search, exact and int8, returns
  the single engine's ids; rank-sharded extraction gives the
  single-process descriptors and an equal Revisited mAP.
* Against JAX: two float64 SGD steps of gem_r50 (resnet18, 32 px,
  outputdim 32, 64 classes, global batch 4) on both layouts from one
  converted JAX init, against JAX ``make_train_step`` on a ``(2, 1)`` and
  a ``(1, 2)`` mesh of its virtual CPU devices: the loss to 1e-5
  relative; what the steps moved to 1e-4 of each leaf's largest change
  and the BN statistics to 1e-4 of each leaf's magnitude (the bars of
  ``tests/test_torch_zoo_more_train.py``'s float64 steps).
* A negative control: the ``(2, 1)`` step with BN left per rank misses
  the BN statistics bar (the test can fail).
* ``driver.train`` on both layouts for 2 steps: its history equals the
  one-process run's; its checkpoint (the classifier gathered whole)
  loads in one process; a resume at world size 2 equals the straight
  run; a one-process checkpoint continues on ``(1, 2)``.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_image_retrieval_tpu.models import get_model as jax_get_model
from research_image_retrieval_tpu.parallel import make_mesh as jax_make_mesh
from research_image_retrieval_tpu.parallel import (
    shard_train_state_rules as jax_rules,
)
from research_image_retrieval_tpu.train import loop as jloop
from research_image_retrieval_tpu.train import optimizer as jopt
from research_image_retrieval_tpu.train.schedule import (
    warmup_cosine_schedule as jax_schedule,
)
from research_image_retrieval_tpu_torch.models import (
    from_jax_variables,
    get_model,
)
from research_image_retrieval_tpu_torch.train import (
    CheckpointManager,
    TrainState,
    make_sgd_optimizer,
)
from research_image_retrieval_tpu_torch.train import driver as drv
from research_image_retrieval_tpu_torch.train.device_check import BARS
from research_image_retrieval_tpu_torch.utils.config import get_preset
from test_torch_model import few_torch_threads  # noqa: F401
from test_torch_train import _as_port, _change_devs, _leaf_devs, _rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHED = (0, 5e-3, 3, 5e-3, 5e-4, 2)
MODEL = dict(backbone_name="resnet18", outputdim=32, num_classes=64)
DRIVER_CFG = dict(num_epochs=2, batch_size=4, imsize=32, num_workers=0,
                  synthetic_classes=2, synthetic_samples=4,
                  synthetic_val_samples=2, synthetic_uint8=True,
                  device="cpu", plot_freq=0, save_freq=1, keep_every=1,
                  model_overrides={"backbone_name": "resnet18",
                                   "outputdim": 16})


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def start(args) -> list:
    """Start ``python args...`` as ranks 0 and 1 of a gloo world."""
    env = {**os.environ, "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(_free_port()), "WORLD_SIZE": "2",
           "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen([sys.executable, *args], cwd=ROOT,
                             env={**env, "RANK": str(r)},
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in (0, 1)]


def finish(procs, timeout: float = 240) -> list[str]:
    """The ranks' outputs; both must exit 0 within ``timeout``."""
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _dryrun_rows(outs) -> dict:
    rows = {}
    for r, out in enumerate(outs):
        line = next(ln for ln in out.splitlines()
                    if ln.startswith(f"RANK{r}_DRYRUN_OK "))
        rows[r] = json.loads(line.split(" ", 1)[1])
    return rows


@pytest.fixture(scope="module")
def dryrun(two_ranks):
    return two_ranks["dryrun"]


@pytest.mark.parametrize("layout", ["2x1", "1x2"])
def test_dryrun_steps_match_single_device(dryrun, layout):
    """Each rank's float64 step on the layout against the port's
    single-device step on the whole global batch, within
    ``device_check.BARS`` (the worker holds them tighter and asserts)."""
    for row in dryrun.values():
        dev = row["steps"][layout]
        assert dev["loss"] <= BARS["loss"]
        assert dev["grad_norm"] <= BARS["grad_norm"]
        assert dev["params"] <= 1e-9 and dev["batch_stats"] <= 1e-9


def test_dryrun_search_and_extraction(dryrun):
    """The worker got past the cross-process search (exact and int8 ids
    equal the single engine's) and the rank-sharded extraction: the same
    descriptors (within 1e-5; on the CPU exactly) and mAP on both
    ranks."""
    assert dryrun[0]["mAP"] == dryrun[1]["mAP"]
    assert dryrun[0]["images"] == 12
    assert max(r["extract_dev"] for r in dryrun.values()) < 1e-5


def _jax_state(variables, jtx):
    return jloop.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=jax.jit(jtx.init)(variables["params"]),
        rng=jax.random.PRNGKey(1), model_state={})


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The port's two-rank dry run (started first, it runs beside the
    JAX work), JAX's float64 mesh steps, the one-process driver run and
    the two-process child's results."""
    dry = start(["-m", "research_image_retrieval_tpu_torch.parallel."
                 "dryrun_worker", "--device", "cpu"])
    out = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(21)
    batches = [((rng.integers(0, 256, (4, 32, 32, 3)) / 255.0
                 - 0.45) / 0.25, rng.integers(0, 64, 4)) for _ in range(2)]
    jm32 = jax_get_model("gem_r50", **MODEL)
    variables = jax.jit(lambda k, x, y: jm32.init(k, x, labels=y,
                                                  train=False))(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1,), jnp.int32))
    want = {}
    with jax.enable_x64(True):
        jm = jax_get_model("gem_r50", dtype=jnp.float64, **MODEL)
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                   variables)
        jtx = jopt.make_sgd_optimizer(jax_schedule(*SCHED),
                                      weight_decay=1e-4, clip_max_norm=1.0)
        for d, m in ((2, 1), (1, 2)):
            mesh = jax_make_mesh(d, m, devices=jax.devices()[:2])
            state = _jax_state(v, jtx)
            shardings = jax.tree_util.tree_map_with_path(jax_rules(mesh),
                                                         state)
            state = jax.tree.map(jax.device_put, state, shardings)
            step = jloop.make_train_step(jm, jtx, mesh=mesh, donate=False)
            losses = []
            for x, y in batches:
                state, met = step(state, jnp.asarray(x), jnp.asarray(y))
                losses.append(float(met["loss"]))
            want[f"{d}x{m}"] = dict(
                losses=losses, state=_as_port(
                    jax.device_get(state.params),
                    jax.device_get(state.batch_stats)))
    model = get_model("gem_r50", **MODEL)
    model.load_state_dict(from_jax_variables(variables))
    one = get_preset("gem_r50", directory=str(out / "one"), **DRIVER_CFG)
    _, one_hist = drv.train(one, max_steps_per_epoch=2)
    spec = dict(model=MODEL, sched=SCHED,
                init={k: t.double() for k, t in model.state_dict().items()},
                batches=[(torch.from_numpy(x), torch.from_numpy(y))
                         for x, y in batches],
                driver_cfg=DRIVER_CFG,
                one_process_ckpt=str(out / "one" / "epoch_00001.pt"))
    torch.save(spec, out / "in.pt")
    dry_rows = _dryrun_rows(finish(dry))
    outs = finish(start([os.path.join("tests", "torch_dist_child.py"),
                         str(out / "in.pt"), str(out)]))
    assert all(f"RANK{r}_CHILD_OK" in o for r, o in enumerate(outs))
    with open(out / "driver.json") as f:
        runs = json.load(f)
    return dict(dryrun=dry_rows, want=want, got=torch.load(out / "steps.pt"),
                init=_as_port(v["params"], v["batch_stats"]), out=out,
                one_hist=one_hist, runs=runs, one=one)


def _port(state: dict) -> dict:
    return {k: t.numpy() for k, t in state.items()}


@pytest.mark.parametrize("layout", ["2x1", "1x2"])
def test_layout_steps_match_jax_mesh(two_ranks, layout):
    """Two float64 steps on the layout against JAX's on the same mesh
    shape: the loss to 1e-5 relative, each leaf's change to 1e-4 of its
    largest change, the BN statistics to 1e-4 of each leaf."""
    want, got = two_ranks["want"][layout], two_ranks["got"][layout]
    for t, j in zip(got["metrics"], want["losses"]):
        assert _rel(t["loss"], j) <= 1e-5
    port = _port(got["state"])
    devs = _change_devs(port, want["state"], two_ranks["init"])
    worst = max(devs, key=devs.get)
    assert devs[worst] <= 1e-4, (worst, devs[worst])
    stats = {k: d for k, d in _leaf_devs(port, want["state"]).items()
             if "running" in k}
    assert max(stats.values()) <= 1e-4, max(stats, key=stats.get)
    assert got["state"]["classifier_w"].shape == (64, 32)  # gathered


def test_local_bn_misses_the_bar(two_ranks):
    """The negative control: the same (2, 1) steps with each rank's BN on
    its own two images miss the BN statistics bar by far."""
    port = _port(two_ranks["got"]["2x1 local BN"]["state"])
    stats = {k: d for k, d in _leaf_devs(
        port, two_ranks["want"]["2x1"]["state"]).items() if "running" in k}
    assert max(stats.values()) > 100 * 1e-4


@pytest.mark.parametrize("layout", ["2x1", "1x2"])
def test_driver_two_ranks_matches_one(two_ranks, layout):
    """``driver.train`` at world size 2 (2 steps per epoch, 2 epochs)
    against one process on the same config: the same history to float32
    round-off, and its last checkpoint loads in one process."""
    run = two_ranks["runs"][layout]
    for key in ("train_loss", "val_loss", "val_top1_err"):
        np.testing.assert_allclose(run["history"][key],
                                   two_ranks["one_hist"][key],
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    assert run["step"] == 4
    payload, epoch = CheckpointManager(
        str(two_ranks["out"] / f"driver_{layout}")).restore()
    assert epoch == 2
    model = get_model("gem_r50", num_classes=2,
                      **DRIVER_CFG["model_overrides"])
    state = TrainState(0, model, make_sgd_optimizer(0.1).init(model),
                       torch.Generator())
    state.load_state_dict(payload)
    assert state.model.classifier_w.shape == (2, 16)


def test_driver_resume_at_two_ranks_equals_straight(two_ranks):
    """The (2, 1) run resumed from its first epoch's checkpoint gives the
    straight run's second epoch bit for bit."""
    runs = two_ranks["runs"]
    for key in ("train_loss", "val_loss", "val_top1_err"):
        assert runs["2x1 resumed"]["history"][key] == \
            runs["2x1"]["history"][key][1:], key


def test_one_process_checkpoint_continues_on_two_ranks(two_ranks):
    """A one-process checkpoint resumes on (1, 2): each rank holds half
    of the classifier's columns and the second epoch trains."""
    run = two_ranks["runs"]["1x2 from one process"]
    assert run["classifier_shard"] == [2, 8]
    assert len(run["history"]["train_loss"]) == 1
    assert np.isfinite(run["history"]["train_loss"][0])
