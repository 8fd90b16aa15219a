"""PyTorch port, one SGD step of each new zoo family (spca_r50,
sosnet_r50, spoc_r50, senet_g2_r50, adaptive_hybrid_r50 at the sizes of
``tests/test_torch_zoo_more.py``) on the CPU against JAX
``make_train_step``, from the same seeded variables (nesterov, masked
decay, clip 1.0, lr 5e-3; 64 px images), with the bars of
``tests/test_torch_zoo_train.py`` taken per leaf; SoSNet and SpoC with
``dropout=0.0``, since the port's dropout cannot draw flax's bits.

The dropout itself: a SoSNet step at dropout 0.5 repeats bit for bit
from the same train-state generator whatever torch's global random
state, differs under another seed, and two steps resumed from a
``TrainState.state_dict`` equal two straight steps, as do two steps
of the model held in a DDP-style wrapper; a train-mode forward that
drops without a generator raises.  ``cli.train --preset
sosnet_r50`` runs one step and its validation on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_image_retrieval_tpu import models as jmodels
from research_image_retrieval_tpu.train import loop as jloop
from research_image_retrieval_tpu.train import optimizer as jopt
from research_image_retrieval_tpu.train.schedule import (
    warmup_cosine_schedule as jax_schedule,
)
from research_image_retrieval_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
from research_image_retrieval_tpu_torch.models import get_model, seeded_init
from research_image_retrieval_tpu_torch.train import (
    TrainState,
    make_sgd_optimizer,
    make_train_step,
    warmup_cosine_schedule,
)
from test_torch_model import few_torch_threads  # noqa: F401
from test_torch_train import _as_port, _change_devs, _leaf_devs, _rel
from test_torch_zoo_more import NEW, jax_model, overrides, port_model

NORM = (IMAGENET_MEAN, IMAGENET_STD)
SCHED = (0, 5e-3, 3, 5e-3, 5e-4, 2)


def _sgd():
    return make_sgd_optimizer(warmup_cosine_schedule(*SCHED),
                              weight_decay=1e-4, clip_max_norm=1.0)


def _global_dev(state: dict, want: dict, init: dict) -> float:
    """How far the whole update (every parameter minus its init) is from
    JAX's, in L2 over the L2 of JAX's."""
    num = den = 0.0
    for k in init:
        if "running" in k:
            continue
        w = np.asarray(want[k], np.float64) - init[k]
        num += float(((np.asarray(state[k], np.float64) - init[k] - w) ** 2)
                     .sum())
        den += float((w ** 2).sum())
    return (num / den) ** 0.5


def _as_port_state(state, start: dict, init: dict) -> dict:
    """A JAX train state in the port's keys: each parameter as ``init``
    plus its change since ``start``, the change converted on its own so
    that a float64 step keeps its precision; BN statistics as they are."""
    change = jax.tree_util.tree_map(
        lambda a, b: np.asarray(a, np.float64) - np.asarray(b, np.float64),
        state.params, start["params"])
    out = _as_port(change, state.batch_stats)
    return {k: a if "running" in k else init[k] + a for k, a in out.items()}


@pytest.mark.parametrize("name", NEW)
def test_train_step_matches_jax(name):
    """One step of JAX ``make_train_step`` and of the port's from the
    same seeded state.  The loss to 1e-5 relative; each leaf's change
    (parameters minus the init, beyond two float32 spacings) to 1e-4 of
    the leaf's largest change; the whole update to 1e-4 in L2; the BN
    statistics to 1e-4 of each leaf's largest magnitude.  The loss, each
    leaf and the whole update may instead be off by up to 10x JAX's own
    deviation of that same quantity, where that is larger: the most its
    step moves when every input moves by one ulp, up or down, uniformly
    and with a random sign per element.  Every leaf's bar must stay
    below 0.5, far below the 1.0 of a leaf left unchanged.

    Four families step in float64 on both sides (JAX under
    ``jax.enable_x64``, the port's model in double), batch 2: in float32
    a train-mode BN this small flips a ReLU here and there on a rounding
    change, and one flip moves a few elements of a leaf by up to 25% of
    its largest change, in JAX's own step under a reversed batch too.  In
    float64 the port's leaves land within 5e-5 of JAX's for SpCa (whose
    head JAX computes with float32 products) and 1e-7 for the others.
    SpCa steps at 96 px: at 64 px its layer4 is 2 x 2 and its GMM branch
    carries almost no gradient, so ``pi`` and ``cov`` move by their
    weight decay alone.  SpoC has no float64 reference: there JAX's own
    step moves backbone and context leaves by up to their whole size
    under a one-ulp input change (an identity barrier around ``agg_bn``
    steadies it, so the cause is XLA's fused backward there; with XLA's
    optimizations off the step gives NaN), so SpoC steps in float32 at
    batch 8, where JAX's one-ulp floor is at most 2% of any leaf.
    adaptive_hybrid's two images share a label, so its contrastive loss
    has a positive pair."""
    f64 = name != "spoc_r50"
    kw = {"dropout": 0.0} if name in ("sosnet_r50", "spoc_r50") else {}
    _, variables = jax_model(name)  # dropout makes no variable
    batch = 2 if f64 else 8
    rng = np.random.default_rng(8)
    px = 96 if name == "spca_r50" else 64
    x = rng.integers(0, 256, (batch, px, px, 3), dtype=np.uint8)
    y = (np.array([3, 3]) if name == "adaptive_hybrid_r50"
         else rng.integers(0, 8, batch))
    dt = np.float64 if f64 else np.float32
    ulp = np.finfo(dt).eps
    signs = np.random.default_rng(3).choice([-1.0, 1.0], x.shape)
    with jax.enable_x64(f64):
        jm = jmodels.get_model(name, **overrides(
            name, dtype=jnp.float64 if f64 else jnp.float32, **kw))
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, dt), variables)
        if f64:
            xf = (x / 255.0 - np.asarray(NORM[0])) / np.asarray(NORM[1])
        else:
            xf = np.asarray(jloop.fused_input_norm(NORM)(jnp.asarray(x)))
        jtx = jopt.make_sgd_optimizer(jax_schedule(*SCHED),
                                      weight_decay=1e-4, clip_max_norm=1.0)
        jinit = jloop.TrainState(
            step=jnp.zeros((), jnp.int32), params=v["params"],
            batch_stats=v["batch_stats"],
            opt_state=jax.jit(jtx.init)(v["params"]),
            rng=jax.random.PRNGKey(1), model_state={})
        jstep = jloop.make_train_step(jm, jtx, donate=False)
        ref, jmet = jstep(jinit, jnp.asarray(xf), jnp.asarray(y))
        others = [jstep(jinit, jnp.asarray((xf * (1 + d * ulp * s))
                                           .astype(dt)), jnp.asarray(y))
                  for d in (1, -1) for s in (1.0, signs)]
    model = port_model(name, variables, **kw)
    if f64:
        model = model.double()
    tstate = TrainState(0, model, _sgd().init(model), torch.Generator())
    tstate, tmet = (make_train_step(None)(tstate, torch.from_numpy(xf), y)
                    if f64 else make_train_step(NORM)(tstate, x, y))
    assert np.isfinite(float(jmet["loss"]))
    loss_bar = max(1e-5, 10 * max(_rel(m["loss"], jmet["loss"])
                                  for _, m in others))
    assert _rel(tmet["loss"], jmet["loss"]) <= loss_bar, loss_bar
    init = _as_port(variables["params"], variables.get("batch_stats", {}))
    want = _as_port_state(ref, v, init)
    port = {k: t.detach().numpy() for k, t in
            tstate.model.state_dict().items()}
    moved = [_as_port_state(o, v, init) for o, _ in others]
    floors = [_change_devs(m, want, init) for m in moved]
    devs = _change_devs(port, want, init)
    for k in devs:
        bar = max(1e-4, 10 * max(f[k] for f in floors))
        assert bar < 0.5, (k, bar)  # far below a skipped update's 1.0
        assert devs[k] <= bar, (k, devs[k], bar)
    g_bar = max(1e-4, 10 * max(_global_dev(m, want, init) for m in moved))
    assert _global_dev(port, want, init) <= g_bar < 0.5, g_bar
    stats = {k: v for k, v in _leaf_devs(port, want).items()
             if "running" in k}
    assert max(stats.values()) <= 1e-4, max(stats, key=stats.get)


class _Held(torch.nn.Module):
    """A model held under ``.module``, as DDP holds it."""

    def __init__(self, model):
        super().__init__()
        self.module = model

    def forward(self, *args, **kwargs):
        return self.module(*args, **kwargs)


def _sosnet_steps(seed: int, steps: int, resume_after: int | None = None,
                  global_seed: int = 0, held: bool = False):
    """``steps`` SGD steps of a seeded resnet18 SoSNet at dropout 0.5
    from a train state whose generator is seeded with ``seed``; with
    ``resume_after``, the state is saved after that many steps and the
    run goes on in a fresh model and optimizer loaded from it; with
    ``held``, the state holds the model in a wrapper."""
    torch.manual_seed(global_seed)  # no draw may come from here

    def fresh():
        model = get_model("sosnet_r50", **overrides("sosnet_r50"))
        seeded_init(model, seed=2)
        if held:
            model = _Held(model)
        tx = _sgd()
        return TrainState(0, model, tx.init(model),
                          torch.Generator().manual_seed(seed))

    rng = np.random.default_rng(9)
    batches = [(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
                rng.integers(0, 8, 2)) for _ in range(steps)]
    state, step = fresh(), make_train_step(NORM)
    for i, (x, y) in enumerate(batches):
        if i == resume_after:
            saved = state.state_dict()
            state = fresh()
            state.load_state_dict(saved)
            torch.manual_seed(global_seed + 1)
        state, _ = step(state, x, y)
    return {k.removeprefix("module."): v.detach().clone()
            for k, v in state.model.state_dict().items()}


def test_dropout_draws_from_the_train_state():
    a = _sosnet_steps(seed=5, steps=2)
    b = _sosnet_steps(seed=5, steps=2, global_seed=123)
    c = _sosnet_steps(seed=6, steps=2)
    resumed = _sosnet_steps(seed=5, steps=2, resume_after=1)
    held = _sosnet_steps(seed=5, steps=2, held=True)
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert torch.equal(a[k], resumed[k]), k
        assert torch.equal(a[k], held[k]), k
    assert not torch.equal(a["proj_fc1.weight"], c["proj_fc1.weight"])
    model = get_model("sosnet_r50", **overrides("sosnet_r50")).train()
    with pytest.raises(ValueError, match="Generator"):
        model(torch.zeros(2, 64, 64, 3), torch.zeros(2, dtype=torch.int64))


def test_cli_train_sosnet_preset(tmp_path):
    """``cli.train --preset sosnet_r50`` (ResNet-50, 2048-d, AdamW, the
    dropout from the step's generator): one step, its validation and a
    checkpoint on the CPU."""
    from research_image_retrieval_tpu_torch.cli import train as cli_train

    assert cli_train.main([
        "--preset", "sosnet_r50", "--device", "cpu", "--imsize", "32",
        "--batch-size", "4", "--num-epochs", "1", "--max-steps-per-epoch",
        "1", "--num-workers", "0", "--directory", str(tmp_path)]) == 0
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert any(np.isfinite(r.get("train_loss", np.nan)) for r in rows), rows
    assert os.path.exists(tmp_path / "epoch_00001.pt")
