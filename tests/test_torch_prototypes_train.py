"""PyTorch port, the four research prototypes in training, on the CPU
against the JAX package (the small configurations of
``tests/test_torch_prototypes.py``):

* one SGD step per model against JAX ``make_train_step`` from the same
  seeded variables, in float64 on both sides (JAX under
  ``jax.enable_x64``; train-mode BN of nets this small is chaotic in
  float32, ``tests/test_torch_zoo_more_train.py``), IRIS at dropout 0:
  the loss and grad_norm to 1e-6 relative, each leaf's change to 1e-4
  of its largest change, the BN statistics to 1e-6 of each leaf's
  largest magnitude.  SPARSE and HAMLET step with a teacher table
  gathered in the step and without one (the table must move the loss);
* the parameter set is the same with and without a teacher, on both
  sides.

The teacher itself and ``cli.train --teacher`` are held in
``tests/test_torch_teacher.py``.
"""

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
from research_image_retrieval_tpu_torch.models import (
    from_jax_variables,
    get_model,
)
from research_image_retrieval_tpu_torch.train import (
    TrainState,
    make_train_step,
)
from test_torch_model import few_torch_threads  # noqa: F401
from test_torch_prototypes import (
    GEOMETRY,
    NEW,
    jax_model,
    overrides,
    port_model,
)
from test_torch_train import _as_port, _change_devs, _leaf_devs, _rel
from test_torch_zoo_token_how import SCHED, _as_port_state, _sgd

T = torch.from_numpy
NORM = (IMAGENET_MEAN, IMAGENET_STD)
# (model, with a teacher table)
CASES = [(n, False) for n in NEW] + [("sparse_r50", True),
                                     ("hamlet_r50", True)]


def _table(name, classes=8, seed=4):
    """A seeded float64 [classes, text_dim] teacher table."""
    dim = overrides(name)["text_dim"]
    return np.random.default_rng(seed).standard_normal((classes, dim))


@pytest.mark.parametrize("name, teacher", CASES, ids=[
    n.split("_r50")[0] + ("-teacher" if t else "") for n, t in CASES])
def test_train_step_matches_jax(name, teacher):
    """One step of JAX ``make_train_step`` and of the port's from the same
    seeded state, both in float64 (see the module docstring for the
    bars).  With a teacher, both steps gather the same table by label;
    the distillation term must move the loss."""
    kw = {"dropout": 0.0} if name == "iris_r50" else {}
    _, variables = jax_model(name)
    px = GEOMETRY[name][0]
    rng = np.random.default_rng(8)
    x = rng.integers(0, 256, (2, px, px, 3), dtype=np.uint8)
    y = np.array([3, 5])
    xf = (x / 255.0 - np.asarray(NORM[0])) / np.asarray(NORM[1])
    table = _table(name) if teacher else None
    with jax.enable_x64(True):
        jm = jmodels.get_model(name, **overrides(name, dtype=jnp.float64,
                                                 **kw))
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                   variables)
        jtx = jopt.make_sgd_optimizer(jax_schedule(*SCHED),
                                      weight_decay=1e-4, clip_max_norm=1.0)
        jstate = jloop.TrainState(
            step=jnp.zeros((), jnp.int32),
            params=jax.tree_util.tree_map(jnp.asarray, v["params"]),
            batch_stats=jax.tree_util.tree_map(
                jnp.asarray, v.get("batch_stats", {})),
            opt_state=jax.jit(jtx.init)(v["params"]),
            rng=jax.random.PRNGKey(1), model_state={})
        ref, jmet = jloop.make_train_step(jm, jtx, donate=False,
                                          teacher_table=table)(
            jstate, jnp.asarray(xf), jnp.asarray(y))
        ref = jax.tree_util.tree_map(np.asarray, ref)
    if teacher:  # the port's step without the table
        model = port_model(name, variables, **kw).double()
        _, plain = make_train_step(None)(
            TrainState(0, model, _sgd().init(model), torch.Generator()),
            T(xf), y)
    model = port_model(name, variables, **kw).double()
    tstate = TrainState(0, model, _sgd().init(model), torch.Generator())
    tstate, tmet = make_train_step(None, teacher_table=table)(
        tstate, T(xf), y)
    assert np.isfinite(float(jmet["loss"]))
    assert _rel(tmet["loss"], jmet["loss"]) <= 1e-6
    if teacher:
        assert _rel(plain["loss"], jmet["loss"]) > 1e-3
    assert _rel(tmet["grad_norm"], jmet["grad_norm"]) <= 1e-6
    init = _as_port(variables["params"], variables.get("batch_stats", {}))
    want = _as_port_state(ref, v, init)
    port = {k: t.detach().numpy() for k, t in
            tstate.model.state_dict().items()}
    devs = _change_devs(port, want, init)
    worst = max(devs, key=devs.get)
    assert devs[worst] <= 1e-4, (worst, devs[worst])
    stats = {k: d for k, d in _leaf_devs(port, want).items()
             if "running" in k}
    assert not stats or max(stats.values()) <= 1e-6, \
        max(stats, key=stats.get)


@pytest.mark.parametrize("name", ["sparse_r50", "hamlet_r50"])
def test_parameter_set_without_teacher(name):
    """JAX's init with teacher rows and without makes the same tree; the
    port's module holds the same keys (its ``text_proj`` / ``text_head``
    exist either way)."""
    jm = jmodels.get_model(name, **overrides(name))
    px = GEOMETRY[name][0]

    def tree(text):
        shapes = jax.eval_shape(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((2, px, px, 3)),
            labels=jnp.zeros((2,), jnp.int32), train=False,
            text_features=text))
        return jax.tree_util.tree_map(lambda a: a.shape, shapes)

    with_teacher = tree(jnp.zeros((2, overrides(name)["text_dim"])))
    assert with_teacher == tree(None)
    port = get_model(name, **overrides(name))
    keys = set(from_jax_variables(jax_model(name)[1]))
    assert keys == set(port.state_dict()) - {
        k for k in port.state_dict() if k.endswith("num_batches_tracked")}
