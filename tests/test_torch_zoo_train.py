"""PyTorch port, one SGD step of each ResNet zoo family (dolg_r50,
solar_r50, delg_r50 at resnet18) on the CPU against JAX
``make_train_step``, from the seeded variables of
``tests/test_torch_zoo_resnet.py`` (nesterov, masked decay, clip 1.0,
lr 5e-3; 64 px, batch 2 of uint8 images), with the bars of
``tests/test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_image_retrieval_tpu.train import loop as jloop
from research_image_retrieval_tpu.train import optimizer as jopt
from research_image_retrieval_tpu.train.schedule import (
    warmup_cosine_schedule as jax_schedule,
)
from research_image_retrieval_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
from research_image_retrieval_tpu_torch.train import (
    TrainState,
    make_sgd_optimizer,
    make_train_step,
    warmup_cosine_schedule,
)
from test_torch_model import few_torch_threads  # noqa: F401
from test_torch_train import ULP, _as_port, _change_devs, _leaf_devs, _rel
from test_torch_zoo_resnet import FAMILIES, _jax_model, _port

NORM = (IMAGENET_MEAN, IMAGENET_STD)


@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_jax(name):
    """One SGD step (nesterov, masked decay, clip 1.0, lr 5e-3) of JAX
    ``make_train_step`` and of the port from the same seeded state,
    resnet18 at 64 px, batch 2 of uint8 images.  With the bars of
    ``tests/test_torch_train.py``: the loss to 1e-5 relative and what the
    step moved (parameters minus the init) to 1e-4 of each leaf's largest
    change, each or 10x JAX's own deviation when the inputs move by one
    ulp, where that is larger; the BN statistics to 1e-4 of each leaf's
    largest magnitude.  At 32 px layer4 is 1 x 1 and train-mode BN
    normalizes two values per channel, which puts JAX's own one-ulp floor
    at ~0.26 of a leaf's change; at 64 px it is ~7e-5."""
    jm, variables = _jax_model(name)
    rng = np.random.default_rng(8)
    x = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    y = rng.integers(0, 8, 2)
    xf = np.asarray(jloop.fused_input_norm(NORM)(jnp.asarray(x)))
    sched = (0, 5e-3, 3, 5e-3, 5e-4, 2)
    jtx = jopt.make_sgd_optimizer(jax_schedule(*sched), weight_decay=1e-4,
                                  clip_max_norm=1.0)
    jinit = jloop.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=jtx.init(variables["params"]),
        rng=jax.random.PRNGKey(1), model_state={})
    jstep = jloop.make_train_step(jm, jtx, donate=False)
    ref, jmet = jstep(jinit, jnp.asarray(xf), jnp.asarray(y))
    bumped = [jstep(jinit, jnp.asarray(xf * (1 + d * ULP)), jnp.asarray(y))
              for d in (1, -1)]
    ttx = make_sgd_optimizer(warmup_cosine_schedule(*sched),
                             weight_decay=1e-4, clip_max_norm=1.0)
    model = _port(name, variables)
    tstate = TrainState(0, model, ttx.init(model), torch.Generator())
    tstate, tmet = make_train_step(NORM)(tstate, x, y)
    loss_bar = max(1e-5, 10 * max(_rel(m["loss"], jmet["loss"])
                                  for _, m in bumped))
    assert _rel(tmet["loss"], jmet["loss"]) <= loss_bar, loss_bar
    init = _as_port(variables["params"], variables["batch_stats"])
    want = _as_port(ref.params, ref.batch_stats)
    port = {k: v.detach().numpy() for k, v in
            tstate.model.state_dict().items()}
    floor = max(max(_change_devs(_as_port(b.params, b.batch_stats), want,
                                 init).values()) for b, _ in bumped)
    devs = _change_devs(port, want, init)
    worst = max(devs, key=devs.get)
    bar = max(1e-4, 10 * floor)
    assert bar < 0.1  # far below a skipped update's 1.0
    assert devs[worst] <= bar, (worst, devs[worst], floor)
    stats = {k: v for k, v in _leaf_devs(port, want).items()
             if "running" in k}
    assert max(stats.values()) <= 1e-4, max(stats, key=stats.get)
