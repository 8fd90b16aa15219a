"""PyTorch port at bf16 compute dtype on the CPU, against the JAX package
on the same inputs (made with numpy from a seed).

* The bottleneck's plain version at bf16 (what the wrapper computes for a
  CPU tensor) against JAX's ``fused_bottleneck_reference`` and the Pallas
  kernel in interpret mode at bf16: within one bf16 ulp of |out| at every
  element (measured: bit-equal at C = 64, 128, 256).
* The head on a bf16 map against the Pallas kernel in interpret mode:
  rtol 1e-5 / atol 1e-6, the fp32 map's bar (both pool the upcast map).
* flax-semantics BatchNorm on a bf16 input against flax's
  ``BatchNorm(dtype=bfloat16)``, train and eval: output within one bf16
  ulp, running statistics to 1e-6.
* GeM-R50 with ``dtype=bfloat16`` on JAX weights bridged by
  ``from_jax_variables``, against the JAX bf16 ``GeMModel``: train-mode
  loss and logits, and masked-bucket extraction.  The bars are stated
  against JAX's own bf16 floor: JAX against itself with the (bf16) input
  moved by one bf16 ulp up and down.  Train-mode BN at init amplifies
  that move to ~8% of the loss and ~2.5 on logits of scale 32 (64 px,
  batch 8); extraction to ~1.7e-3 on unit descriptors.  Bars: 3x the
  floor.
* One bf16 SGD step of gem_r50 on resnet18 (64 px uint8, batch 8)
  against JAX ``make_train_step`` with a bf16 model: the whole update
  (parameters minus the shared init) within 1.5x JAX's own relative-L2
  deviation under the one-bf16-ulp input moves (~0.29; a skipped update
  is off by 1.0), the loss at 3x its floor.
* The driver's ``compute_dtype``: a model with the field is built at
  bf16, an explicit ``model_overrides["dtype"]`` wins, a model without
  it gets the JAX driver's note.
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from research_image_retrieval_tpu.models import get_model as jax_get_model
from research_image_retrieval_tpu.ops.gem_pallas import pallas_gem_whiten_l2
from research_image_retrieval_tpu.ops.resblock_pallas import (
    fused_bottleneck_reference as jax_bottleneck_reference,
)
from research_image_retrieval_tpu.ops.resblock_pallas import (
    pallas_fused_bottleneck,
)
from research_image_retrieval_tpu.train import loop as jloop
from research_image_retrieval_tpu.train import optimizer as jopt
from research_image_retrieval_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
from research_image_retrieval_tpu_torch.models import (
    BatchNorm,
    from_jax_variables,
    get_model,
)
from research_image_retrieval_tpu_torch.models import backbone as tbackbone
from research_image_retrieval_tpu_torch.ops import gem_head, resblock
from research_image_retrieval_tpu_torch.train import (
    create_train_state,
    make_sgd_optimizer,
    make_train_step,
)
from test_torch_kernels import _block_weights, _fold_both
from test_torch_model import few_torch_threads  # noqa: F401

T = torch.from_numpy
BF = jnp.bfloat16
NORM = (IMAGENET_MEAN, IMAGENET_STD)


def bf16_ulp(v) -> np.ndarray:
    """One bf16 ulp of |v| (8 significant bits), elementwise."""
    a = np.maximum(np.abs(np.asarray(v, np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def as_bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bf16, as a writable float32 array."""
    return np.array(jnp.asarray(x, BF).astype(jnp.float32))


def bumps(x: np.ndarray):
    """``x`` rounded to bf16, moved up and down by one bf16 ulp."""
    xb = as_bf16(x)
    return [xb + bf16_ulp(xb) * np.sign(xb), xb - bf16_ulp(xb) * np.sign(xb)]


# -- kernel 2 at bf16 --------------------------------------------------------

@pytest.mark.parametrize("c, cw, height", [(64, 16, 16), (128, 32, 13),
                                           (256, 64, 8)])
def test_bottleneck_bf16_matches_jax_and_pallas(rng, c, cw, height):
    x = np.maximum(rng.standard_normal((2, height, 16, c)), 0).astype(
        np.float32)
    jx, pt = _fold_both(_block_weights(rng, c, cw))
    xb = jnp.asarray(x, BF)
    want_ref = np.asarray(jax_bottleneck_reference(xb, *jx).astype(jnp.float32))
    want_pallas = np.asarray(pallas_fused_bottleneck(
        xb, *jx, th=8, interpret=True).astype(jnp.float32))
    got = resblock.fused_bottleneck(T(x).to(torch.bfloat16), *pt)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for want in (want_ref, want_pallas):
        assert np.all(np.abs(got - want) <= bf16_ulp(want)), \
            float(np.max(np.abs(got - want) / bf16_ulp(want)))


def test_bottleneck_bf16_rounds_like_the_tpu_kernel(rng):
    """The plain version's bf16 form is not the fp32 one rounded at the
    end: t1 and t2 are rounded too (JAX's rounding points), so the two
    are not bit-equal."""
    x = np.maximum(rng.standard_normal((2, 8, 8, 64)), 0).astype(np.float32)
    _, pt = _fold_both(_block_weights(rng, 64, 16))
    xb = T(x).to(torch.bfloat16)
    got = resblock.fused_bottleneck(xb, *pt).float().numpy()
    w = [t.to(torch.bfloat16).float() if i % 2 == 0 else t
         for i, t in enumerate(pt)]
    f32 = resblock.fused_bottleneck(xb.float(), *w).to(torch.bfloat16)
    assert np.any(got != f32.float().numpy())


# -- kernel 1 on a bf16 map --------------------------------------------------

@pytest.mark.parametrize("wdt", ["float32", "bfloat16"])
def test_gem_head_bf16_map_matches_pallas(rng, wdt):
    B, H, W, C, D = 2, 8, 8, 64, 16
    fmap = as_bf16(np.abs(rng.standard_normal((B, H, W, C))))
    w = (rng.standard_normal((C, D)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(D) * 0.01).astype(np.float32)
    mask = np.zeros((B, H, W), np.float32)
    mask[0, :5, :6] = 1.0
    mask[1] = 1.0
    with pltpu.force_tpu_interpret_mode():
        want = pallas_gem_whiten_l2(
            jnp.asarray(fmap, BF), jnp.asarray(w), jnp.asarray(b),
            valid_hw=jnp.asarray(mask), block=16, weight_dtype=wdt)
    got = gem_head.gem_whiten_l2(
        T(fmap).to(torch.bfloat16), T(np.ascontiguousarray(w.T)), T(b),
        extents=torch.tensor([[5, 6], [8, 8]], dtype=torch.int32),
        weight_dtype=getattr(torch, wdt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# -- BatchNorm on a bf16 input -------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_bf16_matches_flax(rng, train):
    C = 16
    x = as_bf16(rng.standard_normal((4, 5, 6, C)) * 2 + 0.5)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.uniform(-0.3, 0.3, C).astype(np.float32)
    mean = rng.standard_normal(C).astype(np.float32) * 0.2
    var = rng.uniform(0.5, 2.0, C).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                       epsilon=1e-5, dtype=BF)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    want, upd = bn.apply(variables, jnp.asarray(x, BF),
                         mutable=["batch_stats"])
    assert want.dtype == BF
    port = BatchNorm(C)
    with torch.no_grad():
        for t, v in ((port.weight, scale), (port.bias, bias),
                     (port.running_mean, mean), (port.running_var, var)):
            t.copy_(T(v))
    port.train(train)
    xt = T(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    got = port(xt)
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 1).detach().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert np.all(np.abs(got - want) <= bf16_ulp(want))
    if train:
        np.testing.assert_allclose(port.running_mean.numpy(),
                                   upd["batch_stats"]["mean"], atol=1e-6)
        np.testing.assert_allclose(port.running_var.numpy(),
                                   upd["batch_stats"]["var"], atol=1e-6)
        # the backward keeps fp32 parameter gradients
        port(xt).float().sum().backward()
        assert port.weight.grad.dtype == torch.float32


# -- GeM-R50 at bf16 ----------------------------------------------------------

def _fill_variables(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(path, a):
        v = rng.standard_normal(a.shape)
        name = path[-1].key
        if name == "var":
            v = np.abs(v) + 0.5
        elif name == "scale":
            v = 1.0 + 0.1 * v
        elif len(a.shape) > 1:
            v = v / np.sqrt(np.prod(a.shape[:-1]))
        else:
            v = 0.1 * v
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


@pytest.fixture(scope="module")
def bf16_gem():
    """(JAX bf16 gem_r50, seeded numpy variables, the port's bf16 gem_r50
    loaded from them), 64-d descriptors, 8 classes."""
    kw = dict(num_classes=8, outputdim=64)
    jm = jax_get_model("gem_r50", dtype=BF, **kw)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        labels=jnp.zeros((1,), jnp.int32), train=False))
    variables = _fill_variables(shapes, 0)
    port = get_model("gem_r50", dtype="bfloat16", **kw)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return jm, variables, port.eval()


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def test_gem_bf16_train_forward_matches_jax(bf16_gem):
    jm, variables, port = bf16_gem
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 64, 64, 3)).astype(np.float32)
    y = np.arange(8) % 8

    @jax.jit
    def jtrain(x):
        (loss, logits), _ = jm.apply(variables, x, labels=jnp.asarray(y),
                                     train=True, mutable=["batch_stats"])
        return loss, logits

    jl, jlog = map(np.asarray, jtrain(jnp.asarray(x)))
    floors = [tuple(map(np.asarray, jtrain(jnp.asarray(b))))
              for b in bumps(x)]
    loss_floor = max(_rel(b[0], jl) for b in floors)
    logit_floor = max(np.abs(b[1] - jlog).max() for b in floors)
    model = copy.deepcopy(port).train()
    loss, logits = model(T(x), T(y))
    assert loss.dtype == torch.float32 and logits.dtype == torch.float32
    assert _rel(loss.detach(), jl) <= 3 * loss_floor, (loss_floor,)
    assert np.abs(logits.detach().numpy() - jlog).max() <= 3 * logit_floor
    # the backbone computed in bf16 and its map is bf16
    assert model.backbone(T(x[:1])).dtype == torch.bfloat16


def test_gem_bf16_extract_matches_jax(bf16_gem, monkeypatch):
    """Masked bucket against the JAX bf16 extract at 3x its one-ulp
    floor; the 12 identity blocks take the bottleneck's bf16 form."""
    jm, variables, port = bf16_gem
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    ext = np.array([[64, 64], [45, 37]], np.int32)
    x[1, 45:] = 0.0
    x[1, :, 37:] = 0.0
    jext = jax.jit(lambda x: jm.apply(variables, x, jnp.asarray(ext),
                                      method="extract"))
    want = np.asarray(jext(jnp.asarray(x)))
    floor = max(np.abs(np.asarray(jext(jnp.asarray(b))) - want).max()
                for b in bumps(x))
    dtypes = []
    real = tbackbone.fused_bottleneck

    def counted(xh, *a, **k):
        dtypes.append(xh.dtype)
        return real(xh, *a, **k)

    monkeypatch.setattr(tbackbone, "fused_bottleneck", counted)
    with torch.no_grad():
        got = port.extract(T(x), T(ext)).numpy()
    assert dtypes == [torch.bfloat16] * 12
    assert np.abs(got - want).max() <= 3 * floor, floor
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-6)


def _uint8_batch(B=8, px=64, classes=8, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (B, px, px, 3), dtype=np.uint8),
            rng.integers(0, classes, B))


def test_gem_bf16_sgd_step_matches_jax():
    """One SGD step of a bf16 gem_r50 (resnet18 backbone, 64 px, batch 8)
    from one JAX init, against JAX's step.  What the step moved
    (parameters minus the init, every leaf but the BN statistics) is
    compared as one vector: relative L2 of the port's update against
    JAX's, within 1.5x JAX's own deviation when its input moves by one
    bf16 ulp.  That floor is ~0.29 (train-mode BN at init turns the
    2^-8 input move into a different update direction; per leaf it
    reaches ~0.7 of a leaf's largest change, so no per-leaf bar can hold
    at bf16); a skipped update is off by 1.0.  Parameters stay fp32."""
    kw = dict(backbone_name="resnet18", outputdim=16, num_classes=8)
    jm = jax_get_model("gem_r50", dtype=BF, **kw)
    x, y = _uint8_batch()
    xf = np.asarray(jloop.fused_input_norm(NORM)(jnp.asarray(x)))
    jtx = jopt.make_sgd_optimizer(5e-3, weight_decay=1e-4, clip_max_norm=1.0)
    # jitted, on a small sample (the params' shapes do not depend on it):
    # flax's eager init of a bf16 model takes ~17 s here
    jinit = jax.jit(lambda: jloop.create_train_state(
        jm, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1,), jnp.int32), jtx))()
    jstep = jloop.make_train_step(jm, jtx, donate=False)

    def flat(state):
        sd = from_jax_variables({"params": state.params,
                                 "batch_stats": state.batch_stats})
        return {k: v.numpy().astype(np.float64) for k, v in sd.items()}

    init = flat(jinit)
    jstate, jmet = jstep(jinit, jnp.asarray(xf), jnp.asarray(y))
    want = flat(jstate)
    bumped = [jstep(jinit, jnp.asarray(b), jnp.asarray(y)) for b in bumps(xf)]
    tstate = create_train_state(get_model("gem_r50", dtype="bfloat16", **kw),
                                0, make_sgd_optimizer(
                                    5e-3, weight_decay=1e-4,
                                    clip_max_norm=1.0), device="cpu")
    tstate.model.load_state_dict(from_jax_variables(
        {"params": jinit.params, "batch_stats": jinit.batch_stats}))
    tstate, tmet = make_train_step(NORM)(tstate, x, y)
    port = {k: v.detach().numpy().astype(np.float64)
            for k, v in tstate.model.state_dict().items()}
    keys = [k for k in init if "running" not in k]

    def dev(state):
        d = np.concatenate([(state[k] - want[k]).ravel() for k in keys])
        w = np.concatenate([(want[k] - init[k]).ravel() for k in keys])
        return np.linalg.norm(d) / np.linalg.norm(w)

    floor = max(dev(flat(b)) for b, _ in bumped)
    assert 1.5 * floor < 0.75, floor
    assert dev(port) <= 1.5 * floor, (dev(port), floor)
    assert dev(init) == pytest.approx(1.0)  # what a skipped update gives
    loss_floor = max(_rel(m["loss"], jmet["loss"]) for _, m in bumped)
    assert _rel(tmet["loss"], jmet["loss"]) <= 3 * loss_floor
    assert all(v.dtype == torch.float32
               for v in tstate.model.state_dict().values()
               if v.is_floating_point())


# -- the driver's compute dtype ----------------------------------------------

def test_driver_compute_dtype(capsys):
    from research_image_retrieval_tpu_torch.models.registry import (
        MODEL_REGISTRY,
        register_model,
    )
    from research_image_retrieval_tpu_torch.train import driver as drv
    from research_image_retrieval_tpu_torch.utils.config import get_preset

    cfg = get_preset("gem_r50", compute_dtype="bfloat16",
                     model_overrides=dict(backbone_name="resnet18"))
    assert drv.model_kwargs(cfg)["dtype"] == "bfloat16"
    model = get_model(cfg.model, num_classes=4, **drv.model_kwargs(cfg))
    assert model.backbone.dtype == torch.bfloat16
    cfg.model_overrides["dtype"] = "float32"  # an explicit override wins
    assert drv.model_kwargs(cfg)["dtype"] == "float32"
    assert "dtype" not in drv.model_kwargs(get_preset("gem_r50"))

    register_model("no_dtype_knob")(lambda num_classes=1: None)
    try:
        cfg = get_preset("gem_r50", compute_dtype="bfloat16")
        cfg.model = "no_dtype_knob"
        assert "dtype" not in drv.model_kwargs(cfg)
        assert "has no compute-dtype knob" in capsys.readouterr().out
    finally:
        del MODEL_REGISTRY["no_dtype_knob"]
