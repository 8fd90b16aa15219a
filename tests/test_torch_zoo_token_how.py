"""PyTorch port, the zoo's Token (with RetrievalNet's ArcFace-DELG
state) and HOW (VLAD / ASMK) families on the CPU against the JAX
package, on the same seeded numpy variables converted by
``from_jax_variables`` (resnet18, 64 px, Token ``outputdim`` 64 with 8
heads, HOW ``local_dim`` 16 with K = 8):

* each family's ``extract``, unmasked and on a bucket with per-image
  extents, to 1e-4 on the L2 descriptors;
* ``vlad_aggregate`` / ``asmk_aggregate`` against JAX's with and
  without a token mask, and at N = 1, to 1e-5 (ASMK's assignments and
  keep bits equal);
* one SGD step of each family against JAX ``make_train_step`` (float64
  on both sides, Token and RetrievalNet at dropout 0: the port's
  dropout cannot draw flax's bits), with RetrievalNet's ``arcface_t``
  after two steps equal to JAX's ``model_state``; ``cli.train
  --resume`` of RetrievalNet equal to the straight run, ``arcface_t``
  included;
* the registry (Table-1 names, ``get_model_info``) and the presets
  against JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from research_image_retrieval_tpu import models as jmodels
from research_image_retrieval_tpu.models import how as jhow
from research_image_retrieval_tpu.models import token as jtoken
from research_image_retrieval_tpu.train import loop as jloop
from research_image_retrieval_tpu.train import optimizer as jopt
from research_image_retrieval_tpu.train.schedule import (
    warmup_cosine_schedule as jax_schedule,
)
from research_image_retrieval_tpu.utils import config as jconfig
from research_image_retrieval_tpu_torch import models as tmodels
from research_image_retrieval_tpu_torch.data import IMAGENET_MEAN, IMAGENET_STD
from research_image_retrieval_tpu_torch.models import (
    from_jax_variables,
    get_model,
    layers as tlayers,
    seeded_init,
    training_init,
)
from research_image_retrieval_tpu_torch.models import how as thow
from research_image_retrieval_tpu_torch.train import (
    TrainState,
    make_sgd_optimizer,
    make_train_step,
    warmup_cosine_schedule,
)
from research_image_retrieval_tpu_torch.utils import config as tconfig
from test_torch_bf16 import _fill_variables
from test_torch_model import few_torch_threads  # noqa: F401
from test_torch_train import _as_port, _change_devs, _leaf_devs, _rel

T = torch.from_numpy
NEW = ("token_r50", "retrievalnet_r101", "how_vlad_r50", "how_asmk_r50")
PX = 64
EXTENTS = [[64, 30], [30, 48]]
NORM = (IMAGENET_MEAN, IMAGENET_STD)
SCHED = (0, 5e-3, 3, 5e-3, 5e-4, 2)


def overrides(name, **kw):
    """Small configurations: resnet18, 8 classes, narrow heads."""
    base = dict(backbone_name="resnet18", num_classes=8)
    if name.startswith("how"):
        base.update(local_dim=16, num_clusters=8, outputdim=32)
    else:
        base.update(outputdim=64)
    return {**base, **kw}


@functools.cache
def jax_model(name):
    """(JAX model, seeded variables: ``_fill_variables`` with RetrievalNet's
    ``arcface_t`` at its init value 0)."""
    jm = jmodels.get_model(name, **overrides(name))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, PX, PX, 3)),
        labels=jnp.zeros((1,), jnp.int32), train=False))
    v = _fill_variables(shapes, 0)
    if "model_state" in v:
        v["model_state"] = {"arcface_t": np.zeros(1, np.float32)}
    return jm, v


def port_model(name, variables, **kw):
    port = get_model(name, **overrides(name, **kw))
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return port


def bucket(seed=1):
    """(images [2, 64, 64, 3] zero outside each extent, extents)."""
    ext = np.array(EXTENTS, np.int32)
    x = np.random.default_rng(seed).standard_normal(
        (len(ext), PX, PX, 3)).astype(np.float32)
    for i, (h, w) in enumerate(ext):
        x[i, h:] = 0.0
        x[i, :, w:] = 0.0
    return x, ext


# -- whole-model extraction ---------------------------------------------------

@pytest.mark.parametrize("name", NEW, ids=[n.split("_r")[0] for n in NEW])
def test_token_how_extract_matches_jax(name):
    jm, variables = jax_model(name)
    port = port_model(name, variables).eval()
    x, ext = bucket()

    @jax.jit
    def jext(x, e):
        return (jm.apply(variables, x, method="extract"),
                jm.apply(variables, x, e, method="extract"))

    want = [np.asarray(w) for w in jext(jnp.asarray(x), jnp.asarray(ext))]
    with torch.no_grad():
        got = [port.extract(T(x)).numpy(), port.extract(T(x), T(ext)).numpy()]
    for g, w, what in zip(got, want, ("extract", "masked")):
        assert np.isfinite(w).all()
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=what)
    assert np.abs(got[1] - got[0]).max() > 1e-3  # the masks mattered


# -- the aggregations ----------------------------------------------------------

def _tokens(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, n, 16)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    c = rng.uniform(0, 1, (8, 16)).astype(np.float32)
    w = (1.0 + 0.3 * rng.standard_normal(8)).astype(np.float32)
    mask = np.ones((3, n), np.float32)
    mask[1, n // 2:] = 0.0
    mask[2, 1:] = 0.0
    return x, c, w, mask


@pytest.mark.parametrize("kind", ["vlad", "asmk"])
@pytest.mark.parametrize("n, masked", [(40, False), (40, True), (1, False),
                                       (1, True)])
def test_aggregate_matches_jax(kind, n, masked):
    """``vlad_aggregate`` / ``asmk_aggregate`` of 3 images' unit tokens
    over 8 centroids drawn as flax draws them (U[0, 1)); the mask keeps
    every token of image 0, half of image 1 and one of image 2.  At one
    token ASMK's threshold (mean + 0) equals its distance and the strict
    test keeps nothing, in JAX's code as here (its comment says the
    degenerate case keeps everything)."""
    x, c, w, mask = _tokens(n, seed=n)
    m = mask if masked else None
    if kind == "vlad":
        want = jax.jit(jhow.vlad_aggregate, static_argnums=2)(
            x, c, 100.0, m)
        got = thow.vlad_aggregate(T(x), T(c), 100.0,
                                  None if m is None else T(m))
    else:
        want = jax.jit(jhow.asmk_aggregate)(x, c, w, m)
        got = thow.asmk_aggregate(T(x), T(c), T(w),
                                  None if m is None else T(m))
        # the selection itself, against JAX's argmin and threshold
        d = np.sqrt(np.maximum((x ** 2).sum(-1)[..., None] - 2 * x @ c.T
                               + (c ** 2).sum(-1), 1e-12))
        nearest, keep, _, thresh = thow.asmk_select(
            T(x), T(c), None if m is None else T(m))
        np.testing.assert_array_equal(nearest.numpy(), d.argmin(-1))
        if n > 1:
            assert 0 < keep.sum() < keep.numel()
        else:  # the threshold is the one distance: strict < keeps none
            assert keep.sum() == 0 and not got.any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    if masked:  # pad tokens change nothing
        x2 = x.copy()
        x2[mask == 0] = np.roll(x, 1, axis=1)[mask == 0]
        fn = thow.vlad_aggregate if kind == "vlad" else (
            lambda a, b, _, mm: thow.asmk_aggregate(a, b, T(w), mm))
        again = fn(T(x2), T(c), 100.0, T(m))
        np.testing.assert_allclose(again.numpy(), got.numpy(), atol=1e-6,
                                   rtol=0)


# -- train steps and RetrievalNet's EMA state ----------------------------------

def _no_dropout(monkeypatch):
    """JAX's ``TokenRefine`` built at dropout 0 (``TokenModel`` has no
    field for its rates)."""
    monkeypatch.setattr(jtoken, "TokenRefine", functools.partial(
        jtoken.TokenRefine, drop=0.0, attn_drop=0.0, drop_path=0.0))


def _zero_port_dropout(model):
    for mod in model.modules():
        if isinstance(mod, tlayers.Attention):
            mod.attn_drop = mod.proj_drop = 0.0
        elif isinstance(mod, tlayers.DropPath):
            mod.rate = 0.0
        elif isinstance(mod, tlayers.Mlp):
            mod.drop = 0.0
    return model


def _sgd():
    return make_sgd_optimizer(warmup_cosine_schedule(*SCHED),
                              weight_decay=1e-4, clip_max_norm=1.0)


def _as_port_state(state, start, init):
    change = jax.tree_util.tree_map(
        lambda a, b: np.asarray(a, np.float64) - np.asarray(b, np.float64),
        state.params, start["params"])
    out = _as_port(change, state.batch_stats)
    return {k: a if "running" in k else init[k] + a for k, a in out.items()}


@pytest.mark.parametrize("name", NEW, ids=[n.split("_r")[0] for n in NEW])
def test_train_step_matches_jax(name, monkeypatch):
    """One step (RetrievalNet: two) of JAX ``make_train_step`` and of the
    port's from the same seeded state, both in float64 (JAX under
    ``jax.enable_x64``; in float32 a train-mode BN net this small flips
    ReLUs on rounding changes, ``tests/test_torch_zoo_more_train.py``):
    the loss to 1e-7 relative, each leaf's change to 1e-4 of its largest
    change, the BN statistics to 1e-6 of each leaf's largest magnitude.
    JAX computes its heads' einsums with float32 products, so the
    float64 sides agree to float32 roundings there.  RetrievalNet's
    ``arcface_t`` starts at 0, moves on each step, and equals JAX's
    ``model_state`` after each of two steps to 1e-6 relative."""
    if name.startswith(("token", "retrieval")):
        _no_dropout(monkeypatch)
    _, variables = jax_model(name)
    rng = np.random.default_rng(8)
    x = rng.integers(0, 256, (2, PX, PX, 3), dtype=np.uint8)
    y = np.array([3, 5])
    xf = (x / 255.0 - np.asarray(NORM[0])) / np.asarray(NORM[1])
    two = name == "retrievalnet_r101"
    with jax.enable_x64(True):
        jm = jmodels.get_model(name, **overrides(name, dtype=jnp.float64))
        v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                   variables)
        jtx = jopt.make_sgd_optimizer(jax_schedule(*SCHED),
                                      weight_decay=1e-4, clip_max_norm=1.0)
        jstate = jloop.TrainState(
            step=jnp.zeros((), jnp.int32), params=v["params"],
            batch_stats=v["batch_stats"],
            opt_state=jax.jit(jtx.init)(v["params"]),
            rng=jax.random.PRNGKey(1), model_state=v.get("model_state", {}))
        jstep = jloop.make_train_step(jm, jtx, donate=False)
        ref, jmet = jstep(jstate, jnp.asarray(xf), jnp.asarray(y))
        jts = [float(np.asarray(ref.model_state["arcface_t"])[0])] \
            if two else []
        if two:
            ref2, _ = jstep(ref, jnp.asarray(xf[::-1].copy()),
                            jnp.asarray(y[::-1].copy()))
            jts.append(float(np.asarray(ref2.model_state["arcface_t"])[0]))
    model = _zero_port_dropout(port_model(name, variables)).double()
    tstate = TrainState(0, model, _sgd().init(model), torch.Generator())
    step = make_train_step(None)
    tstate, tmet = step(tstate, T(xf), y)
    assert np.isfinite(float(jmet["loss"]))
    assert _rel(tmet["loss"], jmet["loss"]) <= 1e-7
    init = _as_port(variables["params"], variables.get("batch_stats", {}))
    want = _as_port_state(ref, v, init)
    port = {k: t.detach().numpy() for k, t in
            tstate.model.state_dict().items()}
    devs = _change_devs(port, want, init)
    worst = max(devs, key=devs.get)
    assert devs[worst] <= 1e-4, (worst, devs[worst])
    stats = {k: d for k, d in _leaf_devs(port, want).items()
             if "running" in k}
    assert max(stats.values()) <= 1e-6, max(stats, key=stats.get)
    if two:
        t1 = float(tstate.model.arcface_t[0])
        tstate, _ = step(tstate, T(xf[::-1].copy()), y[::-1].copy())
        t2 = float(tstate.model.arcface_t[0])
        assert 0.0 != t1 != t2
        np.testing.assert_allclose([t1, t2], jts, rtol=1e-6, atol=0)


def test_arcface_t_moves_only_in_the_train_step():
    """Init (``seeded_init``, ``training_init``), eval forwards and
    extraction leave ``arcface_t`` at 0; a plain Token has no such
    buffer."""
    model = get_model("retrievalnet_r101", **overrides("retrievalnet_r101"))
    seeded_init(model, seed=0)
    training_init(model, torch.Generator().manual_seed(0))
    assert "arcface_t" in dict(model.named_buffers())
    x = torch.zeros(2, PX, PX, 3)
    model.eval()
    with torch.no_grad():
        assert len(model(x, torch.tensor([1, 2]), train=False)) == 2
        model.extract(x)
    assert float(model.arcface_t[0]) == 0.0
    token = get_model("token_r50", **overrides("token_r50"))
    assert "arcface_t" not in dict(token.named_buffers())


def test_cli_train_resume_keeps_arcface_t(tmp_path, monkeypatch):
    """``cli.train`` of a small RetrievalNet (a preset added for the
    test: resnet18, 64-d, 2 classes x 4 images, so one epoch is two
    steps of 4): the straight epoch, then a run stopped by the
    preemption guard after its first step and continued by ``--resume
    latest``.  The final checkpoints are equal, ``arcface_t`` (which
    moved on each step) included."""
    from research_image_retrieval_tpu_torch.cli import train as cli_train
    from research_image_retrieval_tpu_torch.train import driver as drv
    from research_image_retrieval_tpu_torch.train.preemption import (
        PreemptionGuard,
    )

    monkeypatch.setitem(tconfig.PRESETS, "retrievalnet_small", dict(
        model="retrievalnet_r101", optimizer="sgd", base_lr=0.01,
        synthetic_classes=2, synthetic_samples=4, synthetic_val_samples=2,
        model_overrides=dict(backbone_name="resnet18", outputdim=64)))

    def run(directory, *extra):
        assert cli_train.main([
            "--preset", "retrievalnet_small", "--device", "cpu", "--imsize",
            "32", "--batch-size", "4", "--num-epochs", "1", "--num-workers",
            "0", "--directory", str(directory), *extra]) == 0
        return torch.load(directory / "epoch_00001.pt",
                          weights_only=True)["model"]

    class StopAfterOne(PreemptionGuard):
        def __init__(self):
            super().__init__(signals=())

        @property
        def should_stop(self):
            return True

    a = run(tmp_path / "a")
    monkeypatch.setattr(drv, "PreemptionGuard", StopAfterOne)
    t1 = float(run(tmp_path / "b")["arcface_t"][0])
    monkeypatch.setattr(drv, "PreemptionGuard", PreemptionGuard)
    b = run(tmp_path / "b", "--resume", "latest")
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert 0.0 != t1 != float(a["arcface_t"][0])


# -- registry and presets -----------------------------------------------------

def test_token_how_registry_and_presets():
    for name in NEW:
        assert tmodels.get_model_info(name) == jmodels.get_model_info(name)
    for t1, cls in (("R101-Token", tmodels.TokenModel),
                    ("R50-Token", tmodels.TokenModel),
                    ("R50-HOW-VLAD", tmodels.HOWModel),
                    ("R50-HOW-ASMK", tmodels.HOWModel)):
        name = jmodels.registry.TABLE1_TO_MODEL_MAPPING[t1]
        assert tmodels.TABLE1_TO_MODEL_MAPPING[t1] == name
        assert tmodels.get_model_info(t1)["name"] == name
        assert tmodels.MODEL_REGISTRY[name].builder is cls
    for preset in ("token_r101", "how_vlad_r50", "how_asmk_r50"):
        assert tconfig.PRESETS[preset] == jconfig.PRESETS[preset], preset
        got, want = tconfig.get_preset(preset), jconfig.get_preset(preset)
        for f in ("model", "model_overrides", "optimizer", "base_lr",
                  "num_epochs"):
            assert getattr(got, f) == getattr(want, f), (preset, f)
    with pytest.raises(ValueError, match="pooling"):
        thow.HOWModel(backbone_name="resnet18", pooling_type="gem")
